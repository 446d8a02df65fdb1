"""Checkpoint converter: HF safetensors -> a servable artifact (port of
``mxmoe_tpu/models/convert.py``).

  python -m mxmoe_tpu_torch.models.convert --ckpt <hf_dir> --model qwen2_moe \\
      --out <artifact_dir> [--quant w8a8_g-1_sym [--pack-int4]]
      [--qconfig mix.json [--method rtn|gptq|gptq-had] [--no-pack-w4]
       [--calib-nsamples 8 --calib-seqlen 512]] [--layers N] [--device cuda]

The checkpoint is loaded into host memory (``hf_loader``); the quantizers
move one layer (or one slice of experts) at a time to ``--device`` (the card
by default), so a full-depth model stays on the host beside one layer of
device work. ``--quant`` quantizes the routed experts uniformly (RTN), with
``--pack-int4`` nibble-packed; ``--qconfig`` takes a solved per-expert mix
(a ``QModelConfig`` JSON), quantized by RTN or GPTQ (``gptq-had``: after the
norm fusion and Hadamard rotation), the w <= 4 experts nibble-packed into
the ragged buffer unless ``--no-pack-w4``.

The artifact: the params as safetensors shards (``utils.safetensors_io``;
nested keys joined with ``.``, e.g. ``layers.expert_gate_up_q``, every tensor
bit for bit in its dtype) with ``model.safetensors.index.json``, and
``mxmoe_meta.json`` with the reference's keys (``model``, ``dtype``,
``quant``, ``pack_int4``, ``qconfig``, ``pack_w4``, ``layers``, and
``method`` with a qconfig). ``dtype`` is the torch name of the float dtype
(``torch.bfloat16``), where the reference writes the jax one. The reference
writes an orbax checkpoint, which needs jax; the two artifacts hold the same
tensors under the same names.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os

import torch

META_NAME = "mxmoe_meta.json"
_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "tokenizer.model")


def pack_int4_experts(params: dict, qcfg, device=None) -> dict:
    """``expert_*_q`` [L, E, K, N] -> ``expert_*_q_packed`` [L, E, K/2, N]
    (the ``--pack-int4`` step) for params quantized uniformly with ``qcfg``
    (``w_bits <= 4``): half the bytes, served by ``ops.gmm_w4a8_packed``
    (w x a) or ``ops.gmm_weight_only_packed`` (a16).

    The packed w x a kernel assumes symmetric per-channel scales and never
    reads ``_zp``, so a quantized-activation scheme must be ``w_sym`` with
    ``g = -1``. The packed weight-only kernel dequantizes with scale and zp
    per group, so any a16 scheme of at most 4 bits may pack. One layer's
    int32 working set at a time, on ``device`` (default: the codes')."""
    from ..quant.packing import pack_int4_halves

    if qcfg.w_bits > 4:
        raise ValueError(f"pack_int4_experts needs w_bits <= 4, got {qcfg.scheme_name}")
    if qcfg.a_bits < 16 and not (qcfg.w_sym and qcfg.w_gsize == -1):
        raise ValueError(
            "packing a quantized-activation scheme requires symmetric "
            f"per-channel weights (w_sym, g=-1); got {qcfg.scheme_name}")
    layers = dict(params["layers"])
    for name in ("expert_gate_up_q", "expert_down_q"):
        q = layers.pop(name)                          # [L, E, K, N]
        work = torch.device(device) if device is not None else q.device
        nl, e, k, n = q.shape
        packed = torch.empty((nl, e, k // 2, n), dtype=torch.int8, device=q.device)
        for l in range(nl):
            packed[l] = pack_int4_halves(q[l].to(work))
        layers[name + "_packed"] = packed
    return {**params, "layers": layers}


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if "." in k:
            raise ValueError(f"param name {k!r} holds the key separator '.'")
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def save_params(params: dict, out_dir: str) -> int:
    """Write ``params`` (nested dict of tensors) into ``out_dir`` as
    safetensors shards; returns the bytes written."""
    from ..utils.safetensors_io import save_sharded

    return save_sharded(_flatten(params), out_dir, prefix="params")


def load_params(out_dir: str, device="cuda") -> dict:
    """An artifact's params, nested as they were saved, on ``device`` (the
    card unless the caller asks for ``"cpu"``)."""
    from ..utils.safetensors_io import ShardedDir

    flat = ShardedDir(out_dir)
    out: dict = {}
    for key in flat:
        node = out
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = flat[key].to(device)
    return out


def load_meta(out_dir: str) -> dict:
    path = os.path.join(out_dir, META_NAME)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _tokenizer(ckpt_dir: str):
    """The checkpoint directory's own tokenizer, read locally, or None."""
    if not any(os.path.exists(os.path.join(ckpt_dir, f)) for f in _TOKENIZER_FILES):
        return None
    if importlib.util.find_spec("transformers") is None:
        return None
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(ckpt_dir, local_files_only=True)


def convert(ckpt_dir: str, model_id: str, out_dir: str, quant: str | None = None,
            pack_int4: bool = False, dtype=torch.bfloat16, layers: int | None = None,
            qconfig: str | None = None, pack_w4: bool = True, method: str = "rtn",
            calib_nsamples: int = 8, calib_seqlen: int = 512, device="cuda",
            stats: dict | None = None) -> dict:
    """Convert the HF checkpoint in ``ckpt_dir`` into an artifact in
    ``out_dir``; returns the params as written (on the host).

    ``device`` runs the quantization (the card unless the caller asks for
    ``"cpu"``). gptq-had rotates by ``random_hadamard_matrix(H)`` from a
    generator seeded 0. ``stats``, when given, receives the GPTQ timings and
    proxy losses (``quantizer.quantize_model_experts_mixed_gptq``)."""
    from .configs import config_for
    from .hf_loader import params_from_safetensors

    cfg = config_for(model_id)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params = params_from_safetensors(ckpt_dir, cfg, dtype=dtype)

    meta = {"model": model_id, "dtype": str(dtype), "quant": quant,
            "pack_int4": bool(pack_int4), "qconfig": qconfig,
            "pack_w4": bool(pack_w4 and qconfig), "layers": cfg.num_layers}
    if method != "rtn" and not qconfig:
        raise ValueError(
            f"--method {method} only applies with --qconfig (uniform --quant "
            "uses RTN codes); pass a solved qconfig or drop --method")
    if qconfig:
        if quant is not None:
            raise ValueError("--qconfig and --quant are mutually exclusive")
        from ..quant.schemes import QModelConfig

        qmc = QModelConfig.load(qconfig)
        meta["method"] = method
        if method == "rtn":
            from ..quant.qparams import quantize_model_experts_mixed

            params = quantize_model_experts_mixed(params, cfg, qmc, pack_w4=pack_w4,
                                                  device=device)
        elif method in ("gptq", "gptq-had"):
            from ..quant.data import get_calibration_tokens
            from ..quant.quantizer import quantize_model_experts_mixed_gptq

            tok = _tokenizer(ckpt_dir)
            if tok is None:
                # GPTQ fitted to random-activation statistics can be worse
                # than RTN: never do it silently
                print("[convert] WARNING: no tokenizer found in the ckpt dir; "
                      "GPTQ calibration falls back to SYNTHETIC tokens. Provide "
                      "real calibration data (tokenizer in ckpt dir and "
                      "MXMOE_CALIB_TEXT) for the eval-row accuracy claim to hold.",
                      flush=True)
            toks = get_calibration_tokens(calib_nsamples, calib_seqlen, tokenizer=tok,
                                          vocab_size=cfg.vocab_size)
            params = quantize_model_experts_mixed_gptq(
                params, cfg, qmc, toks, pack_w4=pack_w4,
                hadamard=method.endswith("-had"), device=device, stats=stats)
        else:
            raise ValueError(f"--method {method!r}: rtn | gptq | gptq-had")
    elif quant:
        from ..quant.qparams import quantize_model_experts_uniform
        from ..quant.schemes import parse_scheme

        qcfg = parse_scheme(quant)
        if pack_int4 and qcfg.w_bits <= 4 and qcfg.a_bits < 16 and not (
                qcfg.w_sym and qcfg.w_gsize == -1):
            # the packed w x a kernel assumes symmetric per-channel scales and
            # never reads _zp: packing another w x a scheme would serve wrong
            # outputs. Weight-only schemes pack with any grouping.
            raise ValueError(
                "--pack-int4 with a quantized-activation scheme requires "
                f"symmetric per-channel weights (w_sym, g=-1); got {quant}. "
                "Convert without --pack-int4 to serve it unpacked.")
        params = quantize_model_experts_uniform(params, qcfg, device=device)
        if pack_int4 and qcfg.w_bits <= 4:
            params = pack_int4_experts(params, qcfg, device=device)

    os.makedirs(out_dir, exist_ok=True)
    nbytes = save_params(params, out_dir)
    meta["bytes"] = nbytes
    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump(meta, f)
    return params


def _main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--model", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--quant", default=None)
    ap.add_argument("--pack-int4", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--qconfig", default=None,
                    help="solved mixed qconfig JSON: per-expert real quant, w<=4 "
                         "experts nibble-packed")
    ap.add_argument("--no-pack-w4", action="store_true",
                    help="with --qconfig: keep int8-stored codes (no ragged "
                         "packed buffer)")
    ap.add_argument("--method", default="rtn", choices=["rtn", "gptq", "gptq-had"],
                    help="with --qconfig: the code optimizer (gptq runs the "
                         "layer-streamed Hessian sweep on calibration data)")
    ap.add_argument("--calib-nsamples", type=int, default=8)
    ap.add_argument("--calib-seqlen", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="cpu | cuda | cuda:N: where the quantization runs")
    args = ap.parse_args(argv)
    convert(args.ckpt, args.model, args.out, args.quant, args.pack_int4,
            layers=args.layers, qconfig=args.qconfig,
            pack_w4=not args.no_pack_w4, method=args.method,
            calib_nsamples=args.calib_nsamples, calib_seqlen=args.calib_seqlen,
            device=args.device)
    print(f"converted -> {args.out}")


if __name__ == "__main__":
    _main()
