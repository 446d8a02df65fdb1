"""Generation CLI: drive the serving engine end to end (port of
``mxmoe_tpu/serving/generate.py``).

  python -m mxmoe_tpu_torch.serving.generate --model tiny --prompt "1 2 3" --max-new 8
  python -m mxmoe_tpu_torch.serving.generate --model qwen2_moe \\
      --quant w8a8_g-1_sym --max-new 64
  python -m mxmoe_tpu_torch.serving.generate --model ds2 --layers 4 \\
      --quant mixed-packed --decode-attn xla
  python -m mxmoe_tpu_torch.serving.generate --model qwen2_moe --ckpt <hf_dir>
  python -m mxmoe_tpu_torch.serving.generate --model qwen2_moe --artifact <dir>
  python -m mxmoe_tpu_torch.serving.generate --model tiny --mesh 2 --device cpu

The weights: seeded random (default), an HF checkpoint (``--ckpt``: float
params, quantized with ``--quant`` when it is given) or a converted artifact
(``--artifact``, ``models.convert``: its depth and its serving mode come from
the artifact: a per-expert mix when it carries ``act_bits_gateup`` beside
quantized experts, else ``mxmoe_meta.json``'s uniform ``quant``, else
float). ``--prompt-text`` / ``--tokenizer`` need a tokenizer and are not
ported.

``--mesh N`` serves over N ranks (the mesh ``Engine``: experts sharded, the
KV cache sharded over slots, the EP all-to-all in every cached step), one
process a rank: launched under ``torchrun`` the ranks join from the
environment, else the command spawns N processes on this host. Rank r uses
``cuda:r`` over NCCL (``--transport direct``, the default), the CPU over gloo
with ``--device cpu``, or ``cuda:(r mod #cards)`` with every exchange staged
through host buffers over gloo (``--transport host``: two ranks on one card,
which NCCL refuses). On the direct transport the mesh Engine replays CUDA
graphs of its steps and chunks (their NCCL exchanges inside), as on one
device; the host-staged one serves eagerly (``cuda_graphs=False``: no graph
holds its host copies). Every rank draws the same seeded weights and keeps
its slices; rank 0 prints. ``--capacity-factor`` sets the EP capacity
headroom, ``--gate-trace`` derives it from a gate trace (the worst layer's
``capacity_factor_from_freq``, at least 2).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time

from .bench_serving import DECODE_ATTN


def _to(params: dict, device) -> dict:
    return {k: (_to(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in params.items()}


def load_artifact(path: str, cfg, device, decode_attn: str = "auto"):
    """A converted artifact on ``device`` -> (params, config, MoEImpl). The
    depth is the artifact's (a wrong-depth KV cache would be written past its
    layers); the serving mode follows its keys and ``mxmoe_meta.json``: a
    per-expert mix (weight-only experts, act bits 16, through K10) when the
    layers carry ``act_bits_gateup`` beside quantized experts, else the
    uniform ``quant`` of the meta, else float."""
    from ..models.convert import load_meta, load_params
    from ..models.layers import MoEImpl
    from ..quant.schemes import parse_scheme

    params = load_params(path, device)
    meta = load_meta(path)
    lp = params["layers"]
    depth = int(lp["router"].shape[0]) + (
        int(params["dense_layers"]["input_norm"].shape[0])
        if "dense_layers" in params else 0)
    if cfg.num_layers != depth:
        cfg = dataclasses.replace(cfg, num_layers=depth)
    if "act_bits_gateup" in lp and ("expert_gate_up_q" in lp
                                    or "expert_gate_up_qcat" in lp):
        impl = MoEImpl(quant="mixed", decode_attn=decode_attn,
                       mixed_weight_only=bool((lp["act_bits_gateup"] >= 16).any()
                                              or (lp["act_bits_down"] >= 16).any()))
    elif meta.get("quant"):
        qc = parse_scheme(meta["quant"])
        if qc.a_bits < 16 and not qc.a_sym:
            # activations are symmetric on every real-quantized path
            qc = dataclasses.replace(qc, a_sym=True)
        impl = MoEImpl(quant=qc, decode_attn=decode_attn)
    else:
        impl = MoEImpl(decode_attn=decode_attn)
    return params, cfg, impl


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tiny",
                    help="tiny | tiny_ds2 | qwen2_moe | ds2 | qwen2_moe_57b | "
                         "mixtral")
    ap.add_argument("--ckpt", default=None, help="HF safetensors dir")
    ap.add_argument("--artifact", default=None,
                    help="converted artifact dir (models.convert): weights and "
                         "serving mode from the artifact and mxmoe_meta.json")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--quant", default=None,
                    help="what bench_serving --quant takes: a uniform expert "
                         "scheme, e.g. w8a8_g-1_sym or w4a16_g128_asym, or "
                         "mixed | mixed-packed | none (bf16 experts); default "
                         "w8a8_g-1_sym for random weights, float for --ckpt")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--decode-attn", default="auto", choices=DECODE_ATTN,
                    help="decode attention: the fused kernel or the plain "
                         "scatter + attention ('auto': fused)")
    ap.add_argument("--chunk", type=int, default=16,
                    help="decode tokens per host read (decode_scan)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt", default="1 2 3 4", help="space-separated token ids")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0, help="weights and sampling seed")
    ap.add_argument("--device", default=None,
                    help="cpu | cuda | cuda:N (default: cuda; cpu must be asked "
                         "for and runs the kernels' plain versions)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="serve over N ranks (expert parallelism; module docstring)")
    ap.add_argument("--transport", default="direct", choices=("direct", "host"),
                    help="the EP exchange: the group's backend on the tensors "
                         "(NCCL on cards, gloo on the CPU) or staged through host "
                         "buffers over gloo")
    ap.add_argument("--gate-trace", default=None,
                    help="moe-gate.json: derive the EP capacity factor from the "
                         "traced routing skew instead of --capacity-factor")
    ap.add_argument("--capacity-factor", type=float, default=8.0,
                    help="EP dispatch capacity headroom: assignments beyond it are "
                         "DROPPED (outputs then part from one device's)")
    args = ap.parse_args(argv)
    if args.mesh > 1 and "WORLD_SIZE" not in os.environ:
        import torch.distributed as dist

        if not dist.is_initialized():
            from ..parallel.multihost import spawn

            spawn(_serve_rank, args.mesh, (args,), backend=_backend(args))
            return None
    return _serve(args)


def _backend(args) -> str:
    return "nccl" if args.transport == "direct" and args.device != "cpu" else "gloo"


def _serve_rank(rank: int, args):
    _serve(args)


def _capacity_factor(args) -> float:
    if not args.gate_trace:
        return args.capacity_factor
    from ..parallel.ep import capacity_factor_from_freq

    with open(args.gate_trace) as f:
        trace = json.load(f)
    caps = [capacity_factor_from_freq(v["access_freq"], args.mesh)
            for k, v in trace.items() if k.startswith("layer-")]
    if not caps:
        raise SystemExit(f"no layer-* entries in {args.gate_trace}: pass "
                         "--capacity-factor instead")
    cap = max(max(caps), 2.0)
    print(f"capacity factor <- gate trace: {cap:.2f} (worst layer of {len(caps)})")
    return cap


def _serve(args):
    import torch

    from ..models import configs
    from .bench_serving import init_for_serving, quantize_for_serving
    from .engine import Engine, EngineConfig

    tiny = {"tiny": lambda: configs.tiny_qwen2_moe(num_experts=8, num_layers=2),
            "tiny_ds2": lambda: configs.tiny_ds2(num_experts=8, num_layers=3)}
    cfg = (tiny[args.model]() if args.model in tiny
           else configs.config_for(args.model))
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    device = torch.device(args.device or "cuda")
    mesh = ep_cfg = None
    rank = 0
    own_group = False
    if args.mesh:
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        from ..parallel.ep import EPConfig
        from ..parallel.multihost import free_port

        if not dist.is_initialized():
            own_group = True
            if "WORLD_SIZE" in os.environ:
                # a launcher's job (torchrun), one rank or more: its store
                dist.init_process_group(_backend(args), init_method="env://")
            else:
                # a job of one rank: its own group on localhost
                dist.init_process_group(_backend(args), world_size=1, rank=0,
                                        init_method=f"tcp://localhost:{free_port()}")
        if dist.get_world_size() != args.mesh:
            raise SystemExit(f"--mesh {args.mesh} in a job of "
                             f"{dist.get_world_size()} ranks")
        rank = dist.get_rank()
        if device.type == "cuda":
            n = torch.cuda.device_count()
            device = torch.device("cuda", rank if args.transport == "direct" else rank % n)
            torch.cuda.set_device(device)
        mesh = DeviceMesh("cpu" if _backend(args) == "gloo" else "cuda",
                          list(range(args.mesh)), mesh_dim_names=("expert",))
        ep_cfg = EPConfig(capacity_factor=_capacity_factor(args),
                          transport=args.transport)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.artifact:
        params, cfg, impl = load_artifact(args.artifact, cfg, device,
                                          args.decode_attn)
    elif args.ckpt:
        from ..models.hf_loader import params_from_safetensors

        params = params_from_safetensors(args.ckpt, cfg)
        params, impl = quantize_for_serving(params, cfg, args.quant or "none",
                                            decode_attn=args.decode_attn,
                                            device=device)
        params = _to(params, device)
    else:
        params, impl = init_for_serving(
            cfg, gen, functools.partial(quantize_for_serving,
                                        quant=args.quant or "w8a8_g-1_sym",
                                        decode_attn=args.decode_attn), device)
    eng = Engine(params, cfg, EngineConfig(
        batch_slots=args.slots, max_len=args.max_len,
        prefill_chunk=min(256, args.max_len // 2),
        temperature=args.temperature, seed=args.seed,
        cuda_graphs=not (args.mesh and args.transport == "host")), impl,
        mesh=mesh, ep_cfg=ep_cfg)
    prompt = [int(t) % cfg.vocab_size for t in args.prompt.split()]

    def _sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    rid = eng.submit(prompt, max_new_tokens=args.max_new)
    _sync()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = eng.run_to_completion(chunk=args.chunk)[rid]
    _sync()
    t_decode = time.perf_counter() - t0
    if rank == 0:
        where = (f"{args.mesh} ranks ({args.transport}), rank 0 on {device}"
                 if args.mesh else f"device {device}")
        print(f"prompt tokens : {prompt}")
        print(f"output tokens : {out}")
        print(f"{where}: prefill {t_prefill * 1e3:.1f} ms; decode {len(out)} tok in "
              f"{t_decode * 1e3:.1f} ms = {len(out) / max(t_decode, 1e-9):.1f} tok/s",
              flush=True)
    eng.close()
    if own_group:
        import torch.distributed as dist

        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
