"""Accuracy-eval CLI (port of ``mxmoe_tpu/eval/run.py``; the reference's
``python -m mxmoe.quant.quant eval``, ``quant.py:811-892``): quantize a
model per scheme or qconfig and method, then score its perplexity.

  python -m mxmoe_tpu_torch.eval.run --model qwen2_moe --ckpt <dir> \
      --method rtn-had --qstr w4a4_g-1_sym --tasks ppl
  python -m mxmoe_tpu_torch.eval.run --model qwen2_moe --qconfig mix.json \
      --method rtn --real-exec --layers 2 --seqlen 512 --nsamples 4

``--real-exec`` scores the real quantized execution (the kernels the
storage selects: K1 and K2 / K4 / K5 / K8 / K10 by scheme, packed w <= 4
storage, the int8 shared expert) instead of the fake-quant float forward.
Runs on the card (``--device cuda``, the default); ``--device cpu`` runs the
kernels' plain versions. The ppl windows are ``quant.data``'s seeded
synthetic stream (``synthetic_ppl``) unless a tokenizer and a local text
(``MXMOE_CALIB_TEXT``) are given; ``--tasks zero-shot`` needs lm-eval's
task data, a download, and raises when a tokenizer is given (it is skipped
without one, as in the reference).
"""

from __future__ import annotations

import argparse
import dataclasses
import json


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="qwen2_moe")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--method", default="rtn",
                    choices=["rtn", "gptq", "rtn-had", "gptq-had", "none"])
    ap.add_argument("--qstr", default=None, help="uniform scheme string")
    ap.add_argument("--qconfig", default=None, help="solved qconfig JSON")
    ap.add_argument("--tasks", nargs="+", default=["ppl"])
    ap.add_argument("--seqlen", type=int, default=4096)
    ap.add_argument("--nsamples", type=int, default=16)
    ap.add_argument("--calib-nsamples", type=int, default=8)
    ap.add_argument("--tokenizer", default=None)
    ap.add_argument("--real-exec", action="store_true",
                    help="score ppl through the real quantized execution (the "
                         "kernels the storage selects, packed w<=4 storage, int8 "
                         "shared expert) instead of fake-quant; methods "
                         "rtn/gptq/gptq-had, w<=8 (a<=8 or a16) schemes")
    ap.add_argument("--out", default=None, help="write results JSON here")
    ap.add_argument("--device", default=None,
                    help="cpu | cuda | cuda:N (default: cuda; cpu must be asked "
                         "for and runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.real_exec and (args.method == "none" or not (args.qstr or args.qconfig)):
        # without a quant config the run would score the unquantized model
        # while labeled as real-execution ppl
        ap.error("--real-exec requires a quant config (--qstr/--qconfig) "
                 "and --method rtn/gptq/gptq-had")

    import numpy as np
    import torch

    from ..models import configs, model as model_mod
    from ..models.layers import MoEImpl
    from ..quant.data import get_calibration_tokens
    from ..quant.quantizer import quantize_model_fake
    from ..quant.schemes import QModelConfig, build_uniform_model, parse_scheme
    from ..serving.generate import _to
    from .evaluator import eval_ppl_tokens, eval_tasks

    device = torch.device(args.device or "cuda")
    cfg = configs.config_for(args.model)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    # bf16 params: a full-width model in f32 would not fit beside its quantized
    # copy. A checkpoint loads into host memory; the quantizers work on
    # ``device`` a layer at a time and the result moves there.
    if args.ckpt:
        from ..models.hf_loader import params_from_safetensors

        params = params_from_safetensors(args.ckpt, cfg, dtype=torch.bfloat16)
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        params = model_mod.init_params(cfg, gen, dtype=torch.bfloat16, device=device)

    tokenizer = None
    if args.tokenizer:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)

    has_a16 = False
    if args.method != "none" and (args.qstr or args.qconfig):
        if args.qconfig:
            qmodel = QModelConfig.load(args.qconfig)
        else:
            qmodel = build_uniform_model(parse_scheme(args.qstr), cfg.num_layers,
                                         cfg.num_experts + 1)
        calib = None
        if args.method.startswith("gptq"):
            calib = get_calibration_tokens(args.calib_nsamples, min(args.seqlen, 512),
                                           tokenizer=tokenizer,
                                           vocab_size=cfg.vocab_size)
        if args.real_exec:
            # a16 weight-only experts go through the one launch of both kinds
            # (mixed_weight_only); such mixes keep int8-stored codes
            if args.method not in ("rtn", "gptq", "gptq-had"):
                ap.error("--real-exec supports --method rtn/gptq/gptq-had")
            has_a16 = any(q.a_bits >= 16 for lc in qmodel.layers.values()
                          for ekey, ec in lc.experts.items()
                          if int(ekey) < cfg.num_experts
                          for q in ec.qmap().values())
            if args.method == "rtn":
                from ..quant.qparams import quantize_model_experts_mixed

                params = quantize_model_experts_mixed(params, cfg, qmodel,
                                                      pack_w4=not has_a16,
                                                      device=device)
            else:
                from ..quant.quantizer import quantize_model_experts_mixed_gptq

                params = quantize_model_experts_mixed_gptq(
                    params, cfg, qmodel, calib, pack_w4=not has_a16,
                    hadamard=args.method.endswith("-had"), device=device)
        else:
            params = quantize_model_fake(params, cfg, qmodel, method=args.method,
                                         calib_tokens=calib, device=device)
    params = _to(params, device)

    if args.real_exec:
        impl = MoEImpl(kind="ragged", quant="mixed", mixed_weight_only=has_a16)
    else:
        impl = MoEImpl(kind="ragged")
    results = {}
    if "ppl" in args.tasks:
        toks = np.asarray(get_calibration_tokens(
            args.nsamples, args.seqlen, dataset="auto", tokenizer=tokenizer,
            vocab_size=cfg.vocab_size))
        results["wikitext2_ppl" if tokenizer else "synthetic_ppl"] = (
            eval_ppl_tokens(params, toks, cfg, impl))
    if "zero-shot" in args.tasks and tokenizer is not None:
        results["zero_shot"] = eval_tasks(params, cfg, tokenizer, impl=impl)

    print(json.dumps(results, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
