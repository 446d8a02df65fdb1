"""Generation CLI: drive the serving engine end to end with random weights
(port of ``mxmoe_tpu/serving/generate.py``).

  python -m mxmoe_tpu_torch.serving.generate --model tiny --prompt "1 2 3" --max-new 8
  python -m mxmoe_tpu_torch.serving.generate --model qwen2_moe \\
      --quant w8a8_g-1_sym --max-new 64
  python -m mxmoe_tpu_torch.serving.generate --model ds2 --layers 4 \\
      --quant mixed-packed --decode-attn xla

``--ckpt`` and ``--artifact`` wait for the loader port (ROADMAP queue A).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import time

from .bench_serving import DECODE_ATTN


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tiny",
                    help="tiny | tiny_ds2 | qwen2_moe | ds2 | qwen2_moe_57b | "
                         "mixtral")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--quant", default="w8a8_g-1_sym",
                    help="what bench_serving --quant takes: a uniform expert "
                         "scheme, e.g. w8a8_g-1_sym or w4a16_g128_asym, or "
                         "mixed | mixed-packed | none (bf16 experts)")
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
    args = ap.parse_args(argv)

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
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params, impl = init_for_serving(
        cfg, gen, functools.partial(quantize_for_serving, quant=args.quant,
                                    decode_attn=args.decode_attn), device)
    eng = Engine(params, cfg, EngineConfig(
        batch_slots=args.slots, max_len=args.max_len,
        prefill_chunk=min(256, args.max_len // 2),
        temperature=args.temperature, seed=args.seed), impl)
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
    print(f"prompt tokens : {prompt}")
    print(f"output tokens : {out}")
    print(f"device {device}: prefill {t_prefill * 1e3:.1f} ms; decode {len(out)} "
          f"tok in {t_decode * 1e3:.1f} ms = {len(out) / max(t_decode, 1e-9):.1f} tok/s")


if __name__ == "__main__":
    main()
