"""Where the whole-FFN kernel stops paying: one qwen2_moe layer's routed
expert FFN (``moe_ffn_ragged_quant``: routing, dispatch, act quant, the
grouped GEMMs, combine) with ``fused_ffn=True`` (K12 / K13 over the 32-row
aligned dispatch) against the two-launch path (``fused_ffn=False``, the
serving default), by routed rows, on one card.

    python -m mxmoe_tpu_torch.bench.fused_crossover [--quant w8a8_g-1_sym]

The layer has the published widths of Qwen1.5-MoE-A2.7B and seeded random
weights, quantized as ``bench_serving --quant`` does. Timing: CUDA events
around one call, the L2 cache overwritten before each, the two arms in
turns, the median of 15 calls after warm-up, at 4 to 4096 tokens (16 to
16384 routed rows). Prints one JSON line per token count and a last line with the crossover: the fewest routed rows
(tokens x top-k) at which the two-launch path was faster, beside the
reference's ``fused_ffn="auto"`` rule (fuse at up to 2048 routed rows).
Needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics

import torch

from ..models import configs
from ..models.layers import moe_ffn_ragged_quant
from ..models.model import init_params
from ..serving.bench_serving import quantize_for_serving
from .headline import time_ms

TOKENS = (4, 16, 64, 256, 512, 1024, 2048, 4096)
REPEATS = 15


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quant", default="mixed-packed",
                    help="what bench_serving --quant takes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fused_crossover: no CUDA device; this measures the card only")
    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.QWEN2_MOE_A2_7B, num_layers=1)
    gen = torch.Generator(device=dev).manual_seed(0)
    floats = init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    params, impl = quantize_for_serving(floats, cfg, args.quant)
    del floats
    lp = {k: v[0] for k, v in params["layers"].items()}
    arms = {"fused": dataclasses.replace(impl, fused_ffn=True),
            "two_launch": dataclasses.replace(impl, fused_ffn=False)}
    rows = []
    with torch.no_grad():
        for tokens in TOKENS:
            x = torch.randn((tokens, cfg.hidden_size), generator=gen,
                            device=dev).to(torch.bfloat16)
            calls = {name: (lambda a=a: moe_ffn_ragged_quant(x, lp, cfg, a))
                     for name, a in arms.items()}
            for fn in calls.values():
                fn()
                fn()
            times = {name: [] for name in calls}
            for i in range(REPEATS):          # in turns: A B B A ...
                order = list(calls) if i % 2 == 0 else list(calls)[::-1]
                for name in order:
                    times[name].append(time_ms(calls[name]))
            row = {"quant": args.quant, "tokens": tokens,
                   "routed_rows": tokens * cfg.top_k,
                   **{f"{name}_ms": statistics.median(t) for name, t in times.items()}}
            row["fused_over_two_launch"] = row["fused_ms"] / row["two_launch_ms"]
            print(json.dumps(row), flush=True)
            rows.append(row)
    slower = [r["routed_rows"] for r in rows if r["fused_over_two_launch"] > 1.0]
    print(json.dumps({"quant": args.quant,
                      "crossover_routed_rows": min(slower) if slower else None,
                      "fused_faster_at_routed_rows": [
                          r["routed_rows"] for r in rows
                          if r["fused_over_two_launch"] <= 1.0],
                      "reference_auto_rule": "fuse at routed rows <= 2048",
                      "device": torch.cuda.get_device_name(dev)}), flush=True)
    return rows


if __name__ == "__main__":
    main()
