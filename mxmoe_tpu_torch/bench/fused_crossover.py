"""Where the whole-FFN kernel stops paying: one qwen2_moe layer's routed
expert FFN (``moe_ffn_ragged_quant``: routing, dispatch, act quant, the
grouped GEMMs, combine) with ``fused_ffn=True`` (K12 / K13 over the 32-row
aligned dispatch) against the two-launch path (``fused_ffn=False``, the
serving default), by routed rows, on one card.

    python -m mxmoe_tpu_torch.bench.fused_crossover [--quant w8a8_g-1_sym]

The layer has the published widths of Qwen1.5-MoE-A2.7B and seeded random
weights, quantized as ``bench_serving --quant`` does. At 4 to 4096 tokens
(16 to 16384 routed rows), two timings, the L2 cache overwritten before
each call:

- event time (CUDA events around one call: the layer's host work while the
  card waits included), the two arms in turns, 31 turns after warm-up; the
  ratio fused / two-launch of each turn, and its quartiles. An arm is
  called faster only where the quartiles of the ratio lie on one side of 1,
  else the point is "unresolved": host time on a shared machine spreads
  more than the arms differ at some sizes.
- device time (``bench.timing.device_ms``: the summed durations of the
  kernels one call launched), median of 25 calls an arm.

Prints one JSON line per token count and a last line with the routed rows
(tokens x top-k) at which each arm was faster by event time, those left
unresolved, the fewest routed rows at which two-launch was faster, beside
the reference's ``fused_ffn="auto"`` rule (fuse at up to 2048 routed rows).
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
from .timing import device_ms

TOKENS = (4, 16, 64, 256, 512, 1024, 2048, 4096)
REPEATS = 31


def _quartiles(v: list) -> tuple:
    q = statistics.quantiles(v, n=4, method="inclusive")
    return q[0], statistics.median(v), q[2]


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
            q = _quartiles([f / t for f, t in zip(times["fused"], times["two_launch"])])
            dev_ms = {name: device_ms(fn) for name, fn in calls.items()}
            row = {"quant": args.quant, "tokens": tokens,
                   "routed_rows": tokens * cfg.top_k,
                   **{f"{name}_ms": statistics.median(t) for name, t in times.items()},
                   "fused_over_two_launch_q25_q50_q75": q,
                   "verdict": ("fused" if q[2] < 1.0 else "two_launch" if q[0] > 1.0
                               else "unresolved"),
                   **{f"{name}_device_ms": t for name, t in dev_ms.items()}}
            row["fused_over_two_launch"] = row["fused_ms"] / row["two_launch_ms"]
            row["device_fused_over_two_launch"] = (row["fused_device_ms"]
                                                   / row["two_launch_device_ms"])
            print(json.dumps(row), flush=True)
            rows.append(row)
    at = lambda v: [r["routed_rows"] for r in rows if r["verdict"] == v]
    print(json.dumps({"quant": args.quant,
                      "crossover_routed_rows": min(at("two_launch"), default=None),
                      "fused_faster_at_routed_rows": at("fused"),
                      "two_launch_faster_at_routed_rows": at("two_launch"),
                      "unresolved_at_routed_rows": at("unresolved"),
                      "reference_auto_rule": "fuse at routed rows <= 2048",
                      "device": torch.cuda.get_device_name(dev)}), flush=True)
    return rows


if __name__ == "__main__":
    main()
