"""Decode attention by S_max and batch: the fused kernel (K3 / K3q) against
the plain scatter + attention (``--decode-attn xla``), end to end through
``bench_serving``, on one card.

    python -m mxmoe_tpu_torch.bench.decode_attn_crossover [--layers 4]

For each model arm (qwen2_moe uniform w8a8 over the bf16 cache: K3; ds2
mixed-packed over the int8 cache: K3q, MLA), each S_max (``--max-lens``)
and each slot count (``--slots``), runs ``bench_serving.main`` four times in
ABBA order (fused, xla, xla, fused) in this one process, then prints one JSON
line: each arm's decode step ms (the two runs' values and their mean), the
ratio xla / fused and the card's name. The fused kernel's work follows each
slot's length; the plain path attends over all S_max positions, so its cost
grows with S_max. Every slot is prefilled with ``--prefill`` tokens.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics

ARMS = {"qwen2_moe": ["--model", "qwen2_moe", "--quant", "w8a8_g-1_sym"],
        "ds2": ["--model", "ds2", "--quant", "mixed-packed", "--int8-kv"]}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="+", default=list(ARMS), choices=list(ARMS))
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--max-lens", nargs="+", type=int, default=[1024, 4096])
    ap.add_argument("--slots", nargs="+", type=int, default=[4, 16])
    ap.add_argument("--prefill", type=int, default=512)
    args = ap.parse_args(argv)

    import torch

    from ..serving import bench_serving

    if not torch.cuda.is_available():
        raise SystemExit("decode_attn_crossover: no CUDA device; this benchmark "
                         "measures the card only")
    rows = []
    for model in args.models:
        for max_len in args.max_lens:
            for slots in args.slots:
                steps = {"fused": [], "xla": []}
                for attn in ("fused", "xla", "xla", "fused"):
                    buf = io.StringIO()
                    with contextlib.redirect_stdout(buf):
                        bench_serving.main([*ARMS[model], "--layers", str(args.layers),
                                            "--slots", str(slots), "--max-len",
                                            str(max_len), "--prefill",
                                            str(args.prefill), "--decode-attn", attn])
                    res = json.loads(buf.getvalue().strip().splitlines()[-1])
                    steps[attn].append(res["decode_step_ms"])
                    torch.cuda.empty_cache()
                row = {"model": model, "layers": args.layers, "max_len": max_len,
                       "slots": slots, "prefill": args.prefill,
                       "fused_step_ms": steps["fused"], "xla_step_ms": steps["xla"],
                       "fused_mean_ms": statistics.mean(steps["fused"]),
                       "xla_mean_ms": statistics.mean(steps["xla"]),
                       "device": torch.cuda.get_device_name(0)}
                row["xla_over_fused"] = row["xla_mean_ms"] / row["fused_mean_ms"]
                print(json.dumps(row), flush=True)
                rows.append(row)
    return rows


if __name__ == "__main__":
    main()
