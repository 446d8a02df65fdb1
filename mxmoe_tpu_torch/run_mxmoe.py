"""Pipeline driver (port of the root ``run_mxmoe.py``, the reference's
``run_mxmoe_gg.py``): per layer, gate trace -> workload JSON -> scheme-
bucketed kernel check (``--check``) -> bench -> CSV. The reference
regenerates CUDA sources and rebuilds a C++ binary for each workload
(``run_mxmoe_gg.py:69-138``); here the kernels are built once from the
repository's sources at first use and each takes the schedule its shapes
give.

  python -m mxmoe_tpu_torch.run_mxmoe --model qwen2_moe --bs 8192 --layer 10 \
      --trace moe-gate.json --qconfig mix.json --check
  python -m mxmoe_tpu_torch.run_mxmoe --bs 8192 --layer 10 --qstr w8a8_g-1_sym

Without ``--trace`` the canonical recorded distribution is used (qwen2_moe
layer 10 at 8192 tokens, ``bench.workloads.QWEN2_MOE_L10_BS8192_ROUTED_M``),
with qwen2_moe's widths from ``config.MODEL_REGISTRY``; another ``--model``
needs ``--trace``. Runs on the card.
"""

from __future__ import annotations

import argparse
import json
import os

from .utils.logging import setup_logger


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="qwen2_moe")
    ap.add_argument("--bs", type=int, default=8192)
    ap.add_argument("--layer", type=int, nargs="+", default=[10])
    ap.add_argument("--trace", default=None,
                    help="gate trace JSON; default: canonical recorded trace")
    ap.add_argument("--qconfig", default=None, help="solved qconfig JSON")
    ap.add_argument("--qstr", default=None, help="uniform scheme string")
    ap.add_argument("--check", action="store_true", help="run check before bench")
    ap.add_argument("--out_dir", default="out")
    args = ap.parse_args(argv)

    log = setup_logger("run_mxmoe", log_dir=os.path.join(args.out_dir, "log"),
                       tag="run_mxmoe")

    from .bench.harness import run_bench, run_check
    from .bench.workload_gen import generate_workload_from_gate_trace
    from .quant.schemes import QModelConfig

    if args.trace:
        with open(args.trace) as f:
            trace = json.load(f)
    else:
        from .bench.workloads import QWEN2_MOE_L10_BS8192_ROUTED_M
        from .config import get_model_spec

        if args.model != "qwen2_moe":
            ap.error(f"the canonical trace is qwen2_moe's: give --trace for {args.model}")
        spec = get_model_spec(args.model)
        trace = {"topk": spec.top_k, "NK": [spec.moe_intermediate_size, spec.hidden_size],
                 "num_layers": max(args.layer) + 1, "num_tokens": 8192,
                 "num_samples": 1, "num_shared_experts": spec.num_shared_experts}
        for l in args.layer:
            trace[f"layer-{l}"] = {"access_freq": list(QWEN2_MOE_L10_BS8192_ROUTED_M),
                                   "weights_sum": [], "percentile_stats": {}}

    qcfg = QModelConfig.load(args.qconfig) if args.qconfig else None

    os.makedirs(f"{args.out_dir}/workloads", exist_ok=True)
    os.makedirs(f"{args.out_dir}/bench", exist_ok=True)
    out = {}
    for layer in args.layer:
        tag = f"{args.model}-bs{args.bs}-l{layer}-{args.qstr or 'qcfg'}"
        wl_path = f"{args.out_dir}/workloads/{tag}.json"
        wl = generate_workload_from_gate_trace(trace, args.bs, layer, wl_path,
                                               qconfig=qcfg, qstr=args.qstr)
        log.info(f"workload -> {wl_path}")
        if args.check:
            ok = run_check(wl)
            log.info(f"layer {layer} check: {'PASS' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(1)
        csv_path = f"{args.out_dir}/bench/{tag}.csv"
        rows = run_bench(wl, csv_path)
        log.info(f"bench -> {csv_path} ({len(rows)} kernels)")
        out[layer] = rows
    return out


if __name__ == "__main__":
    main()
