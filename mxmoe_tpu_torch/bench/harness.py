"""Check / bench harness over a workload JSON (port of
``mxmoe_tpu/bench/harness.py``; the reference's ``./build/test {check,bench}
--input workload.json --output csv``, ``test.cu:950-984``):

  python -m mxmoe_tpu_torch.bench.harness check --input <workload.json>
  python -m mxmoe_tpu_torch.bench.harness bench --input <workload.json> --output <csv>

check: each scheme bucket's kernel (``bench.kernels.make_launcher``: K11,
K2, K9, K6 or K8 by scheme) against the f32 product of the dequantized
operands, element by element within ``--tol``; on a mismatch the
(problem, row, col) and an 8 x 8 window of reference and result are
printed (``test.cu:139-150``). ``--device cpu`` runs the kernels' plain
versions.
bench (the card only): device ms (``bench.timing.device_ms``), TFLOPS =
sum 2MNK / t, and the speedup against the stock grouped product
(``torch._grouped_mm``) on the bf16-cast operands, the reference's vendor
baseline (``test.cu:846-854``); CSV out. One tile a scheme: each kernel
takes the schedule its shapes give (``bench.kernels.scheme_tile``).
"""

from __future__ import annotations

import csv
import json
import sys

import numpy as np
import torch

from . import workloads as wl_mod
from .kernels import build_operands, make_launcher, reference_output, scheme_tile
from .workload_gen import workload_to_group_problem


def _layer_dicts(workload: dict):
    for key, val in workload.items():
        if key.startswith("layer-"):
            yield key, val


def _bucket_workloads(layer_wl: dict, which: str):
    """A layer's problems split into per-scheme buckets of contiguous rows."""
    ms, k, n, schemes, shared = workload_to_group_problem(layer_wl, which)
    buckets: dict[str, list[int]] = {}
    for m, q in zip(ms, schemes):
        name = (f"w{q['w_bits']}a{q['a_bits']}_g{q['gsize']}_"
                f"{'sym' if q['sym'] else 'asym'}")
        buckets.setdefault(name, []).append(m)
    out = {name: wl_mod.GroupGemmWorkload(name=f"{which}-{name}",
                                          group_sizes=tuple(mlist), k=k, n=n)
           for name, mlist in buckets.items()}
    return out, shared


def _mismatch_report(res: np.ndarray, ref: np.ndarray, group_sizes, tol: float):
    diff = np.abs(res - ref)
    r, c = np.unravel_index(np.argmax(diff), diff.shape)
    ends = np.cumsum(group_sizes)
    prob = int(np.searchsorted(ends, r, side="right"))
    r0, c0 = (r // 8) * 8, (c // 8) * 8
    print(f"  MISMATCH problem={prob} at ({r},{c}) |Δ|={diff[r, c]:.4f} > {tol}")
    print("  ref 8x8 window:")
    print(np.array2string(ref[r0:r0 + 8, c0:c0 + 8], precision=3))
    print("  res 8x8 window:")
    print(np.array2string(res[r0:r0 + 8, c0:c0 + 8], precision=3))


def run_check(workload: dict, tol: float = 1.0, device="cuda") -> bool:
    """Element-wise absolute-tolerance check, per layer x {gate_up, down} x
    scheme bucket."""
    ok = True
    for lname, layer_wl in _layer_dicts(workload):
        for which in ("gate_up", "down"):
            buckets, _ = _bucket_workloads(layer_wl, which)
            for scheme, wl in buckets.items():
                ops = build_operands(wl, scheme, device=device)
                res = make_launcher(scheme)(ops).float().cpu().numpy()
                ref = reference_output(ops, scheme).cpu().numpy()
                good = bool(np.all(np.abs(res - ref) <= tol))
                print(f"[CHECK] {lname} {which} {scheme} "
                      f"M={wl.m_total} E={wl.num_experts}: {'PASS' if good else 'FAIL'}")
                if not good:
                    _mismatch_report(res, ref, wl.group_sizes, tol)
                    ok = False
    return ok


def run_bench(workload: dict, output_csv: str | None = None) -> list[dict]:
    """Device ms, TFLOPS and the speedup over the stock bf16 grouped product
    for every scheme bucket (on the card) -> the CSV's rows."""
    from ..ops.gmm import gmm
    from .timing import device_ms

    rows = []
    for lname, layer_wl in _layer_dicts(workload):
        for which in ("gate_up", "down"):
            buckets, _ = _bucket_workloads(layer_wl, which)
            for scheme, wl in buckets.items():
                ops = build_operands(wl, scheme, device="cuda")
                lhs16 = ops["lhs"].float().to(torch.bfloat16)
                rhs16 = ops["rhs"].float().to(torch.bfloat16)
                base_ms = device_ms(lambda: gmm(lhs16, rhs16, ops["gs"]))
                launch = make_launcher(scheme)
                ms = device_ms(lambda: launch(ops))
                tile = scheme_tile(scheme, wl.m_total, wl.k, wl.n, wl.num_experts)
                row = {"layer": lname, "which": which, "scheme": scheme,
                       "tile": repr(tile), "M": wl.m_total, "N": wl.n, "K": wl.k,
                       "ms": ms, "tflops": wl.flops / (ms * 1e-3) / 1e12,
                       "baseline_ms": base_ms, "speedup_vs_bf16": base_ms / ms}
                rows.append(row)
                print(f"[BENCH] {lname} {which} {scheme} {tile!r}: {ms:.4f} ms = "
                      f"{row['tflops']:.2f} TFLOPS ({row['speedup_vs_bf16']:.3f}x vs "
                      "bf16 torch._grouped_mm)", flush=True)
                del ops, lhs16, rhs16
    if output_csv and rows:
        with open(output_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
    return rows


def _main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["check", "bench"])
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", default=None)
    ap.add_argument("--tol", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="check: cpu | cuda | cuda:N (default: cuda; cpu runs "
                         "the kernels' plain versions); bench runs on the card")
    args = ap.parse_args(argv)

    with open(args.input) as f:
        workload = json.load(f)
    if args.mode == "check":
        ok = run_check(workload, tol=args.tol, device=args.device or "cuda")
        sys.exit(0 if ok else 1)
    run_bench(workload, args.output)


if __name__ == "__main__":
    _main()
