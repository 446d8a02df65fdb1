"""Kernel profiler -> the solver's performance table (port of
``mxmoe_tpu/trace/profiler.py``).

For each scheme, its kernel (``bench.kernels``) is timed at several
workload scales (``bench.workloads.synthetic_workload``: 60 experts, top-4,
K 2048, N 2816 at 2048 / 8192 / 16384 tokens) and the linear cost model
``t ~ first_iter_cost + inc x n_out_tiles`` is fitted, the tiles being the
output tiles of the schedule the kernel takes (``bench.kernels.scheme_tile``).

    python -m mxmoe_tpu_torch.trace.profiler [--schemes ...] [--out PATH]

writes ``mxmoe_tpu_torch/perf/performance_table.json`` by default, with the
card's ``nvidia-smi`` name and power limit under ``_meta``. On a card a time
is ``bench.timing.device_ms`` (the summed durations of the kernels one call
launched, the L2 cache overwritten before each call); on the CPU (tests) the
plain versions run and the time is the host's wall time. A scheme whose
kernel raises is an error: nothing is skipped.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import time

import numpy as np
import torch

from ..bench import workloads as wl_mod
from ..bench.kernels import TileSpec, build_operands, make_launcher, scheme_tile
from ..solver.perf_model import PerfModel, TileCost

PERF_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "perf")
DEFAULT_SCHEMES = ("w16a16_g-1_sym", "w8a8_g-1_sym", "w4a4_g-1_sym", "w8a16_g-1_sym",
                   "w4a16_g-1_sym", "w4a16_g128_asym", "w4a16_g-1_sym_packed",
                   "w4a8_g-1_sym_packed", "w4a4_g128_sym")
SCALES = (2048, 8192, 16384)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def n_out_tiles(wl: wl_mod.GroupGemmWorkload, tile: TileSpec) -> int:
    return sum(_cdiv(max(m, 1), tile.bm) * _cdiv(wl.n, tile.bn) for m in wl.group_sizes)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if not torch.cuda.is_available():
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True)
    return out.stdout.strip().splitlines()[0]


def time_call(fn, device, reps: int = 10) -> float:
    """Milliseconds of one call: device time on a card, host wall time (the
    median of ``reps``) on the CPU."""
    if device.type == "cuda":
        from ..bench import timing

        return timing.device_ms(fn, reps=reps)
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_scheme(scheme: str, k: int = 2048, n: int = 2816, num_experts: int = 60,
                   scales: tuple[int, ...] = SCALES, top_k: int = 4, device="cuda",
                   reps: int = 10) -> tuple[str, TileCost, dict]:
    """Fit of kernel time against output tiles for one scheme -> (tile
    name, TileCost, the fit's points and residuals). The tile is the
    schedule's at the largest scale; every scale must take the same one."""
    device = torch.device(device)
    xs, ys, tiles = [], [], set()
    for tokens in scales:
        wl = wl_mod.synthetic_workload(num_experts, tokens, top_k, k, n, seed=42)
        tile = scheme_tile(scheme, wl.m_total, k, n, num_experts)
        tiles.add(repr(tile))
        ops = build_operands(wl, scheme, device=device)
        launch = make_launcher(scheme)
        ys.append(time_call(lambda: launch(ops), device, reps))
        xs.append(n_out_tiles(wl, tile))
        del ops
    if len(tiles) != 1:
        raise ValueError(f"{scheme}: the scales take different schedules {tiles}")
    inc, first = np.polyfit(np.asarray(xs, float), np.asarray(ys, float), 1)
    resid = [float(y - (first + inc * x)) for x, y in zip(xs, ys)]
    cost = TileCost(bm=tile.bm, bn=tile.bn, first_iter_cost=float(max(first, 0.0)),
                    inc=float(inc))
    return repr(tile), cost, {"tiles": xs, "ms": ys, "residual_ms": resid,
                              "first_fit_ms": float(first)}


def build_performance_table(schemes, k: int = 2048, n: int = 2816,
                            num_experts: int = 60, scales: tuple[int, ...] = SCALES,
                            top_k: int = 4, save_path: str | None = None,
                            device="cuda", reps: int = 10,
                            verbose: bool = True) -> tuple[PerfModel, dict]:
    """Profile every scheme -> (PerfModel, {scheme: fit details}); with
    ``save_path`` the table is written there (``_meta``: the card, shapes,
    scales and each fit's points)."""
    table: dict[str, dict[str, TileCost]] = {}
    fits = {}
    for scheme in schemes:
        name, cost, fit = profile_scheme(scheme, k, n, num_experts, scales, top_k,
                                         device, reps)
        table[scheme] = {name: cost}
        fits[scheme] = fit
        if verbose:
            print(f"  {scheme} {name}: inc={cost.inc * 1e3:.4f} us/tile "
                  f"first={cost.first_iter_cost:.4f} ms residuals (ms) "
                  f"{[round(r, 5) for r in fit['residual_ms']]}", flush=True)
    pm = PerfModel(table)
    if save_path:
        meta = {"card": card_line() if torch.device(device).type == "cuda" else "cpu",
                "k": k, "n": n, "experts": num_experts, "top_k": top_k,
                "scales": list(scales),
                "time": "device_ms" if torch.device(device).type == "cuda" else "host_ms",
                "fits": fits}
        pm.save(save_path, meta=meta)
    return pm, fits


def _main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="kernel performance-table profiler")
    ap.add_argument("--schemes", nargs="+", default=list(DEFAULT_SCHEMES))
    ap.add_argument("--k", type=int, default=2048)
    ap.add_argument("--n", type=int, default=2816)
    ap.add_argument("--experts", type=int, default=60)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=os.path.join(PERF_DIR, "performance_table.json"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    build_performance_table(args.schemes, k=args.k, n=args.n,
                            num_experts=args.experts, save_path=args.out,
                            device=args.device, reps=args.reps)
    print(f"performance table -> {args.out}")


if __name__ == "__main__":
    _main()
