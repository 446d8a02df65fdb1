"""Mixed-precision bitwidth allocation as a MILP (port of
``mxmoe_tpu/solver/bits_solver.py``, scipy's ``milp``, HiGHS).

  binaries x[e, b, s]: expert e (the routed experts, the shared expert as
  index E), linear b in {gate, up, down}, scheme s.
  constraints: one scheme per linear; gate == up; the expert-size-weighted
  average of the weight bits within the budget.

The objective ``L^r * T^(1-r)`` is solved by an epsilon-constraint sweep over
the runtime: minimize L s.t. T <= tau for a geometric tau sweep, then take
the solution that minimizes r log L + (1 - r) log T. The objective is
monotone in L and T, so its optimum lies on the (L, T) Pareto front the
sweep enumerates.

Runtime: T = the sum of the selected problems' costs under a
``solver.perf_model`` model: the measured table (each problem costed under
its scheme bucket's tile, an assignment <-> tile fixed point; the port's
kernels take one schedule a scheme, so it converges at once), the one-launch
model fitted on the card, or the analytic roofline.

    python -m mxmoe_tpu_torch.solver.bits_solver --trace moe-gate.json \
        --loss w8a8_g-1_sym=a.json w4a4_g-1_sym=b.json [--wbits 5 --r 0.5]
    python -m mxmoe_tpu_torch.solver.bits_solver --model qwen2_moe \
        --filter_list w8a8_g-1_sym w4a4_g-1_sym [--calib_dir calib]

The CLI's runtime models read only the port's own ``mxmoe_tpu_torch/perf``
fits (the card's); where one is missing it says so and falls back to the
H100 defaults.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time

import numpy as np
from scipy import sparse
from scipy.optimize import LinearConstraint, milp

from ..quant.schemes import (LINEAR_NAMES, QExpertConfig, QLayerConfig, QModelConfig,
                             parse_scheme, strategy_bits)
from .perf_model import AnalyticPerfModel, PerfModel


@dataclasses.dataclass
class LayerProblem:
    """Per-layer solver inputs."""

    losses: dict[str, np.ndarray]  # scheme -> [E, 3] calib loss
    ms: np.ndarray                 # [E] routed tokens (shared expert = batch)
    ns: np.ndarray                 # [E] gate/up output dim per expert
    k: int                         # hidden size (gate/up reduction, down output)
    sizes: np.ndarray              # [E] relative weight size (n*k / (N*K))


@dataclasses.dataclass
class SolveResult:
    assignment: dict[int, dict[str, str]]   # expert -> linear -> scheme
    loss: float
    time_ms: float
    tile_cfg: dict[str, str]                # scheme -> chosen tile repr
    # the solution pool: the (assignment, loss, time) list the
    # epsilon-constraint sweep enumerated, deduplicated, ranked by the
    # r-objective
    pool: list = dataclasses.field(default_factory=list)


def _n_out(problem: LayerProblem, e: int, b: int) -> int:
    return int(problem.ns[e]) if b < 2 else problem.k


def _cost_vectors(problem: LayerProblem, schemes: list[str], perf: PerfModel,
                  tiles: dict | None = None):
    """Loss/time/bits/size per binary. With ``tiles`` (scheme -> TileCost),
    each problem is costed under its bucket's FIXED tile — the launch model
    of scheme-bucketed execution; otherwise each problem gets its own best
    tile (optimistic bound, used to seed the fixed point)."""
    e_tot = problem.ms.shape[0]
    s_tot = len(schemes)
    loss = np.zeros(e_tot * 3 * s_tot)
    time = np.zeros_like(loss)
    bits = np.zeros_like(loss)
    size = np.zeros_like(loss)
    for e in range(e_tot):
        for b in range(3):
            for si, s in enumerate(schemes):
                i = (e * 3 + b) * s_tot + si
                loss[i] = problem.losses[s][e, b]
                m, n_o = int(problem.ms[e]), _n_out(problem, e, b)
                if tiles is not None and s in tiles:
                    time[i] = tiles[s].problem_ms(m, n_o)
                else:
                    time[i] = perf.problem_ms(s, m, n_o)
                bits[i] = strategy_bits(s)[0]
                size[i] = problem.sizes[e]
    return loss, time, bits, size


def _solve_milp(c, constraints, n, deadline=None):
    """One 0/1 MILP -> its assignment, or None. With ``deadline`` (a
    ``time.perf_counter()`` time) HiGHS stops there, or after half a second
    once it has passed, and the best assignment found by then is taken."""
    res = milp(
        c=c,
        constraints=constraints,
        integrality=np.ones(n),
        bounds=(0, 1),
        options=({} if deadline is None
                 else {"time_limit": max(0.5, deadline - time.perf_counter())}),
    )
    # status 1: the time limit, reached only with a deadline
    if res.status not in (0, 1) or res.x is None:
        return None
    return np.round(res.x).astype(int)


def solve_layer(
    problem: LayerProblem,
    schemes: list[str],
    wbits_target: float,
    r: float = 1.0,
    perf: PerfModel | None = None,
    n_sweep: int = 12,
    max_tile_iters: int = 4,
    deadline: float | None = None,
) -> SolveResult:
    """Solve one layer's scheme assignment. The tile is chosen with it:
    with a scheme's problems in one launch the tile is per bucket, so the
    two are solved as a fixed point (cost each problem under its bucket's
    tile, solve, take each bucket's argmin tile over its actual (M, N)
    list, repeat until stable). ``deadline``: as ``_solve_milp`` takes it,
    for every MILP of the layer."""
    e_tot = problem.ms.shape[0]
    s_tot = len(schemes)
    n = e_tot * 3 * s_tot
    perf = perf or AnalyticPerfModel(k=problem.k)

    loss_v, _, bits_v, size_v = _cost_vectors(problem, schemes, perf)

    rows, cols, vals = [], [], []
    lb, ub = [], []
    nrow = 0
    # one scheme per (e, b)
    for e in range(e_tot):
        for b in range(3):
            for si in range(s_tot):
                rows.append(nrow); cols.append((e * 3 + b) * s_tot + si); vals.append(1.0)
            lb.append(1.0); ub.append(1.0); nrow += 1
    # gate == up
    for e in range(e_tot):
        for si in range(s_tot):
            rows.append(nrow); cols.append((e * 3 + 0) * s_tot + si); vals.append(1.0)
            rows.append(nrow); cols.append((e * 3 + 1) * s_tot + si); vals.append(-1.0)
            lb.append(0.0); ub.append(0.0); nrow += 1
    # budget
    total_size = float(size_v.sum() / s_tot)  # Σ_{e,b} size_e
    for i in range(n):
        rows.append(nrow); cols.append(i); vals.append(bits_v[i] * size_v[i])
    lb.append(-np.inf); ub.append(wbits_target * total_size); nrow += 1

    a_base = sparse.csr_matrix((vals, (rows, cols)), shape=(nrow, n))
    base = LinearConstraint(a_base, np.array(lb), np.array(ub))

    all_probs = [(int(problem.ms[e]), _n_out(problem, e, b))
                 for e in range(e_tot) for b in range(3)]

    def bucket_probs(assign, s):
        return [
            (int(problem.ms[e]), _n_out(problem, e, b))
            for e in range(e_tot) for b in range(3)
            if assign[e][LINEAR_NAMES[b]] == s
        ]

    def solve_for_times(time_v):
        def with_time_cap(tau):
            a_t = sparse.csr_matrix(
                (time_v, (np.zeros(n, int), np.arange(n))), shape=(1, n)
            )
            return [base, LinearConstraint(a_t, -np.inf, tau)]

        # a launch's fixed cost (OneLaunchPerfModel): a constant a layer, it
        # never moves the MILP's argmin, but it shifts log T in the
        # r-weighted pick and the reported time
        t_const = float(getattr(perf, "layer_const_ms", 0.0))

        def build(x):
            sel = x.reshape(e_tot, 3, s_tot)
            assign = {
                e: {LINEAR_NAMES[b]: schemes[int(np.argmax(sel[e, b]))]
                    for b in range(3)}
                for e in range(e_tot)
            }
            return assign, float(loss_v @ x), float(time_v @ x) + t_const

        pool = []

        def pooled(x):
            assign, l_val, t_val = build(x)
            obj = (r * math.log(max(l_val, 1e-30))
                   + (1 - r) * math.log(max(t_val, 1e-30)))
            entry = (obj, assign, l_val, t_val)
            if all(e[1] != assign for e in pool):
                pool.append(entry)
            return entry

        if r >= 1.0:
            x = _solve_milp(loss_v, [base], n, deadline)
        elif r <= 0.0:
            x = _solve_milp(time_v, [base], n, deadline)
        else:
            # ε-constraint sweep on T
            x_t = _solve_milp(time_v, [base], n, deadline)
            x_l = _solve_milp(loss_v, [base], n, deadline)
            if x_t is None or x_l is None:
                raise RuntimeError("layer MILP infeasible (budget too tight?)")
            t_min = float(time_v @ x_t)
            t_max = max(float(time_v @ x_l), t_min * 1.0001)
            best, best_obj = None, np.inf
            for tau in np.geomspace(t_min, t_max, n_sweep):
                x = _solve_milp(loss_v, with_time_cap(tau * 1.0000001), n, deadline)
                if x is None:
                    continue
                obj = pooled(x)[0]
                if obj < best_obj:
                    best, best_obj = x, obj
            x = best
        if x is None:
            raise RuntimeError("layer MILP infeasible (budget too tight?)")
        assign, l_val, t_val = pooled(x)[1:]
        pool.sort(key=lambda e: e[0])
        return assign, l_val, t_val, [e[1:] for e in pool]

    # seed: every scheme costed under its all-problems bucket tile
    tiles = {s: perf.bucket_tile(s, all_probs) for s in schemes}
    assign = l_val = t_val = None
    pool = []
    for _ in range(max(1, max_tile_iters)):
        tcosts = {s: tc for s, (_, tc) in tiles.items()}
        _, time_v, _, _ = _cost_vectors(problem, schemes, perf, tcosts)
        assign, l_val, t_val, pool = solve_for_times(time_v)
        new_tiles = {}
        for s in schemes:
            probs = bucket_probs(assign, s)
            if probs:
                new_tiles[s] = perf.bucket_tile(s, probs)
            else:
                new_tiles[s] = tiles[s]
        if all(new_tiles[s][0] == tiles[s][0] for s in schemes):
            tiles = new_tiles
            break
        tiles = new_tiles

    tile_cfg = {
        s: tiles[s][0] for s in schemes if bucket_probs(assign, s)
    }
    return SolveResult(assignment=assign, loss=l_val, time_ms=t_val,
                       tile_cfg=tile_cfg, pool=pool)


def build_layer_problems(
    losses: dict[str, dict],     # scheme -> {layer: {expert: [g,u,d]}}
    gate_trace: dict,            # loaded moe-gate.json
    batch: int,
    num_layers: int,
) -> list[tuple[str, LayerProblem]]:
    """Per-layer problems keyed by the qconfig layer key. ds2's dense first
    layers are the pseudo-layers ``dense-<i>``, one pseudo-expert that sees
    every token."""
    n, k = gate_trace["NK"]
    topk = gate_trace["topk"]
    n_shared = gate_trace["num_shared_experts"]
    out = []
    schemes = list(losses.keys())
    for l in range(num_layers):
        freq = np.asarray(gate_trace[f"layer-{l}"]["access_freq"], dtype=np.float64)
        probs = freq / max(freq.sum(), 1)
        ms = list((probs * batch * topk).astype(int))
        ns = [n] * len(ms)
        sizes = [1.0] * len(ms)
        if n_shared:
            ms.append(batch)
            ns.append(n * n_shared)
            sizes.append(float(n_shared))
        e_tot = len(ms)
        layer_losses = {}
        for s in schemes:
            arr = np.zeros((e_tot, 3))
            ld = losses[s][str(l)]
            for e in range(e_tot):
                arr[e] = np.asarray(ld[str(e)], dtype=np.float64)
            layer_losses[s] = arr
        out.append((str(l), LayerProblem(
            losses=layer_losses, ms=np.asarray(ms), ns=np.asarray(ns),
            k=k, sizes=np.asarray(sizes),
        )))

    # dense pseudo-layers: present iff calibration emitted dense-<i> rows
    dense_keys = sorted(
        {key for d in losses.values() for key in d if key.startswith("dense-")},
        key=lambda s: int(s.split("-")[1]),
    )
    if dense_keys:
        dn, dk = gate_trace.get("dense_NK", (n, k))
        for key in dense_keys:
            layer_losses = {
                s: np.asarray([losses[s][key]["0"]], dtype=np.float64)
                for s in schemes
            }
            out.append((key, LayerProblem(
                losses=layer_losses,
                ms=np.asarray([batch]),           # every token runs dense
                ns=np.asarray([dn]),
                k=dk,
                sizes=np.asarray([dn / max(n, 1)]),
            )))
    return out


def solve_model(
    losses: dict[str, dict],
    gate_trace: dict,
    batch: int,
    num_layers: int,
    wbits_target: float,
    r: float = 1.0,
    perf: PerfModel | None = None,
    pool_out: dict | None = None,   # filled with per-layer solution pools
    time_budget_s: float | None = None,
) -> tuple[QModelConfig, dict[str, dict[str, str]]]:
    """Layer-level solve over all layers -> (QModelConfig, per-layer tiles).
    ``pool_out`` receives each layer's objective-ranked solution pool (the
    sweep's Pareto candidates). With ``time_budget_s`` every MILP stops at
    the budget's end, or after half a second once it is spent, and keeps
    the best assignment found (a feasible mix, not always the optimum):
    HiGHS's branch and bound takes seconds on most tables and minutes on
    a few."""
    deadline = None if time_budget_s is None else time.perf_counter() + time_budget_s
    problems = build_layer_problems(losses, gate_trace, batch, num_layers)
    schemes = list(losses.keys())
    layers = {}
    lt = {}
    tiles = {}
    for key, prob in problems:
        res = solve_layer(prob, schemes, wbits_target, r, perf, deadline=deadline)
        experts = {
            str(e): QExpertConfig(
                gate=parse_scheme(res.assignment[e]["gate"]),
                up=parse_scheme(res.assignment[e]["up"]),
                down=parse_scheme(res.assignment[e]["down"]),
            )
            for e in res.assignment
        }
        layers[key] = QLayerConfig(experts=experts)
        lt[key] = (res.loss, res.time_ms)
        tiles[key] = res.tile_cfg
        if pool_out is not None:
            pool_out[key] = [
                {"assignment": {str(e): dict(qm) for e, qm in a.items()},
                 "loss": l, "time_ms": t}
                for a, l, t in res.pool]
    return QModelConfig(layers=layers, lt=lt), tiles


def solve_model_level(
    losses: dict[str, dict],
    gate_trace: dict,
    batch: int,
    num_layers: int,
    wbits_target: float,
) -> QModelConfig:
    """Model-level variant: one MILP, loss-only objective, one budget over
    the model."""
    problems = build_layer_problems(losses, gate_trace, batch, num_layers)
    schemes = list(losses.keys())
    s_tot = len(schemes)
    per_layer_n = [p.ms.shape[0] * 3 * s_tot for _, p in problems]
    n = sum(per_layer_n)
    offs = np.cumsum([0] + per_layer_n)

    loss_v = np.zeros(n)
    bits_sz = np.zeros(n)
    rows, cols, vals, lb, ub = [], [], [], [], []
    nrow = 0
    total_size = 0.0
    for l, (_, p) in enumerate(problems):
        e_tot = p.ms.shape[0]
        perf = AnalyticPerfModel(k=p.k)
        lv, _, bv, sv = _cost_vectors(p, schemes, perf)
        loss_v[offs[l]: offs[l + 1]] = lv
        bits_sz[offs[l]: offs[l + 1]] = bv * sv
        total_size += float(sv.sum() / s_tot)
        for e in range(e_tot):
            for b in range(3):
                for si in range(s_tot):
                    rows.append(nrow)
                    cols.append(offs[l] + (e * 3 + b) * s_tot + si)
                    vals.append(1.0)
                lb.append(1.0); ub.append(1.0); nrow += 1
            for si in range(s_tot):
                rows.append(nrow); cols.append(offs[l] + (e * 3 + 0) * s_tot + si); vals.append(1.0)
                rows.append(nrow); cols.append(offs[l] + (e * 3 + 1) * s_tot + si); vals.append(-1.0)
                lb.append(0.0); ub.append(0.0); nrow += 1
    for i in range(n):
        rows.append(nrow); cols.append(i); vals.append(bits_sz[i])
    lb.append(-np.inf); ub.append(wbits_target * total_size); nrow += 1

    a = sparse.csr_matrix((vals, (rows, cols)), shape=(nrow, n))
    x = _solve_milp(loss_v, [LinearConstraint(a, np.array(lb), np.array(ub))], n)
    if x is None:
        raise RuntimeError("model-level MILP infeasible")

    layers = {}
    for l, (key, p) in enumerate(problems):
        e_tot = p.ms.shape[0]
        sel = x[offs[l]: offs[l + 1]].reshape(e_tot, 3, s_tot)
        experts = {}
        for e in range(e_tot):
            qm = {
                LINEAR_NAMES[b]: parse_scheme(schemes[int(np.argmax(sel[e, b]))])
                for b in range(3)
            }
            experts[str(e)] = QExpertConfig(gate=qm["gate"], up=qm["up"], down=qm["down"])
        layers[key] = QLayerConfig(experts=experts)
    return QModelConfig(layers=layers)


def export_qconfig(
    qcfg: QModelConfig, tiles: dict | None, save_path: str
) -> None:
    """The qconfig JSON, and the tiles as a sibling ``*_tile_cfg.json`` (the
    port's schedule names)."""
    qcfg.save(save_path)
    if tiles is not None:
        with open(save_path.replace(".json", "_tile_cfg.json"), "w") as f:
            json.dump(tiles, f, indent=2)


def _main(argv=None):
    import argparse
    import os

    from .perf_model import (ONELAUNCH_JSON, TABLE_JSON, OneLaunchPerfModel,
                             load_perf_table)

    ap = argparse.ArgumentParser(description="bitwidth MILP -> a qconfig JSON")
    ap.add_argument("--trace", default=None, help="moe-gate.json path")
    ap.add_argument("--loss", nargs="+", default=None,
                    help="scheme=path pairs of calibration loss JSONs (explicit mode)")
    # registry mode: the calibration's conventional paths
    ap.add_argument("--model", default=None)
    ap.add_argument("--qtype", default="rtn", choices=["rtn", "gptq", "rtn-had", "gptq-had"])
    ap.add_argument("--filter_list", nargs="+", default=None,
                    help="schemes to consider (registry mode)")
    ap.add_argument("--calib_dir", default="calib")
    ap.add_argument("--dataset", default="auto")
    ap.add_argument("--seqlen", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--wbits", type=float, default=5.0)
    ap.add_argument("--r", type=float, default=0.5)
    ap.add_argument("--perf_table", default=None)
    ap.add_argument("--runtime_model", choices=["bucketed", "onelaunch"],
                    default="onelaunch",
                    help="cost T as the one-launch mixed step (packed w<=4 "
                         "traffic, bitwidth-independent int8 compute) or per "
                         "scheme from the measured table")
    ap.add_argument("--no_packed_w4", action="store_true",
                    help="onelaunch: w<=4 codes int8-stored (no packed discount)")
    ap.add_argument("--pool", type=int, default=4,
                    help="also export the top-K solution pool a layer "
                         "(<out>_pool.json); 0 disables")
    ap.add_argument("--solve_mode", choices=["layer", "model"], default="layer")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.loss is None:
        if not (args.model and args.filter_list):
            ap.error("either --loss scheme=path pairs, or --model and --filter_list")
        args.trace = args.trace or (f"{args.calib_dir}/gate/{args.model}/"
                                    f"{args.dataset}/{args.seqlen}/moe-gate.json")
        args.loss = [f"{s}={args.calib_dir}/{args.model}-MOE-layer_out_norm-"
                     f"{args.qtype}-{s}.json" for s in args.filter_list]
    if args.trace is None:
        ap.error("--trace is required with --loss")
    if args.out is None:
        mix = "+".join(sorted(p.split("=", 1)[0] for p in args.loss))
        args.out = (f"qconfigs/{mix}/{args.model or 'model'}_{args.qtype}_"
                    f"S{args.solve_mode}_bs{args.batch}_wbits{args.wbits}_r{args.r}.json")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    with open(args.trace) as f:
        trace = json.load(f)
    if args.layers is None:
        args.layers = int(trace.get("num_layers"))
    losses = {}
    for pair in args.loss:
        scheme, path = pair.split("=", 1)
        with open(path) as f:
            losses[scheme] = json.load(f)

    perf = None
    if args.perf_table is not None:
        # an explicit measured table means the bucketed launch model
        args.runtime_model = "bucketed"
    k_hid = int(trace["NK"][1])
    if args.runtime_model == "onelaunch":
        if os.path.exists(ONELAUNCH_JSON):
            perf = OneLaunchPerfModel.from_fit_json(ONELAUNCH_JSON, k_hid,
                                                    packed_w4=not args.no_packed_w4)
        else:
            print(f"[bits_solver] no one-launch fit at {ONELAUNCH_JSON}: the "
                  "runtime term takes the H100 defaults (run python -m "
                  "mxmoe_tpu_torch.solver.onelaunch_fit on the card)", flush=True)
            perf = OneLaunchPerfModel(k_hid, packed_w4=not args.no_packed_w4)
    elif args.perf_table is None:
        if os.path.exists(TABLE_JSON):
            args.perf_table = TABLE_JSON
        else:
            print(f"[bits_solver] no measured table at {TABLE_JSON}: the runtime "
                  "term is the analytic roofline at the H100's peaks (run python "
                  "-m mxmoe_tpu_torch.trace.profiler on the card)", flush=True)
            perf = AnalyticPerfModel(k_hid)
    if args.perf_table:
        perf = load_perf_table(args.perf_table)

    if args.solve_mode == "layer":
        pools = {} if args.pool > 0 else None
        qcfg, tiles = solve_model(losses, trace, args.batch, args.layers, args.wbits,
                                  args.r, perf, pool_out=pools)
        if pools:
            pool_path = args.out.replace(".json", "") + "_pool.json"
            with open(pool_path, "w") as f:
                json.dump({k: v[: args.pool] for k, v in pools.items()}, f, indent=1)
            print(f"solution pool (top {args.pool} a layer) -> {pool_path}")
    else:
        qcfg, tiles = solve_model_level(losses, trace, args.batch, args.layers,
                                        args.wbits), None
    export_qconfig(qcfg, tiles, args.out)
    print(f"qconfig -> {args.out}")


if __name__ == "__main__":
    _main()
