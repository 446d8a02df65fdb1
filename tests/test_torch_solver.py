"""Port parity for the solver (``mxmoe_tpu_torch.solver``: ``bits_solver``'s
``solve_layer`` / ``solve_model`` / ``solve_model_level``, the pools,
``export_qconfig`` and the CLI; ``perf_model``'s three runtime models) and
for ``quant.schemes.strategy_bits`` and ``bench.workloads.synthetic_workload``,
against the JAX package. The solver is numpy and scipy in both packages: the
same losses, gate trace and table give EQUAL assignments and pools, and loss
and time within 1e-12 relative."""

import json
import sys

import numpy as np
import pytest

from mxmoe_tpu.bench import workloads as jax_workloads
from mxmoe_tpu.quant import schemes as jax_schemes
from mxmoe_tpu.solver import bits_solver as jax_bs
from mxmoe_tpu.solver import perf_model as jax_pm
from mxmoe_tpu_torch.bench import workloads
from mxmoe_tpu_torch.quant import schemes
from mxmoe_tpu_torch.solver import bits_solver as bs
from mxmoe_tpu_torch.solver import perf_model as pm

SCHEMES = ("w8a8_g-1_sym", "w4a4_g-1_sym", "w4a16_g128_asym")
E, LAYERS, N, K = 8, 2, 1408, 2048
# the analytic roofline at explicit rates, the same in both packages
ANALYTIC = dict(peak_bf16_tflops=989.0, peak_int8_tops=1979.0, hbm_gbps=3350.0)
ONELAUNCH = dict(int8_tflops_eff=600.0, bf16_tflops_eff=400.0, hbm_gbps_eff=2500.0,
                 quant_gbps_eff=2000.0, launch_ms=0.004, unpack_gops=3000.0)


def _problem(seed=0, dense=False):
    rng = np.random.default_rng(seed)
    trace = {"topk": 4, "NK": [N, K], "num_layers": LAYERS, "num_tokens": 4096,
             "num_samples": 8, "num_shared_experts": 4}
    for l in range(LAYERS):
        trace[f"layer-{l}"] = {"access_freq": rng.integers(200, 4000, E).tolist()}
    base = rng.uniform(0.5, 2.0, (LAYERS, E + 1, 3))
    scale = {"w8a8_g-1_sym": 0.05, "w4a4_g-1_sym": 1.0, "w4a16_g128_asym": 0.3}
    losses = {}
    for s in SCHEMES:
        jitter = rng.uniform(0.8, 1.2, base.shape)
        losses[s] = {str(l): {str(e): (base[l, e] * jitter[l, e] * scale[s]).tolist()
                              for e in range(E + 1)} for l in range(LAYERS)}
        if dense:
            losses[s]["dense-0"] = {"0": (rng.uniform(0.5, 2.0, 3) * scale[s]).tolist()}
    if dense:
        trace["first_dense_layers"] = 1
        trace["dense_NK"] = [10944, K]
    return losses, trace


def _table(tmp_path):
    rng = np.random.default_rng(1)
    tab = {s: {f"t-{s}-bm{bm}": {"bm": bm, "bn": bn, "first_iter_cost": 0.01,
                                 "inc": float(rng.uniform(1e-4, 1e-3))}
               for bm, bn in ((128, 256), (32, 128))} for s in SCHEMES}
    tab["_meta"] = {"card": "test"}
    path = tmp_path / "table.json"
    path.write_text(json.dumps(tab))
    return str(path)


def _models(kind, tmp_path, k=K):
    if kind == "table":
        p = _table(tmp_path)
        return jax_pm.load_perf_table(p), pm.load_perf_table(p)
    if kind == "onelaunch":
        return (jax_pm.OneLaunchPerfModel(k, **ONELAUNCH),
                pm.OneLaunchPerfModel(k, **ONELAUNCH))
    return (jax_pm.AnalyticPerfModel(k, **ANALYTIC), pm.AnalyticPerfModel(k, **ANALYTIC))


def _same_pool(a, b):
    assert len(a) == len(b)
    for (aa, la, ta), (ab, lb, tb) in zip(a, b):
        assert aa == ab
        assert la == pytest.approx(lb, rel=1e-12) and ta == pytest.approx(tb, rel=1e-12)


def test_strategy_bits_and_synthetic_workload_equal_the_reference():
    for s in ("w8a8_g-1_sym", "w4a16_g128_asym", "w3a16_g64_sym", "w16a16_g-1_sym",
              "w4a4_g128_sym", "w2a16_g32_asym", "w8a16_g-1_asym"):
        assert schemes.strategy_bits(s) == jax_schemes.strategy_bits(s), s
    for args in ((60, 2048, 4, 2048, 2816), (8, 512, 2, 64, 96), (64, 16384, 6, 128, 256)):
        for seed in (0, 42):
            a = workloads.synthetic_workload(*args, seed=seed)
            b = jax_workloads.synthetic_workload(*args, seed=seed)
            assert a.group_sizes == b.group_sizes and a.name == b.name


@pytest.mark.parametrize("kind", ["table", "onelaunch", "analytic"])
def test_solve_layer_and_model_equal_the_reference(kind, tmp_path):
    losses, trace = _problem(kind == "analytic", dense=kind == "onelaunch")
    pj, pt = _models(kind, tmp_path)
    probs_j = jax_bs.build_layer_problems(losses, trace, 4096, LAYERS)
    probs_t = bs.build_layer_problems(losses, trace, 4096, LAYERS)
    assert [k for k, _ in probs_t] == [k for k, _ in probs_j]
    for (_, a), (_, b) in zip(probs_j, probs_t):
        np.testing.assert_array_equal(a.ms, b.ms)
        np.testing.assert_array_equal(a.sizes, b.sizes)
    rj = jax_bs.solve_layer(probs_j[0][1], list(SCHEMES), 6.0, 0.5, pj)
    rt = bs.solve_layer(probs_t[0][1], list(SCHEMES), 6.0, 0.5, pt)
    assert rt.assignment == rj.assignment and rt.tile_cfg == rj.tile_cfg
    assert rt.loss == pytest.approx(rj.loss, rel=1e-12)
    assert rt.time_ms == pytest.approx(rj.time_ms, rel=1e-12)
    _same_pool(rt.pool, rj.pool)
    assert len(rt.pool) > 1
    pool_j, pool_t = {}, {}
    qj, tj = jax_bs.solve_model(losses, trace, 4096, LAYERS, 6.0, 0.5, pj, pool_out=pool_j)
    qt, tt = bs.solve_model(losses, trace, 4096, LAYERS, 6.0, 0.5, pt, pool_out=pool_t)
    assert qt.to_dict() == qj.to_dict() and tt == tj
    assert pool_t == pool_j
    used = {c.scheme_name for lay in qt.layers.values()
            for ex in lay.experts.values() for c in ex.qmap().values()}
    assert len(used) >= 2


def test_solve_model_level_and_export_equal_the_reference(tmp_path):
    losses, trace = _problem(3, dense=True)
    qj = jax_bs.solve_model_level(losses, trace, 4096, LAYERS, 5.0)
    qt = bs.solve_model_level(losses, trace, 4096, LAYERS, 5.0)
    assert qt.to_dict() == qj.to_dict()
    assert "dense-0" in qt.layers
    jax_bs.export_qconfig(qj, {"0": {"a": "b"}}, str(tmp_path / "j.json"))
    bs.export_qconfig(qt, {"0": {"a": "b"}}, str(tmp_path / "t.json"))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    assert (tmp_path / "t_tile_cfg.json").read_text() == \
        (tmp_path / "j_tile_cfg.json").read_text()


def test_cli_explicit_mode_equals_the_reference(tmp_path, monkeypatch):
    losses, trace = _problem(5)
    (tmp_path / "trace.json").write_text(json.dumps(trace))
    pairs = []
    for s in SCHEMES:
        (tmp_path / f"{s}.json").write_text(json.dumps(losses[s]))
        pairs.append(f"{s}={tmp_path / (s + '.json')}")
    table = _table(tmp_path)
    args = ["--trace", str(tmp_path / "trace.json"), "--loss", *pairs, "--batch", "4096",
            "--wbits", "6.0", "--perf_table", table]
    (tmp_path / "j").mkdir()
    monkeypatch.setattr(sys, "argv", ["bits_solver", *args, "--out",
                                      str(tmp_path / "j" / "q.json")])
    jax_bs._main()
    bs._main(args + ["--out", str(tmp_path / "t" / "q.json")])
    for f in ("q.json", "q_tile_cfg.json", "q_pool.json"):
        assert (tmp_path / "t" / f).read_text() == (tmp_path / "j" / f).read_text(), f


def test_cli_reads_only_the_ports_fits(tmp_path, monkeypatch, capsys):
    """Without the port's own perf/*.json the CLI says so and takes the H100
    defaults; it never reads the repo root's TPU fits."""
    losses, trace = _problem(6)
    (tmp_path / "trace.json").write_text(json.dumps(trace))
    pairs = []
    for s in SCHEMES:
        (tmp_path / f"{s}.json").write_text(json.dumps(losses[s]))
        pairs.append(f"{s}={tmp_path / (s + '.json')}")
    monkeypatch.setattr(pm, "ONELAUNCH_JSON", str(tmp_path / "none.json"))
    monkeypatch.setattr(pm, "TABLE_JSON", str(tmp_path / "none2.json"))
    base = ["--trace", str(tmp_path / "trace.json"), "--loss", *pairs, "--pool", "0"]
    bs._main(base + ["--out", str(tmp_path / "a.json")])
    bs._main(base + ["--runtime_model", "bucketed", "--out", str(tmp_path / "b.json")])
    out = capsys.readouterr().out
    assert "no one-launch fit" in out and "no measured table" in out
    assert (tmp_path / "a.json").exists() and (tmp_path / "b.json").exists()


def test_perf_models_cost_like_the_reference(tmp_path):
    for kind in ("table", "onelaunch", "analytic"):
        pj, pt = _models(kind, tmp_path)
        for s in (*SCHEMES, "w4a4_g-1_sym_packed", "w16a16_g-1_sym"):
            if kind == "table" and s not in SCHEMES:
                continue
            for m, n in ((1, 1408), (300, 2816), (8192, 11264)):
                assert pt.problem_ms(s, m, n) == pj.problem_ms(s, m, n), (kind, s)
    aj, at = _models("analytic", tmp_path)
    mj, mt = _models("table", tmp_path)
    assert (pm.validate_analytic_against_measured(at, mt)
            == jax_pm.validate_analytic_against_measured(aj, mj))
    # the defaults are the H100's, not a TPU's
    a = pm.AnalyticPerfModel(K)
    assert a.peak_int8 == pm.H100_INT8_TOPS * 1e12 * 0.6
    assert a.bw == pm.H100_HBM_GBPS * 1e9 * 0.6


def test_solve_model_under_a_spent_time_budget_keeps_a_feasible_mix(tmp_path, monkeypatch):
    """With its time budget spent before it starts, every MILP gets half a
    second and keeps the best assignment found: the mix still holds each
    layer to the bits budget with gate == up, and on this small problem
    HiGHS reaches the unbudgeted solve's mix within that time."""
    losses, trace = _problem(0)
    _, pt = _models("table", tmp_path)
    want, want_tiles = bs.solve_model(losses, trace, 4096, LAYERS, 6.0, 0.5, pt)
    limits, milp = [], bs.milp

    def timed_milp(*args, options, **kw):
        limits.append(options.get("time_limit"))
        return milp(*args, options=options, **kw)

    monkeypatch.setattr(bs, "milp", timed_milp)
    got, tiles = bs.solve_model(losses, trace, 4096, LAYERS, 6.0, 0.5, pt,
                                time_budget_s=0.0)
    assert limits and set(limits) == {0.5}
    for key, prob in bs.build_layer_problems(losses, trace, 4096, LAYERS):
        tot = 0.0
        for e, size in enumerate(prob.sizes):
            qm = got.layers[key].experts[str(e)].qmap()
            assert qm["gate"].scheme_name == qm["up"].scheme_name
            tot += size * sum(schemes.strategy_bits(c.scheme_name)[0] for c in qm.values())
        assert tot / (3.0 * float(sum(prob.sizes))) <= 6.0 + 1e-9
    assert got.to_dict() == want.to_dict() and tiles == want_tiles
