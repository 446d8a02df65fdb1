"""Port parity for the kernel check / bench harness and its neighbours
(``mxmoe_tpu_torch.bench.{workload_gen, harness, fused_ab}``, ``config``,
``utils.logging``, and the one-launch fit's unpack reading in
``solver.onelaunch_fit``) against the JAX package, on the CPU (the kernels'
plain versions; the bench and the fit's timings need the card).

The workload JSON is byte-equal to JAX's; the bucketed and fused mixed
weight-only / w x a products are bitwise equal to each other and to JAX's
on the same operands (integer sums, the same f32 epilogue)."""

import dataclasses
import io
import logging
import re
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu import config as jax_config
from mxmoe_tpu.bench import fused_ab as jax_fused_ab
from mxmoe_tpu.bench import harness as jax_harness
from mxmoe_tpu.bench import workload_gen as jax_workload_gen
from mxmoe_tpu.quant import schemes as jax_schemes
from mxmoe_tpu_torch import config
from mxmoe_tpu_torch.bench import fused_ab, harness, workload_gen, workloads
from mxmoe_tpu_torch.ops import kernels
from mxmoe_tpu_torch.quant import schemes
from mxmoe_tpu_torch.solver import onelaunch_fit
from mxmoe_tpu_torch.utils import logging as port_logging

# the grouped and asymmetric workload of tests/test_pipeline.py's harness test
GROUPED_WL = {
    "num_tokens": 128,
    "layer-0": {
        "gate_up": [
            {"shape": [48, 64, 128], "w_bits": 4, "a_bits": 4, "gsize": 32, "sym": True},
            {"shape": [80, 64, 128], "w_bits": 4, "a_bits": 4, "gsize": 32, "sym": True},
            {"shape": [64, 64, 128], "w_bits": 8, "a_bits": 8, "gsize": -1, "sym": False},
        ],
        "down": [
            {"shape": [96, 128, 64], "w_bits": 8, "a_bits": 8, "gsize": -1, "sym": True},
        ],
    },
}


def _trace(layers=(3,)):
    """The canonical trace of run_mxmoe.py (qwen2_moe layer 10's counts)."""
    tr = {"topk": 4, "NK": [1408, 2048], "num_layers": max(layers) + 1,
          "num_tokens": 8192, "num_samples": 1, "num_shared_experts": 4}
    for l in layers:
        tr[f"layer-{l}"] = {"access_freq": list(workloads.QWEN2_MOE_L10_BS8192_ROUTED_M),
                            "weights_sum": [], "percentile_stats": {}}
    return tr


def _qconfig(pkg, e=60, layers=4):
    """Per-expert schemes cycling through per-channel, grouped, asymmetric
    and weight-only ones; the shared expert w8a8."""
    names = ("w4a4_g-1_sym", "w8a8_g-1_sym", "w4a4_g128_sym", "w8a8_g-1_asym",
             "w4a16_g128_asym")
    ex = {str(i): pkg.QExpertConfig(*([pkg.parse_scheme(names[i % len(names)])] * 3))
          for i in range(e)}
    ex[str(e)] = pkg.QExpertConfig(*([pkg.parse_scheme("w8a8_g-1_sym")] * 3))
    return pkg.QModelConfig(layers={str(l): pkg.QLayerConfig(experts=dict(ex))
                                    for l in range(layers)})


@pytest.mark.parametrize("kind", ["qstr", "qconfig", "float"])
def test_workload_json_byte_equal(tmp_path, kind):
    kw_t, kw_j = {}, {}
    if kind == "qstr":
        kw_t = kw_j = {"qstr": "w4a4_g128_asym"}
    elif kind == "qconfig":
        kw_t, kw_j = {"qconfig": _qconfig(schemes)}, {"qconfig": _qconfig(jax_schemes)}
    a, b = tmp_path / "t" / "wl.json", tmp_path / "j" / "wl.json"
    got = workload_gen.generate_workload_from_gate_trace(_trace(), 8192, 3, str(a), **kw_t)
    ref = jax_workload_gen.generate_workload_from_gate_trace(_trace(), 8192, 3, str(b),
                                                             **kw_j)
    assert got == ref
    assert a.read_bytes() == b.read_bytes()
    for which in ("gate_up", "down"):
        assert (workload_gen.workload_to_group_problem(got["layer-3"], which)
                == jax_workload_gen.workload_to_group_problem(ref["layer-3"], which))


def test_workload_gen_cli(tmp_path):
    import json

    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps(_trace((10,))))
    out = tmp_path / "wl.json"
    workload_gen._main(["--trace", str(trace), "--qstr", "w8a8_g-1_sym", "--out", str(out)])
    assert json.loads(out.read_text()) == jax_workload_gen.generate_workload_from_gate_trace(
        _trace((10,)), 8192, 10, qstr="w8a8_g-1_sym")


@pytest.mark.parametrize("wl", ["grouped", "qconfig"])
def test_bucket_workloads_equal_the_reference(wl):
    if wl == "grouped":
        layer = GROUPED_WL["layer-0"]
    else:
        layer = workload_gen.generate_workload_from_gate_trace(
            _trace(), 8192, 3, qconfig=_qconfig(schemes))["layer-3"]
    for which in ("gate_up", "down"):
        got, sh_t = harness._bucket_workloads(layer, which)
        ref, sh_j = jax_harness._bucket_workloads(layer, which)
        assert sh_t == sh_j and list(got) == list(ref)
        for name in ref:
            assert dataclasses.asdict(got[name]) == dataclasses.asdict(ref[name])


def test_run_check_grouped_and_asym_schemes():
    kernels.reset_launch_counts()
    out = io.StringIO()
    with redirect_stdout(out):
        assert harness.run_check(GROUPED_WL, tol=1.0, device="cpu")
    lines = [l for l in out.getvalue().splitlines() if l.startswith("[CHECK]")]
    assert len(lines) == 3 and all(l.endswith("PASS") for l in lines)
    assert all(n == 0 for n in kernels.launches.values())


def _mismatch_lines(text):
    return re.findall(r"MISMATCH problem=(\d+) at \((\d+),(\d+)\)", text)


def test_run_check_names_the_reference_mismatch(monkeypatch):
    """An error injected into every launch's output at one element: the port
    and JAX name the same (problem, row, col) for each bucket."""
    orig_t, orig_j = harness.make_launcher, jax_harness.make_launcher

    def port_launcher(scheme):
        fn = orig_t(scheme)

        def run(ops):
            out = fn(ops).clone()
            r = min(70, out.shape[0] - 1)
            out[r, 5] += 100.0
            return out
        return run

    def jax_launcher(scheme, tile, interpret=False):
        fn = orig_j(scheme, tile, interpret=interpret)

        def run(ops):
            out = fn(ops)
            r = min(70, out.shape[0] - 1)
            return out.at[r, 5].add(100.0)
        return run

    monkeypatch.setattr(harness, "make_launcher", port_launcher)
    monkeypatch.setattr(jax_harness, "make_launcher", jax_launcher)
    got, ref = io.StringIO(), io.StringIO()
    with redirect_stdout(got):
        assert not harness.run_check(GROUPED_WL, tol=1.0, device="cpu")
    with redirect_stdout(ref):
        assert not jax_harness.run_check(GROUPED_WL, tol=1.0, interpret=True)
    assert _mismatch_lines(got.getvalue()) == _mismatch_lines(ref.getvalue())
    assert ("1", "70", "5") in _mismatch_lines(got.getvalue())


def test_fused_ab_bucketed_equals_fused_and_the_reference():
    c_j = jax_fused_ab.build_case(m_total=256, k=128, n=128, e=6, interpret=True)
    lhs = torch.from_numpy(np.array(c_j["lhs"].astype(jnp.float32))).to(torch.bfloat16)
    wq = torch.from_numpy(np.array(c_j["wq"]))
    wsc = torch.from_numpy(np.array(c_j["wsc"]))
    c_t = fused_ab.make_case(lhs, wq, wsc, c_j["sizes"], c_j["n_wo"])
    assert c_t["m_wo"] == c_j["m_wo"]
    np.testing.assert_array_equal(c_t["aq"].numpy(), np.asarray(c_j["aq"]))
    np.testing.assert_array_equal(c_t["asc"].numpy(), np.asarray(c_j["asc"]))
    np.testing.assert_array_equal(c_t["flags"].numpy(), np.asarray(c_j["flags"]))
    bucketed, fused = fused_ab.bucketed_step(c_t), fused_ab.fused_step(c_t)
    assert torch.equal(bucketed, fused)
    for got, step in ((bucketed, jax_fused_ab.bucketed_step),
                      (fused, jax_fused_ab.fused_step)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(step(c_j).astype(jnp.float32)))
    # the port's own draw: the same group sizes, bucketed = fused
    c = fused_ab.build_case(256, k=128, n=128, e=6, device="cpu")
    assert c["sizes"] == c_j["sizes"]
    assert torch.equal(fused_ab.bucketed_step(c), fused_ab.fused_step(c))


def test_model_registry_equals_the_reference():
    assert list(config.MODEL_REGISTRY) == list(jax_config.MODEL_REGISTRY)
    for name, spec in jax_config.MODEL_REGISTRY.items():
        assert dataclasses.asdict(config.get_model_spec(name)) == dataclasses.asdict(spec)
    with pytest.raises(KeyError, match="known"):
        config.get_model_spec("gpt2")
    for d in ("GATE_TRACE_DIR", "CALIB_LOSS_DIR", "PERF_TABLE_DIR", "QCONFIG_DIR",
              "WORKLOAD_DIR", "BENCH_DIR"):
        assert (getattr(config, d).relative_to(config.ARTIFACT_DIR)
                == getattr(jax_config, d).relative_to(jax_config.ARTIFACT_DIR))


def test_setup_logger_writes_a_tagged_file(tmp_path):
    log = port_logging.setup_logger("mxmoe_test_logger", log_dir=str(tmp_path), tag="run")
    log.info("hello")
    assert port_logging.setup_logger("mxmoe_test_logger") is log
    assert port_logging.init_logger("mxmoe_test_logger") is log
    for h in log.handlers:
        h.flush()
    files = list(tmp_path.glob("run_*.log"))
    assert len(files) == 1 and "hello" in files[0].read_text()
    for h in list(log.handlers):
        log.removeHandler(h)
        h.close()
    assert log.level == logging.INFO and not log.propagate


def test_setup_logger_moves_to_the_next_run(tmp_path):
    """A second run in one process logs into its own directory and to the
    stdout of its own call, not into the first run's."""
    first, second = tmp_path / "a", tmp_path / "b"
    buf_a, buf_b = io.StringIO(), io.StringIO()
    with redirect_stdout(buf_a):
        port_logging.setup_logger("mxmoe_test_rerun", log_dir=str(first), tag="run").info("one")
    with redirect_stdout(buf_b):
        log = port_logging.setup_logger("mxmoe_test_rerun", log_dir=str(second), tag="run")
        log.info("two")
    try:
        (fa,), (fb,) = list(first.glob("run_*.log")), list(second.glob("run_*.log"))
        assert "one" in fa.read_text() and "two" not in fa.read_text()
        assert "two" in fb.read_text() and "one" not in fb.read_text()
        assert "two" in buf_b.getvalue() and "two" not in buf_a.getvalue()
        assert sum(isinstance(h, logging.FileHandler) for h in log.handlers) == 1
    finally:
        for h in list(log.handlers):
            log.removeHandler(h)
            h.close()


def test_run_mxmoe_canonical_trace_needs_qwen2_moe(tmp_path):
    """The canonical trace is qwen2_moe's: another model must bring its own."""
    from mxmoe_tpu_torch import run_mxmoe

    with pytest.raises(SystemExit) as e:
        run_mxmoe.main(["--model", "mixtral", "--qstr", "w8a8_g-1_sym",
                        "--out_dir", str(tmp_path)])
    assert e.value.code == 2


def _rounds(coef, noise, rng, rounds=5, c0=0.012):
    """Synthetic K4 decode timings: the bytes model plus a constant, the
    packed elements' cost ``coef`` ms an element, and relative noise."""
    elems = (0.0, 86507520.0, 173015040.0)
    bytes_ms = (0.0916, 0.0687, 0.0459)
    out = []
    for _ in range(rounds):
        out.append([{"w4_frac": f, "packed_elems": x, "bytes_model_ms": b,
                     "measured_ms": (b + c0 + coef * x) * (1 + noise * rng.standard_normal())}
                    for f, x, b in zip((0.0, 0.5, 1.0), elems, bytes_ms)])
    return out


def test_unpack_fit_flat_slope_is_unresolved():
    fit = onelaunch_fit.fit_unpack(_rounds(0.0, 0.03, np.random.default_rng(0)))
    assert fit["resolved"] is False and fit["unpack_gops"] == 0.0
    assert len(fit["slopes_ms_per_elem"]) == 5 and fit["slope_spread"] > 0
    assert [r["w4_frac"] for r in fit["rows"]] == [0.0, 0.5, 1.0]


def test_unpack_fit_recovers_a_clear_slope():
    coef = 1e-6 / 2000.0            # 2000 Gelem/s: 0.0865 ms at 173 M elements
    fit = onelaunch_fit.fit_unpack(_rounds(coef, 0.01, np.random.default_rng(1)))
    assert fit["resolved"] is True
    assert abs(fit["unpack_gops"] - 2000.0) / 2000.0 < 0.05
    assert all(abs(r["residual_ms"]) < 0.01 for r in fit["rows"])


def test_slice_modules_import_no_jax():
    """The eval and bench modules of this slice import neither jax nor the
    JAX package."""
    import os
    import subprocess
    import sys

    mods = ["mxmoe_tpu_torch.config", "mxmoe_tpu_torch.utils.logging",
            "mxmoe_tpu_torch.eval", "mxmoe_tpu_torch.eval.evaluator",
            "mxmoe_tpu_torch.eval.run", "mxmoe_tpu_torch.eval.anchor",
            "mxmoe_tpu_torch.bench.workload_gen", "mxmoe_tpu_torch.bench.harness",
            "mxmoe_tpu_torch.bench.fused_ab", "mxmoe_tpu_torch.run_mxmoe"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'mxmoe_tpu', 'optax'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert res.returncode == 0, res.stderr
