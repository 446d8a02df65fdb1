"""Port parity for the headline MoE-layer bench (``mxmoe_tpu_torch.bench``,
the counterpart of the root ``bench.py``): the workload data equal to the
JAX package's, and the port's weight preparation of the two mixed arms
bitwise the reference's ``_quantize_weights_mixed_onelaunch`` /
``_quantize_weights_mixed`` on a tiny workload, from the same numpy
operands (rows, padding, expert order, codes, scales, packed bytes, row
bits and sizes; every value exact)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as bench_mod
from mxmoe_tpu.bench import workloads as jax_workloads
from mxmoe_tpu_torch.bench import headline, workloads

BM = bench_mod.BENCH_BM


def _fields(wl):
    return {f: getattr(wl, f) for f in ("name", "group_sizes", "k", "n", "shared_m",
                                        "shared_k", "shared_n")}


def test_workload_data_equal():
    assert workloads.QWEN2_MOE_L10_BS8192_ROUTED_M == \
        jax_workloads.QWEN2_MOE_L10_BS8192_ROUTED_M
    for got, want in zip(workloads.qwen2_moe_l10_bs8192(),
                         jax_workloads.qwen2_moe_l10_bs8192()):
        assert _fields(got) == _fields(want)
        assert (got.flops, got.m_total, got.num_experts) == \
            (want.flops, want.m_total, want.num_experts)
    total = sum(wl.flops for wl in workloads.qwen2_moe_l10_bs8192())
    assert abs(total / 1e12 - 1.134) < 1e-3


def _operands(seed=0):
    """Two tiny workloads (one without a shared expert) as numpy bf16-exact
    f32 values, for both packages."""
    rng = np.random.default_rng(seed)
    wls = [workloads.GroupGemmWorkload("t0", (40, 24, 0, 8, 72, 56), k=128, n=128,
                                       shared_m=16, shared_k=128, shared_n=64),
           workloads.GroupGemmWorkload("t1", (3, 130, 5, 0), k=256, n=64)]
    ops = []
    for wl in wls:
        def u(shape):
            return torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(
                torch.bfloat16)
        shared = ((u((wl.shared_m, wl.shared_k)), u((wl.shared_k, wl.shared_n)))
                  if wl.shared_m else None)
        ops.append((u((wl.m_total, wl.k)), u((wl.num_experts, wl.k, wl.n)),
                    torch.tensor(wl.group_sizes, dtype=torch.int32), shared))
    return ops


def _to_jax(ops):
    def j(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return [(j(lhs), j(rhs), jnp.asarray(gs.numpy()),
             None if sh is None else (j(sh[0]), j(sh[1]))) for lhs, rhs, gs, sh in ops]


def _equal(got, want, what):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32)
                      if getattr(want, "dtype", None) == jnp.bfloat16 else want)
    got = got.float().numpy() if torch.is_tensor(got) and got.dtype == torch.bfloat16 \
        else (got.numpy() if torch.is_tensor(got) else np.asarray(got))
    np.testing.assert_array_equal(got, want, err_msg=what)


def _masks(ops):
    return [np.arange(len(op[2])) % 2 == 0 for op in ops]


def test_onelaunch_weights_bitwise_reference():
    ops = _operands()
    want = bench_mod._quantize_weights_mixed_onelaunch(_to_jax(ops), _masks(ops))
    got = headline.quantize_weights_mixed_onelaunch(ops, _masks(ops), BM)
    for g, w in zip(got, want):
        assert g["gs"] == w["gs"]
        for key in ("lhs", "wq", "wsc", "bits"):
            _equal(g[key], w[key], key)
        assert (g["shared"] is None) == (w["shared"] is None)
        if g["shared"] is not None:
            for a, b, what in zip(g["shared"], w["shared"], ("x", "codes", "scale")):
                _equal(a, b, f"shared {what}")


def test_bucketed_weights_bitwise_reference():
    ops = _operands(1)
    want = bench_mod._quantize_weights_mixed(_to_jax(ops), _masks(ops))
    got = headline.quantize_weights_mixed(ops, _masks(ops), BM)
    for g, w in zip(got, want):
        assert (g["m4"], g["gs4"], g["gs8"]) == (w["m4"], w["gs4"], w["gs8"])
        for key in ("lhs", "q4p", "sc4", "q8", "sc8"):
            _equal(g[key], w[key], key)
        if g["shared"] is not None:
            for a, b, what in zip(g["shared"], w["shared"], ("x", "codes", "scale")):
                _equal(a, b, f"shared {what}")


def test_headline_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        headline.main([])


def test_bound_is_the_workloads_one_number_per_mode():
    """The bound comes from the workload in the mode's storage, the same for
    every arm of that mode (one launch, --bucketed, --no-ws): at the recorded
    routed counts it is operations-bound at the int8 dense peak."""
    wls = workloads.qwen2_moe_l10_bs8192()
    m = sum(workloads.QWEN2_MOE_L10_BS8192_ROUTED_M)
    assert m == 32762
    assert all(x > 0 for x in workloads.QWEN2_MOE_L10_BS8192_ROUTED_M)
    # gate_up (K 2048, N 2816) and down (K 1408, N 2048), 60 experts, 30 of
    # them 4-bit in the mixed storage; the shared expert int8, 8192 rows
    mixed = (2 * m * 2048 + 2 * m * 2816 + 30 * 2048 * 2816 // 2 + 30 * 2048 * 2816
             + 60 * 4 * 2816 + 2 * 8192 * 2048 + 2048 * 11264 + 4 * 11264
             + 2 * 8192 * 11264
             + 2 * m * 1408 + 2 * m * 2048 + 30 * 1408 * 2048 // 2 + 30 * 1408 * 2048
             + 60 * 4 * 2048 + 2 * 8192 * 5632 + 5632 * 2048 + 4 * 2048
             + 2 * 8192 * 2048)
    w8a8 = mixed + 30 * 2048 * 2816 // 2 + 30 * 1408 * 2048 // 2
    assert headline.workload_bytes(wls, "mixed") == mixed
    assert headline.workload_bytes(wls, "w8a8") == w8a8
    flops = sum(wl.flops for wl in wls)
    assert w8a8 / 3.35e12 < flops / 1979e12          # operations-bound
    for mode in ("mixed", "w8a8"):
        tflops, kind = headline.workload_bound(wls, mode)
        assert kind == "operations" and tflops == pytest.approx(1979.0, rel=1e-12)
    # a decode-sized workload is bytes-bound, and 4-bit experts lower it
    small = [workloads.GroupGemmWorkload("s", (4,) * 60, k=2048, n=2816)]
    (t_mixed, k_mixed), (t_w8, k_w8) = (headline.workload_bound(small, md)
                                        for md in ("mixed", "w8a8"))
    assert k_mixed == k_w8 == "bytes" and t_mixed > t_w8


@pytest.mark.parametrize("mode", ["mixed", "w8a8"])
def test_bound_is_the_same_for_every_arm(monkeypatch, mode):
    """main() reports the workload's bound whatever the arm: with the timing
    and the arms stubbed (no card here), every arm's line carries one
    bound_tflops, and it is ``workload_bound``'s."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "stub")
    monkeypatch.setattr(headline, "build_fp_operands", lambda *a, **k: None)
    monkeypatch.setattr(headline, "baseline_step", lambda ops: (lambda: []))
    monkeypatch.setattr(headline, "make_arm",
                        lambda args, ops: ((lambda: []), "arm"))
    monkeypatch.setattr(headline, "time_ms", lambda fn: 1.0)
    monkeypatch.setattr(torch, "Generator",
                        lambda device=None: types.SimpleNamespace(manual_seed=lambda s: None))
    arms = [[], ["--bucketed"], ["--no-ws"], ["--bucketed", "--no-ws"]]
    res = [headline.main(["--mode", mode, *argv]) for argv in arms]
    want = headline.workload_bound(workloads.qwen2_moe_l10_bs8192(), mode)
    assert {(r["bound_tflops"], r["bound_kind"]) for r in res} == {want}
