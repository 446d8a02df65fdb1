"""Port parity for the whole expert FFN in one launch: the plain versions of
K12 (``gmm_ffn_w8a8``) and K13 (``gmm_ffn_mixed_packed``) against the JAX
kernels in interpret mode, on the reference test's setup
(``tests/test_pallas_gmm.py::test_gmm_ffn_matches_two_launch``: 5 experts,
K 256, N 256, H 256, aligned sizes with an empty expert, per-expert down
bits 4 / 8 / 8 / 4 / 6).

Tolerances: against the f32 oracle (the same int dots and scale algebra,
h in f32, through dense float matmuls), 2e-4 as the reference holds its
kernel; against the two-launch path (K2 -> bf16 -> SwiGLU -> K1 -> K2, which
rounds h to bf16 on the way), the reference's bounds on |d|: mean < 1e-2,
p99 < 8e-2, max < 0.3. Against the JAX kernel itself: XLA's CPU sigmoid and
torch's differ in the last bits, which moves a row's amax, and with it its
requant scale, by an ulp now and then (read: 0.5 % of the outputs differ, by
at most 1.2e-7), and could move a code by one step on a knife edge. So the
outputs agree within 5e-3 absolute (a flipped 4-bit code moves an output by
about scale * |w| ~ 2e-3 here) and exactly on all but 2 % of them. K13's plain
version is bitwise K12's on the equivalent int8 codes, as the reference
claims of its kernels, for a layer with no expert packed, every other
expert packed, and all packed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.ops import pallas_gmm
from mxmoe_tpu.quant import packing as jax_packing
from mxmoe_tpu.quant.qparams import quantize_act_per_row_bits as jax_qrows
from mxmoe_tpu_torch.models.layers import silu_mul
from mxmoe_tpu_torch.ops import act_quant, gmm_ffn, kernels
from mxmoe_tpu_torch.ops.gmm import gmm_dense_reference
from mxmoe_tpu_torch.ops.gmm_w8a8 import gmm_w8a8
from mxmoe_tpu_torch.quant.packing import build_ragged_mixed

E, K, NH, HOUT = 5, 256, 256, 256
SIZES = [64, 0, 32, 64, 32]
BITS_DOWN = [4, 8, 8, 4, 6]
M = 192 + 32          # rows past sum(SIZES): the aligned layout's tail


def _setup(seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)

    def qw(w):
        sc = (np.abs(w).max(axis=1, keepdims=True) / np.float32(127.0)).astype(np.float32)
        return np.round(w / sc).astype(np.int8), sc

    wgu_q, wgu_sc = qw((rng.standard_normal((E, K, 2 * NH)) * 0.05).astype(np.float32))
    wd_q, wd_sc = qw((rng.standard_normal((E, NH, HOUT)) * 0.05).astype(np.float32))
    aq, asc = jax_qrows(jnp.asarray(x), jnp.full((M,), 8.0))
    return dict(aq=np.array(aq), asc=np.array(asc), wgu_q=wgu_q, wgu_sc=wgu_sc,
                wd_q=wd_q, wd_sc=wd_sc)


@pytest.fixture(scope="module")
def case():
    d = _setup()
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    gs = torch.tensor(SIZES, dtype=torch.int32)
    bits = torch.tensor(BITS_DOWN, dtype=torch.int32)
    got = gmm_ffn.gmm_ffn_w8a8(t["aq"], t["asc"], t["wgu_q"], t["wgu_sc"], t["wd_q"],
                               t["wd_sc"], gs, act_bits_down=bits,
                               out_dtype=torch.float32)
    return d, t, gs, bits, got


def _jax_ffn(d, out_dtype=jnp.float32):
    return np.asarray(pallas_gmm.gmm_ffn_w8a8(
        jnp.asarray(d["aq"]), jnp.asarray(d["asc"]), jnp.asarray(d["wgu_q"]),
        jnp.asarray(d["wgu_sc"]), jnp.asarray(d["wd_q"]), jnp.asarray(d["wd_sc"]),
        jnp.asarray(SIZES, jnp.int32), act_bits_down=jnp.asarray(BITS_DOWN, jnp.int32),
        bm=32, out_dtype=out_dtype, interpret=True))


def test_plain_k12_vs_f32_oracle(case):
    _, t, gs, bits, got = case
    kernels.reset_launch_counts()
    rows = sum(SIZES)
    assert got.shape == (M, HOUT) and bool(got[rows:].eq(0).all())
    row_expert = torch.repeat_interleave(torch.arange(E), gs.long())
    gu = gmm_dense_reference(t["aq"].float() * t["asc"],
                             t["wgu_q"].float() * t["wgu_sc"], gs)
    h = gu[:, :NH] * torch.sigmoid(gu[:, :NH]) * gu[:, NH:]
    hq, hsc = act_quant.quantize_rows_plain(h[:rows], bits[row_expert].float())
    oracle = gmm_dense_reference(hq.float() * hsc, t["wd_q"].float() * t["wd_sc"], gs)
    np.testing.assert_allclose(got[:rows].numpy(), oracle.numpy(), rtol=2e-4, atol=2e-4)
    assert sum(kernels.launches.values()) == 0


def test_plain_k12_vs_two_launch_bounds(case):
    _, t, gs, bits, got = case
    rows = sum(SIZES)
    row_expert = torch.repeat_interleave(torch.arange(E), gs.long())
    h = silu_mul(gmm_w8a8(t["aq"], t["asc"], t["wgu_q"], t["wgu_sc"], gs,
                          out_dtype=torch.bfloat16))[:rows]
    hq, hsc = act_quant.quantize_rows(h, bits[row_expert].float())
    ref = gmm_w8a8(hq, hsc, t["wd_q"], t["wd_sc"], gs, out_dtype=torch.float32)
    d = (got[:rows] - ref).abs().numpy()
    assert d.mean() < 1e-2, d.mean()
    assert np.quantile(d, 0.99) < 8e-2, np.quantile(d, 0.99)
    assert d.max() < 0.3, d.max()


def test_plain_k12_vs_jax_kernel(case):
    d, _, _, _, got = case
    rows = sum(SIZES)
    ref = _jax_ffn(d)[:rows]
    diff = np.abs(got[:rows].numpy() - ref)
    assert diff.max() <= 5e-3, diff.max()
    assert (diff != 0).mean() < 0.02, (diff != 0).mean()


@pytest.mark.parametrize("label,pf", [("none packed", [0] * E),
                                      ("alternating", [1, 0, 1, 0, 1]),
                                      ("all packed", [1] * E)])
def test_plain_k13_bitwise_plain_k12(label, pf):
    """Equivalent codes: the packed experts' codes clipped to the 4-bit range
    in both storages."""
    d = _setup(seed=3)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    for name in ("wgu_q", "wd_q"):
        for e in range(E):
            if pf[e]:
                t[name][e].clamp_(-8, 7)
    gs = torch.tensor(SIZES, dtype=torch.int32)
    bits = torch.tensor(BITS_DOWN, dtype=torch.int32)
    gu_cat, gu_blk = build_ragged_mixed(t["wgu_q"], pf)
    d_cat, d_blk = build_ragged_mixed(t["wd_q"], pf)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    for out_dtype in (torch.float32, torch.bfloat16):
        k12 = gmm_ffn.gmm_ffn_w8a8(t["aq"], t["asc"], t["wgu_q"], t["wgu_sc"],
                                   t["wd_q"], t["wd_sc"], gs, bits, out_dtype)
        k13 = gmm_ffn.gmm_ffn_mixed_packed(
            t["aq"], t["asc"], gu_cat, t["wgu_sc"], i32(pf), i32(gu_blk), d_cat,
            t["wd_sc"], i32(pf), i32(d_blk), gs, bits, out_dtype)
        assert torch.equal(k12, k13), label


def test_plain_k13_vs_jax_kernel():
    """The reference's own K13 test setup (every other expert packed) against
    the JAX kernel in interpret mode, and the ragged buffers equal."""
    d = _setup(seed=3)
    pf = np.array([1, 0, 1, 0, 1], np.int64)
    for name in ("wgu_q", "wd_q"):
        d[name] = np.where(pf[:, None, None] == 1, np.clip(d[name], -8, 7), d[name])
    gu_cat_j, gu_blk = jax_packing.build_ragged_mixed(jnp.asarray(d["wgu_q"]), pf)
    d_cat_j, d_blk = jax_packing.build_ragged_mixed(jnp.asarray(d["wd_q"]), pf)
    gu_cat, gu_blk_t = build_ragged_mixed(torch.from_numpy(d["wgu_q"]), pf.tolist())
    d_cat, d_blk_t = build_ragged_mixed(torch.from_numpy(d["wd_q"]), pf.tolist())
    np.testing.assert_array_equal(gu_cat.numpy(), np.asarray(gu_cat_j))
    np.testing.assert_array_equal(d_cat.numpy(), np.asarray(d_cat_j))
    assert list(gu_blk_t) == list(gu_blk) and list(d_blk_t) == list(d_blk)
    pfj = jnp.asarray(pf, jnp.int32)
    ref = np.asarray(pallas_gmm.gmm_ffn_mixed_packed(
        jnp.asarray(d["aq"]), jnp.asarray(d["asc"]), gu_cat_j, jnp.asarray(d["wgu_sc"]),
        pfj, jnp.asarray(gu_blk, jnp.int32), d_cat_j, jnp.asarray(d["wd_sc"]), pfj,
        jnp.asarray(d_blk, jnp.int32), jnp.asarray(SIZES, jnp.int32),
        act_bits_down=jnp.asarray(BITS_DOWN, jnp.int32), bm=32,
        out_dtype=jnp.float32, interpret=True))
    i32 = lambda v: torch.tensor(list(v), dtype=torch.int32)
    got = gmm_ffn.gmm_ffn_mixed_packed(
        torch.from_numpy(d["aq"]), torch.from_numpy(d["asc"]), gu_cat,
        torch.from_numpy(d["wgu_sc"]), i32(pf), i32(gu_blk_t), d_cat,
        torch.from_numpy(d["wd_sc"]), i32(pf), i32(d_blk_t),
        torch.tensor(SIZES, dtype=torch.int32),
        torch.tensor(BITS_DOWN, dtype=torch.int32), torch.float32)
    rows = sum(SIZES)
    diff = np.abs(got[:rows].numpy() - ref[:rows])
    assert diff.max() <= 5e-3, diff.max()
    assert (diff != 0).mean() < 0.02, (diff != 0).mean()


def test_default_down_bits_are_eight(case):
    _, t, gs, _, _ = case
    a = gmm_ffn.gmm_ffn_w8a8(t["aq"], t["asc"], t["wgu_q"], t["wgu_sc"], t["wd_q"],
                             t["wd_sc"], gs)
    b = gmm_ffn.gmm_ffn_w8a8(t["aq"], t["asc"], t["wgu_q"], t["wgu_sc"], t["wd_q"],
                             t["wd_sc"], gs, torch.full((E,), 8, dtype=torch.int32))
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
