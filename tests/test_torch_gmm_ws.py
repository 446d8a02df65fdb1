"""Port parity for the weight-stationary schedule (K15, ``gmm_w8a8_ws`` /
``gmm_w4a8_packed_ws``) and the in-launch activation quant (K14,
``gmm_w8a8_fusedquant``): their plain versions against the JAX kernels in
interpret mode on the reference tests' setups
(``tests/test_pallas_gmm.py:393-439`` and ``:255``).

Tolerances: K15 is exact: its plain version is bitwise the JAX kernels
(int32 sums, the same f32 epilogue) and bitwise K2's / K5's plain versions.
K14 computes K1 + K2 bit for bit (the scale a true division by upper, as
K1). The JAX kernel divides by its Python constant inside the traced body,
and in interpret mode XLA multiplies by f32(1/upper) instead: its scales
sit an ulp from K1's on some rows. That reading is pinned here (K1 + K2 with
the scale multiplied by f32(1/upper) is bitwise the JAX kernel, and those
scales differ from K1's on some rows), and the port's K14 stands within the
reference test's 1e-5 of the JAX kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.ops import pallas_gmm
from mxmoe_tpu.quant.packing import pack_int4_halves as jax_pack
from mxmoe_tpu_torch.ops import act_quant, gmm_w8a8_fusedquant as gfq, gmm_ws, kernels
from mxmoe_tpu_torch.ops.gmm_w4a8_packed import gmm_w4a8_packed
from mxmoe_tpu_torch.ops.gmm_w8a8 import gmm_w8a8, grouped_int8_plain
from mxmoe_tpu_torch.quant.packing import pack_int4_halves


def _operands(sizes, k, n, hi_a, hi_w, seed):
    rng = np.random.default_rng(seed)
    m, e = sum(sizes), len(sizes)
    aq = rng.integers(-hi_a, hi_a + 1, (m, k)).astype(np.int8)
    asc = rng.uniform(0.01, 0.02, (m, 1)).astype(np.float32)
    wq = rng.integers(-hi_w - (hi_w == 7), hi_w + 1, (e, k, n)).astype(np.int8)
    wsc = rng.uniform(0.01, 0.02, (e, 1, n)).astype(np.float32)
    return aq, asc, wq, wsc


@pytest.mark.parametrize("bm,sizes", [(16, (32, 16, 0, 64, 16)),   # the reference's
                                      (32, (64, 0, 32, 96))])
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_ws_int8_bitwise_jax_and_k2(bm, sizes, out):
    aq, asc, wq, wsc = _operands(sizes, 64, 256, 127, 127, seed=11)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[out]
    ref = pallas_gmm.gmm_w8a8_ws(jnp.asarray(aq), jnp.asarray(asc), jnp.asarray(wq),
                                 jnp.asarray(wsc), sizes, bm=bm, bn=128,
                                 out_dtype=jdt, interpret=True)
    t = [torch.from_numpy(v) for v in (aq, asc, wq, wsc)]
    kernels.reset_launch_counts()
    got = gmm_ws.gmm_w8a8_ws(*t, sizes, bm=bm, out_dtype=tdt)
    assert kernels.launches["gmm_ws"] == 0
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    k2 = gmm_w8a8(*t, torch.tensor(sizes, dtype=torch.int32), out_dtype=tdt)
    assert torch.equal(got, k2)


def test_ws_packed_bitwise_jax_and_k5():
    sizes, bm = (16, 48, 32), 16
    aq, asc, q4, wsc = _operands(sizes, 64, 256, 7, 7, seed=12)
    ref = pallas_gmm.gmm_w4a8_packed_ws(
        jnp.asarray(aq), jnp.asarray(asc), jax_pack(jnp.asarray(q4)), jnp.asarray(wsc),
        sizes, bm=bm, bn=128, interpret=True)
    packed = pack_int4_halves(torch.from_numpy(q4))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_pack(jnp.asarray(q4))))
    a, s, w = (torch.from_numpy(v) for v in (aq, asc, wsc))
    got = gmm_ws.gmm_w4a8_packed_ws(a, s, packed, w, sizes, bm=bm)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    k5 = gmm_w4a8_packed(a, s, packed, w, torch.tensor(sizes, dtype=torch.int32))
    assert torch.equal(got, k5)


def test_ws_checks_the_static_layout():
    aq, asc, wq, wsc = (torch.from_numpy(v) for v in
                        _operands((32, 16), 64, 128, 127, 127, seed=1))
    with pytest.raises(ValueError, match="multiples of bm"):
        gmm_ws.gmm_w8a8_ws(aq, asc, wq, wsc, (40, 8), bm=16)
    with pytest.raises(ValueError, match="sum"):
        gmm_ws.gmm_w8a8_ws(aq, asc, wq, wsc, (32, 32), bm=16)


def _fq_case(seed=13, m=128, k=256, n=128, sizes=(48, 0, 64)):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    wq = rng.integers(-127, 128, (len(sizes), k, n)).astype(np.int8)
    wsc = rng.uniform(0.01, 0.02, (len(sizes), 1, n)).astype(np.float32)
    return a, wq, wsc, np.asarray(sizes, np.int32)


def test_fusedquant_jax_reading_is_the_reciprocal():
    a, wq, wsc, gs = _fq_case()
    ref = np.asarray(pallas_gmm.gmm_w8a8_fusedquant(
        jnp.asarray(a), jnp.asarray(wq), jnp.asarray(wsc), jnp.asarray(gs), bm=32,
        bn=128, out_dtype=jnp.float32, interpret=True))
    t = [torch.from_numpy(v) for v in (a, wq, wsc, gs)]
    amax = torch.clamp(t[0].abs().amax(-1, keepdim=True), min=1e-8)
    s_rec = amax * torch.tensor(1.0 / 127.0, dtype=torch.float32)
    recip = grouped_int8_plain(torch.round(t[0] / s_rec).to(torch.int8), s_rec,
                               lambda e: t[1][e], t[2], t[3], torch.float32)
    rows = int(gs.sum())
    np.testing.assert_array_equal(recip.numpy()[:rows], ref[:rows])
    # the port's reading is K1's true division: an ulp apart on some rows
    _, s_div = act_quant.quantize_rows_uniform(t[0], 8)
    assert 0 < int((s_div != s_rec).sum()) < rows
    got = gfq.gmm_w8a8_fusedquant(*t, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy()[:rows], ref[:rows], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("a_bits", [8, 4])
def test_fusedquant_plain_bitwise_k1_plus_k2(dtype, a_bits):
    a, wq, wsc, gs = _fq_case(seed=a_bits)
    x = torch.from_numpy(a).to(dtype)
    w, s, g = torch.from_numpy(wq), torch.from_numpy(wsc), torch.from_numpy(gs)
    got = gfq.gmm_w8a8_fusedquant(x, w, s, g, a_bits=a_bits)
    aq, asc = act_quant.quantize_rows_uniform(x, a_bits)
    assert torch.equal(got, gmm_w8a8(aq, asc, w, s, g))
    assert bool(got[int(gs.sum()):].eq(0).all())
