"""Port parity: the plain versions of kernels K4 (gmm_mixed_packed) and K5
(gmm_w4a8_packed) against the JAX Pallas kernels (interpret mode) and
against the port's own gmm_w8a8 on the int8-stored codes.

Tolerances: none. The int32 accumulation is exact and the epilogue
((acc * s_a) * s_b, one rounding) is shared, so every comparison is
bitwise, in float32 and in bfloat16 outputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.ops import pallas_gmm
from mxmoe_tpu.quant import packing as jp
from mxmoe_tpu_torch.ops import kernels
from mxmoe_tpu_torch.ops.gmm_mixed_packed import gmm_mixed_packed
from mxmoe_tpu_torch.ops.gmm_w4a8_packed import gmm_w4a8_packed
from mxmoe_tpu_torch.ops.gmm_w8a8 import gmm_w8a8
from mxmoe_tpu_torch.quant import packing as tp


def _operands(seed, sizes, pflags, k, n):
    rng = np.random.default_rng(seed)
    e, m = len(sizes), sum(sizes)
    wq = np.zeros((e, k, n), np.int8)
    for ei, f in enumerate(pflags):
        hi = 8 if f else 128
        wq[ei] = rng.integers(-hi, hi, (k, n)).astype(np.int8)
    aq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    asc = rng.uniform(0.01, 0.05, (m, 1)).astype(np.float32)
    wsc = rng.uniform(0.001, 0.01, (e, 1, n)).astype(np.float32)
    return aq, asc, wq, wsc, np.asarray(sizes, np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


CASES = [
    ([40, 0, 56, 8, 72, 16], [1, 0, 1, 0, 1, 0], 128, 128),
    ([1, 0, 0, 3, 0, 0, 2, 1], [0, 1, 1, 0, 0, 1, 1, 0], 64, 256),   # decode-like
    ([130, 62], [1, 1], 96, 128),                                    # K/2 % 32 != 0
]


@pytest.mark.parametrize("sizes,pflags,k,n", CASES)
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_gmm_mixed_packed_bitwise(sizes, pflags, k, n, out):
    aq, asc, wq, wsc, gs = _operands(k + n, sizes, pflags, k, n)
    jdt, tdt = getattr(jnp, out), getattr(torch, out)
    cat_j, blk_j = jp.build_ragged_mixed(jnp.asarray(wq), pflags)
    ref = pallas_gmm.gmm_mixed_packed(
        jnp.asarray(aq), jnp.asarray(asc), cat_j, jnp.asarray(wsc),
        jnp.asarray(gs), jnp.asarray(pflags, jnp.int32),
        jnp.asarray(blk_j, jnp.int32), bm=64, bn=128, out_dtype=jdt,
        interpret=True)

    cat, blk = tp.build_ragged_mixed(torch.from_numpy(wq), pflags)
    kernels.reset_launch_counts()
    t_aq, t_asc, t_wq, t_wsc, t_gs = _t(aq, asc, wq, wsc, gs)
    got = gmm_mixed_packed(t_aq, t_asc, cat, t_wsc, t_gs,
                           torch.tensor(pflags, dtype=torch.int32),
                           torch.tensor(blk, dtype=torch.int32), out_dtype=tdt)
    assert kernels.launches["gmm_mixed_packed"] == 0     # CPU: the plain version
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    # and bitwise the int8-stored launch on the same codes
    same = gmm_w8a8(t_aq, t_asc, t_wq, t_wsc, t_gs, out_dtype=tdt)
    assert torch.equal(got, same)


@pytest.mark.parametrize("sizes,k,n", [([40, 0, 56, 8], 128, 128),
                                       ([2, 1, 0, 0, 1], 64, 384)])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_gmm_w4a8_packed_bitwise(sizes, k, n, out):
    pflags = [1] * len(sizes)
    aq, asc, wq, wsc, gs = _operands(k * n, sizes, pflags, k, n)
    jdt, tdt = getattr(jnp, out), getattr(torch, out)
    ref = pallas_gmm.gmm_w4a8_packed(
        jnp.asarray(aq), jnp.asarray(asc), jp.pack_int4_halves(jnp.asarray(wq)),
        jnp.asarray(wsc), jnp.asarray(gs), bm=64, bn=128, out_dtype=jdt,
        interpret=True)
    t_aq, t_asc, t_wq, t_wsc, t_gs = _t(aq, asc, wq, wsc, gs)
    kernels.reset_launch_counts()
    got = gmm_w4a8_packed(t_aq, t_asc, tp.pack_int4_halves(t_wq), t_wsc, t_gs,
                          out_dtype=tdt)
    assert kernels.launches["gmm_w4a8_packed"] == 0
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    assert torch.equal(got, gmm_w8a8(t_aq, t_asc, t_wq, t_wsc, t_gs, out_dtype=tdt))
    # the all-packed ragged buffer is the stacked packed array, flattened
    cat, blk = tp.build_ragged_mixed(t_wq, pflags)
    mixed = gmm_mixed_packed(t_aq, t_asc, cat, t_wsc, t_gs,
                             torch.tensor(pflags, dtype=torch.int32),
                             torch.tensor(blk, dtype=torch.int32), out_dtype=tdt)
    assert torch.equal(got, mixed)


def test_gmm_mixed_packed_flex_form_raises():
    """The flex form serves (it raised before it was ported; the name stays):
    all-zero zero points, and scales replicated over two k-groups, change
    nothing, bitwise. A group size that does not divide K still raises."""
    aq, asc, wq, wsc, gs = _operands(0, [4, 4], [1, 0], 64, 16)
    cat, blk = tp.build_ragged_mixed(torch.from_numpy(wq), [1, 0])
    t_aq, t_asc, t_wsc, t_gs = _t(aq, asc, wsc, gs)
    pf, bo = torch.tensor([1, 0], dtype=torch.int32), torch.tensor(blk, dtype=torch.int32)
    base = gmm_mixed_packed(t_aq, t_asc, cat, t_wsc, t_gs, pf, bo,
                            out_dtype=torch.float32)
    with_zp = gmm_mixed_packed(t_aq, t_asc, cat, t_wsc, t_gs, pf, bo,
                               rhs_zp=torch.zeros_like(t_wsc),
                               out_dtype=torch.float32)                 # rhs_zp
    assert torch.equal(with_zp, base)
    two = gmm_mixed_packed(t_aq, t_asc.repeat(1, 2), cat, t_wsc.repeat(1, 2, 1),
                           t_gs, pf, bo, out_dtype=torch.float32)      # [M, G], [E, G, N]
    # two half-K partial sums, each rescaled, against one: f32 rounding apart
    torch.testing.assert_close(two, base, rtol=1e-6, atol=1e-6)
    assert kernels.launches["gmm_mixed_packed_flex"] == 0
    with pytest.raises(RuntimeError):                  # 3 groups over K = 64
        gmm_mixed_packed(t_aq, t_asc.repeat(1, 3), cat, t_wsc.repeat(1, 3, 1),
                         t_gs, pf, bo)
