"""Port parity: the plain version of K4f, the flex form of ``gmm_mixed_packed``
(per-k-group scales and zero points over the ragged int8 / nibble-packed
buffer), against the JAX Pallas kernel in interpret mode (its flex body and,
where K/2 is no multiple of the group size, its straddle body) and against
the port's plain K8 on the int8-stored codes.

Tolerances. Against the port's ``gmm_w8a8_grouped`` on the unpacked codes:
bitwise (exact int32 group sums, the same f32 steps in the same group order;
that is the reference's own claim for its kernel). Against the JAX kernel:
XLA on the CPU contracts ``x * s_b + acc`` into one FMA where the port rounds
every product and sum on its own, so f32 outputs agree within 2^-21 *
max|ref| (four f32 ulps at the largest output) and bf16 outputs within one
bf16 ulp of the reference element, as for K8 itself
(test_torch_gmm_grouped.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.ops import pallas_gmm
from mxmoe_tpu.quant import packing as jp
from mxmoe_tpu_torch.ops import kernels
from mxmoe_tpu_torch.ops.gmm_mixed_packed import gmm_mixed_packed
from mxmoe_tpu_torch.ops.gmm_w8a8_grouped import gmm_w8a8_grouped
from mxmoe_tpu_torch.quant import packing as tp

T = torch.from_numpy


def _operands(seed, sizes, pflags, k, n, groups):
    rng = np.random.default_rng(seed)
    m, e = int(sum(sizes)), len(sizes)
    wq = np.zeros((e, k, n), np.int8)
    for ei, f in enumerate(pflags):
        hi = 8 if f else 128
        wq[ei] = rng.integers(-hi, hi, (k, n)).astype(np.int8)
    aq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    asc = (rng.random((m, groups)) * 0.05 + 1e-3).astype(np.float32)
    wsc = (rng.random((e, groups, n)) * 0.01 + 1e-4).astype(np.float32)
    wzp = (rng.standard_normal((e, groups, n)) * 0.02).astype(np.float32)
    return aq, asc, wq, wsc, wzp, np.asarray(sizes, np.int32)


def _assert_close_to_jax(got, ref, out):
    g = got.float().numpy()
    r = np.asarray(ref.astype(jnp.float32))
    if out == "float32":
        np.testing.assert_allclose(g, r, rtol=0, atol=2.0 ** -21 * np.abs(r).max())
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(r), 2.0 ** -126))) - 7)
        assert (np.abs(g - r) <= ulp).all()


CASES = [
    # K 192, g 64: K/2 = 96 is no multiple of g, group 1 spans the halves
    ([5, 0, 19, 8, 0, 12], [1, 0, 1, 0, 1, 0], 192, 128, 64),
    # the same K without a straddle (g 32), decode-like rows
    ([1, 0, 0, 3, 0, 0, 2, 1], [0, 1, 1, 0, 0, 1, 1, 0], 192, 128, 32),
    # K/2 a multiple of g; a layer with no packed expert, one with all packed
    ([40, 0, 24], [0, 0, 0], 256, 128, 128),
    ([40, 0, 24], [1, 1, 1], 256, 128, 64),
    # K 384, g 128: the small twin of the down projection (K 1408)
    ([9, 30, 0, 2], [1, 1, 0, 0], 384, 128, 128),
]


@pytest.mark.parametrize("sizes,pflags,k,n,gsize", CASES)
@pytest.mark.parametrize("asym", [False, True], ids=["sym", "zp"])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_gmm_mixed_packed_flex_vs_jax_and_grouped(sizes, pflags, k, n, gsize, asym, out):
    aq, asc, wq, wsc, wzp, gs = _operands(k + n + gsize, sizes, pflags, k, n, k // gsize)
    zp = wzp if asym else None
    jdt, tdt = getattr(jnp, out), getattr(torch, out)
    cat_j, blk_j = jp.build_ragged_mixed(jnp.asarray(wq), pflags)
    ref = pallas_gmm.gmm_mixed_packed(
        jnp.asarray(aq), jnp.asarray(asc), cat_j, jnp.asarray(wsc), jnp.asarray(gs),
        jnp.asarray(pflags, jnp.int32), jnp.asarray(blk_j, jnp.int32), bm=16, bn=128,
        rhs_zp=None if zp is None else jnp.asarray(zp), out_dtype=jdt, interpret=True)

    cat, blk = tp.build_ragged_mixed(T(wq), pflags)
    np.testing.assert_array_equal(cat.numpy(), np.asarray(cat_j))
    kernels.reset_launch_counts()
    got = gmm_mixed_packed(T(aq), T(asc), cat, T(wsc), T(gs),
                           torch.tensor(pflags, dtype=torch.int32),
                           torch.tensor(blk, dtype=torch.int32),
                           rhs_zp=None if zp is None else T(zp), out_dtype=tdt)
    assert all(v == 0 for v in kernels.launches.values())     # CPU: the plain version
    _assert_close_to_jax(got, ref, out)
    # bitwise the grouped launch on the int8-stored codes
    same = gmm_w8a8_grouped(T(aq), T(asc), T(wq), T(wsc), T(gs), gsize=gsize,
                            rhs_zp=None if zp is None else T(zp), out_dtype=tdt)
    assert torch.equal(got, same)


def test_flex_form_with_one_group_and_zero_points():
    """Per-channel asymmetric experts over the buffer (G = 1, rhs_zp given):
    the flex form, not K4's per-channel one."""
    sizes, pflags, k, n = [6, 0, 11], [1, 0, 1], 128, 64
    aq, asc, wq, wsc, wzp, gs = _operands(3, sizes, pflags, k, n, 1)
    cat, blk = tp.build_ragged_mixed(T(wq), pflags)
    args = (T(aq), T(asc), cat, T(wsc), T(gs), torch.tensor(pflags, dtype=torch.int32),
            torch.tensor(blk, dtype=torch.int32))
    got = gmm_mixed_packed(*args, rhs_zp=T(wzp), out_dtype=torch.float32)
    same = gmm_w8a8_grouped(T(aq), T(asc), T(wq), T(wsc), T(gs), gsize=-1,
                            rhs_zp=T(wzp), out_dtype=torch.float32)
    assert torch.equal(got, same)
    # the zero-point term is there
    assert not torch.equal(got, gmm_mixed_packed(*args, out_dtype=torch.float32))
