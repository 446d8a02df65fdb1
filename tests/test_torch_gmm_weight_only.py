"""Port parity: the plain versions of kernels K6 (gmm_weight_only) and K7
(gmm_weight_only_packed) against the JAX Pallas kernels in interpret mode.

Tolerances. Both packages dequantize ``q * scale + zp`` to the activations'
dtype and accumulate the product in f32, but XLA on the CPU contracts the
dequantization into one FMA (the port rounds the product and the sum
separately, as the expression is written) and sums K in another order. So:

- bf16 activations and outputs (the serving path): within one bf16 ulp of
  the reference element (read: two elements of 5632 differ, by one ulp);
- f32 activations and outputs: within ``accumulation_bound`` (K * 2^-24 *
  sum|lhs||w|, the f32 summation error of either order) plus the weights' f32
  rounding difference, 2^-22 * sum|lhs||w| (one f32 ulp per weight);
- the plain version against a float64 product of the same dequantized
  weights: within ``error_over_bound``'s tolerance (``accumulation_bound``,
  + 1 bf16 ulp for a bf16 output), and a mutated reference (one k-group's
  zero point dropped, or one group's scale taken from its neighbour) breaks
  it;
- packed against int8-stored codes within the port: bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.ops import pallas_gmm
from mxmoe_tpu.quant import packing as jp
from mxmoe_tpu_torch.ops import gmm_weight_only as wo
from mxmoe_tpu_torch.ops import kernels
from mxmoe_tpu_torch.ops.gmm_weight_only_packed import (
    gmm_weight_only_packed, gmm_weight_only_packed_plain)
from mxmoe_tpu_torch.quant import packing as tp

T = torch.from_numpy


def _operands(seed, sizes, k, n, gsize, bits=4, sym=False):
    rng = np.random.default_rng(seed)
    m, e = int(sum(sizes)), len(sizes)
    g = 1 if gsize == -1 else k // gsize
    hi = 1 << (bits - 1)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wq = rng.integers(-hi, hi, (e, k, n), dtype=np.int8)
    sc = (rng.random((e, g, n)) * 0.02 + 1e-3).astype(np.float32)
    zp = (np.zeros((e, g, n)) if sym
          else rng.standard_normal((e, g, n)) * 0.05).astype(np.float32)
    return x, wq, sc, zp, np.asarray(sizes, np.int32)


def _abs_product(x, wq, sc, zp, gs, gsize):
    """sum_k |lhs| |w| per output element, float64 [M, N]."""
    xt, q, s, z, g = T(x), T(wq), T(sc), T(zp), T(gs)
    gsz = x.shape[1] if gsize == -1 else gsize
    return wo.grouped_weight_only_plain(
        xt.abs(), lambda e: wo.dequantize_expert(q[e], s[e], z[e], gsz,
                                                 torch.float32).abs(),
        wq.shape[-1], g, torch.float64, torch.float64).numpy()


CASES = [
    # straddling groups, empty experts, K = 384: its half is no multiple of g
    ([5, 0, 19, 8, 0, 12], 384, 128, 128),
    ([5, 0, 19, 8, 0, 12], 384, 128, -1),
    # decode shape: one row per expert, many empty experts
    ([1, 0, 1, 1, 0, 0, 1, 0], 256, 64, 128),
    # E = 1, the shared expert's launch
    ([7], 384, 32, 128),
]


@pytest.mark.parametrize("sizes,k,n,gsize", CASES)
@pytest.mark.parametrize("sym", [True, False], ids=["sym", "asym"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_weight_only_and_packed_vs_jax(sizes, k, n, gsize, sym, dtype):
    x, wq, sc, zp, gs = _operands(k + n + len(sizes), sizes, k, n, gsize, sym=sym)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj, xt = jnp.asarray(x).astype(jdt), T(x).to(tdt)
    g = k if gsize == -1 else gsize
    args = (jnp.asarray(sc), jnp.asarray(zp), jnp.asarray(gs))
    ref = pallas_gmm.gmm_weight_only(xj, jnp.asarray(wq), *args, gsize=g, bm=16,
                                     bn=32, out_dtype=jdt, interpret=True)
    ref_p = pallas_gmm.gmm_weight_only_packed(
        xj, jp.pack_int4_halves(jnp.asarray(wq)), *args, gsize=g, bm=16, bn=32,
        out_dtype=jdt, interpret=True)
    kernels.reset_launch_counts()
    got = wo.gmm_weight_only(xt, T(wq), T(sc), T(zp), T(gs), gsize, out_dtype=tdt)
    got_p = gmm_weight_only_packed(xt, tp.pack_int4_halves(T(wq)), T(sc), T(zp),
                                   T(gs), gsize, out_dtype=tdt)
    assert kernels.launches["gmm_weight_only"] == 0      # CPU: the plain versions
    assert kernels.launches["gmm_weight_only_packed"] == 0
    assert torch.equal(got, got_p)
    for r in (ref, ref_p):
        r = np.asarray(r.astype(jnp.float32))
        d = np.abs(got.float().numpy() - r)
        if dtype == "bfloat16":
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(r), 2.0 ** -126))) - 7)
            assert (d <= ulp).all()
        else:
            mag = _abs_product(x, wq, sc, zp, gs, gsize)
            assert (d <= mag * (k * 2.0 ** -24 + 2.0 ** -22)).all()


@pytest.mark.parametrize("bits", [1, 2, 3, 8])
def test_gmm_weight_only_low_bit_codes_in_int8_storage(bits):
    """w1..w3 (and w8) codes arrive in int8 storage and take K6."""
    x, wq, sc, zp, gs = _operands(bits, [4, 0, 9], 128, 32, 64, bits=max(bits, 2))
    if bits == 1:
        wq = np.clip(wq, -1, 0)
    ref = pallas_gmm.gmm_weight_only(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(wq), jnp.asarray(sc),
        jnp.asarray(zp), jnp.asarray(gs), gsize=64, bm=16, bn=32,
        out_dtype=jnp.bfloat16, interpret=True)
    got = wo.gmm_weight_only(T(x).to(torch.bfloat16), T(wq), T(sc), T(zp), T(gs), 64)
    r = np.asarray(ref.astype(jnp.float32))
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(r), 2.0 ** -126))) - 7)
    assert (np.abs(got.float().numpy() - r) <= ulp).all()


@pytest.mark.parametrize("sizes,k,n,gsize", CASES)
@pytest.mark.parametrize("mutation", ["none", "drop_zp", "shift_scale"])
def test_accumulation_bound_holds_and_catches_mutations(sizes, k, n, gsize, mutation):
    """The bound the card holds K6 / K7 to, exercised on the CPU with the
    plain f32 version in the kernel's place."""
    x, wq, sc, zp, gs = _operands(k * n, sizes, k, n, gsize)
    xt = T(x).to(torch.bfloat16)
    got = wo.gmm_weight_only_plain(xt, T(wq), T(sc), T(zp), T(gs), gsize,
                                   out_dtype=torch.float32).double()
    sc_r, zp_r = sc.copy(), zp.copy()
    g = sc.shape[1]
    if mutation == "drop_zp":
        zp_r[:, g - 1] = 0.0
    elif mutation == "shift_scale":
        # the neighbouring group's scales (the neighbouring column's when
        # there is one group)
        sc_r[:, g - 1] = sc[:, g - 2] if g > 1 else np.roll(sc[:, 0], 1, axis=-1)
    # the gate as the card's checks state it, for f32 and bf16 outputs
    for out in (got.float(), got.to(torch.bfloat16)):
        _, ratio = wo.error_over_bound(out, xt, T(wq), T(sc_r), T(zp_r), T(gs), gsize)
        assert (ratio <= 1.0) == (mutation == "none")
    packed = gmm_weight_only_packed_plain(
        xt, tp.pack_int4_halves(T(wq)), T(sc), T(zp), T(gs), gsize,
        out_dtype=torch.float32)
    assert torch.equal(packed.double(), got)


def test_weight_only_wrappers_reject_bad_group_size():
    x, wq, sc, zp, gs = _operands(0, [4], 96, 16, -1)
    with pytest.raises(ValueError, match="gsize"):
        wo.gmm_weight_only(T(x), T(wq), T(sc), T(zp), T(gs), 64)
    with pytest.raises(ValueError, match="gsize"):
        gmm_weight_only_packed(T(x), tp.pack_int4_halves(T(wq)), T(sc), T(zp),
                               T(gs), 64)
