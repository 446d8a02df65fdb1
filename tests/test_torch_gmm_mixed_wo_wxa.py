"""Port parity: the plain version of K10 (``gmm_mixed_wo_wxa``: weight-only
and w x a experts in one grouped matmul), both bodies, against the JAX Pallas
kernel in interpret mode and against the port's own plain K2 / K8 / K6 on the
same operands.

Tolerances. Within the port, bitwise: a w x a expert's rows are plain K8's (plain
K2's when per channel), a weight-only expert's rows plain K6's. Against the JAX
kernel (f32 operands and outputs):

- w x a rows: the integer sums are exact; XLA on the CPU contracts the f32
  epilogue's ``x * s_b + acc`` into an FMA, so within 2^-21 * max|ref| (four
  f32 ulps at the largest output), as for K8 (test_torch_gmm_grouped.py). Per
  channel there is no sum to contract: bitwise.
- weight-only rows: XLA contracts the dequantization ``q * s + zp`` into an
  FMA and sums K in another order: atol 2e-5 at |out| ~ 1 (the reference's
  own tolerance for this kernel, tests/test_pallas_gmm.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.ops import pallas_gmm
from mxmoe_tpu_torch.ops import kernels
from mxmoe_tpu_torch.ops.gmm_mixed_wo_wxa import gmm_mixed_wo_wxa
from mxmoe_tpu_torch.ops.gmm_w8a8 import gmm_w8a8
from mxmoe_tpu_torch.ops.gmm_w8a8_grouped import gmm_w8a8_grouped
from mxmoe_tpu_torch.ops.gmm_weight_only import gmm_weight_only

T = torch.from_numpy


def _operands(seed, sizes, k, n, groups):
    rng = np.random.default_rng(seed)
    m, e = int(sum(sizes)), len(sizes)
    x = rng.standard_normal((m, k)).astype(np.float32)
    aq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    asc = (rng.random((m, groups)) * 0.05 + 1e-3).astype(np.float32)
    wq = rng.integers(-8, 8, (e, k, n), dtype=np.int8)
    wsc = (rng.random((e, groups, n)) * 0.01 + 1e-3).astype(np.float32)
    wzp = (rng.standard_normal((e, groups, n)) * 0.02).astype(np.float32)
    return x, aq, asc, wq, wsc, wzp, np.asarray(sizes, np.int32)


FLAGS = {"all-wxa": lambda e: [0] * e, "all-wo": lambda e: [1] * e,
         "alternating": lambda e: [i % 2 for i in range(e)]}
CASES = [
    # (sizes, K, N, gsize, zero points): gsize -1 without zero points is the
    # per-channel body, everything else the flex body
    ([5, 0, 19, 8, 0, 12], 128, 128, -1, False),
    ([1, 0, 0, 3, 0, 0, 2, 1], 256, 128, -1, False),  # decode-like, empty experts
    ([5, 0, 19, 8, 0, 12], 128, 128, -1, True),       # per-channel asymmetric
    ([5, 0, 19, 8, 0, 12], 192, 128, 64, False),
    ([5, 0, 19, 8, 0, 12], 192, 128, 64, True),
    ([1, 0, 0, 3, 0, 0, 2, 1], 256, 128, 128, False),
    ([1, 0, 0, 3, 0, 0, 2, 1], 256, 128, 128, True),
]


def _row_flags(flags, gs):
    return np.repeat(np.asarray(flags, bool), gs)


@pytest.mark.parametrize("sizes,k,n,gsize,asym", CASES)
@pytest.mark.parametrize("mix", sorted(FLAGS))
def test_gmm_mixed_wo_wxa_vs_jax_and_own_kernels(sizes, k, n, gsize, mix, asym):
    groups = 1 if gsize == -1 else k // gsize
    x, aq, asc, wq, wsc, wzp, gs = _operands(k + n + len(sizes), sizes, k, n, groups)
    flags = FLAGS[mix](len(sizes))
    zp = wzp if asym else None
    ref = np.asarray(pallas_gmm.gmm_mixed_wo_wxa(
        jnp.asarray(x), jnp.asarray(aq), jnp.asarray(asc), jnp.asarray(wq),
        jnp.asarray(wsc), jnp.asarray(flags, jnp.int32), jnp.asarray(gs), bm=16,
        bn=128, rhs_zp=None if zp is None else jnp.asarray(zp),
        out_dtype=jnp.float32, interpret=True))

    kernels.reset_launch_counts()
    tzp = None if zp is None else T(zp)
    got = gmm_mixed_wo_wxa(T(x), T(aq), T(asc), T(wq), T(wsc),
                           torch.tensor(flags, dtype=torch.int32), T(gs),
                           rhs_zp=tzp, out_dtype=torch.float32)
    assert all(v == 0 for v in kernels.launches.values())     # CPU: the plain version
    wo = _row_flags(flags, gs)
    g = got.numpy()
    if (~wo).any():
        if gsize == -1 and not asym:
            np.testing.assert_array_equal(g[~wo], ref[~wo])
        else:
            np.testing.assert_allclose(g[~wo], ref[~wo], rtol=0,
                                       atol=2.0 ** -21 * np.abs(ref[~wo]).max())
    if wo.any():
        np.testing.assert_allclose(g[wo], ref[wo], rtol=0, atol=2e-5)

    # within the port: w x a rows are K8's (K2's per channel), weight-only
    # rows K6's, bitwise
    k8 = gmm_w8a8_grouped(T(aq), T(asc), T(wq), T(wsc), T(gs), gsize=gsize,
                          rhs_zp=tzp, out_dtype=torch.float32)
    assert torch.equal(got[T(~wo)], k8[T(~wo)])
    if gsize == -1 and not asym:
        k2 = gmm_w8a8(T(aq), T(asc), T(wq), T(wsc), T(gs), out_dtype=torch.float32)
        assert torch.equal(got[T(~wo)], k2[T(~wo)])
    k6 = gmm_weight_only(T(x), T(wq), T(wsc), torch.zeros_like(T(wsc)) if zp is None
                         else tzp, T(gs), gsize, out_dtype=torch.float32)
    assert torch.equal(got[T(wo)], k6[T(wo)])


def test_weight_only_rows_ignore_their_codes_and_wxa_rows_their_floats():
    """Both activation operands ride along for every row; each expert reads
    only its own kind."""
    sizes, k, n = [4, 6, 3], 128, 64
    x, aq, asc, wq, wsc, wzp, gs = _operands(11, sizes, k, n, 1)
    flags = torch.tensor([1, 0, 1], dtype=torch.int32)
    args = (T(asc), T(wq), T(wsc), flags, T(gs))
    base = gmm_mixed_wo_wxa(T(x), T(aq), *args, out_dtype=torch.float32)
    wo = T(_row_flags(flags.tolist(), gs))
    x2, aq2 = T(x).clone(), T(aq).clone()
    x2[~wo] = 7.0            # floats of the w x a rows
    aq2[wo] = 5              # codes of the weight-only rows
    assert torch.equal(gmm_mixed_wo_wxa(x2, aq2, *args, out_dtype=torch.float32), base)
    x2[wo] = 0.0
    assert not torch.equal(gmm_mixed_wo_wxa(x2, aq2, *args, out_dtype=torch.float32), base)


def test_bf16_rows_round_the_weights_to_bf16():
    """On the serving path the rows are bf16: the dequantized weights round to
    bf16 before the product, as K6's do."""
    sizes, k, n = [3, 5], 128, 64
    x, aq, asc, wq, wsc, wzp, gs = _operands(5, sizes, k, n, 2)
    flags = torch.tensor([1, 1], dtype=torch.int32)
    xb = T(x).to(torch.bfloat16)
    got = gmm_mixed_wo_wxa(xb, T(aq), T(asc), T(wq), T(wsc), flags, T(gs),
                           rhs_zp=T(wzp))
    k6 = gmm_weight_only(xb, T(wq), T(wsc), T(wzp), T(gs), 64)
    assert got.dtype == torch.bfloat16 and torch.equal(got, k6)
