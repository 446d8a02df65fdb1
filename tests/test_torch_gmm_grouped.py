"""Port parity: the plain versions of kernels K8 (gmm_w8a8_grouped) and K9
(gmm_w8a8_asym) and the grouped / flex activation quantizers against the JAX
package (Pallas kernels in interpret mode, quantizers jitted).

Tolerances. The integer sums are exact in both packages; what differs is
how the f32 epilogue rounds. The port rounds every product and sum on its
own (``(part * s_a) * s_b``, then ``+``), as the reference's expression is
written; XLA on the CPU contracts ``x * s_b + acc`` into one FMA, which
moves a third of the f32 outputs by an ulp or two. So:

- against a numpy oracle that takes the same separate f32 steps: bitwise;
- against the JAX kernel: f32 outputs within 2^-21 * max|ref| (four f32 ulps
  at the largest output; read: two), bf16 outputs within one bf16 ulp of the
  reference element;
- activation codes and scales against the jitted reference: bitwise
  (``quantize_act_grouped`` multiplies by the f32 reciprocal of the clip
  range as the compiled reference does; the op-by-op reference divides and
  lands within an ulp. ``quantize_act_rows_flex`` divides by its per-row
  range as both the compiled and the op-by-op reference do).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.ops import pallas_gmm
from mxmoe_tpu.quant import qparams as jq
from mxmoe_tpu_torch.ops import kernels
from mxmoe_tpu_torch.ops.gmm_w8a8_asym import gmm_w8a8_asym
from mxmoe_tpu_torch.ops.gmm_w8a8_grouped import gmm_w8a8_grouped
from mxmoe_tpu_torch.quant import qparams as tq

T = torch.from_numpy


def _operands(seed, sizes, k, n, groups):
    rng = np.random.default_rng(seed)
    m, e = int(sum(sizes)), len(sizes)
    aq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    asc = (rng.random((m, groups)) * 0.05 + 1e-3).astype(np.float32)
    wq = rng.integers(-127, 128, (e, k, n), dtype=np.int8)
    wsc = (rng.random((e, groups, n)) * 0.01 + 1e-4).astype(np.float32)
    wzp = (rng.standard_normal((e, groups, n)) * 0.02).astype(np.float32)
    return aq, asc, wq, wsc, wzp, np.asarray(sizes, np.int32)


def _assert_close_to_jax(got, ref, out):
    """The module docstring's tolerance against the JAX kernel."""
    g = got.float().numpy()
    r = np.asarray(ref.astype(jnp.float32))
    if out == "float32":
        np.testing.assert_allclose(g, r, rtol=0, atol=2.0 ** -21 * np.abs(r).max())
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(r), 2.0 ** -126))) - 7)
        assert (np.abs(g - r) <= ulp).all()


def _grouped_oracle(aq, asc, wq, wsc, wzp, gs, gsize):
    """numpy, every f32 step on its own, groups ascending."""
    m, k = aq.shape
    n, g = wq.shape[-1], k // gsize
    out = np.zeros((m, n), np.float32)
    start = 0
    for e, size in enumerate(gs.tolist()):
        rows = slice(start, start + size)
        acc = np.zeros((size, n), np.float32)
        for j in range(g):
            ks = slice(j * gsize, (j + 1) * gsize)
            a = aq[rows, ks].astype(np.int64)
            part = (a @ wq[e, ks].astype(np.int64)).astype(np.float32)
            sa = asc[rows, j:j + 1]
            acc = acc + (part * sa) * wsc[e, j]
            if wzp is not None:
                rsum = a.sum(-1, keepdims=True).astype(np.float32)
                acc = acc + (rsum * sa) * wzp[e, j]
        out[rows] = acc
        start += size
    return out


GROUPED_CASES = [
    # straddling groups, empty experts, K = 384: its half is no multiple of g
    ([5, 0, 19, 8, 0, 12], 384, 128, 128),
    # decode shape: one row per expert, many empty experts
    ([1, 0, 1, 1, 0, 0, 1, 0], 256, 64, 128),
    # E = 1, the shared expert's launch; and one group (g = -1)
    ([7], 384, 32, 128),
    ([3, 0, 9], 128, 48, -1),
]


@pytest.mark.parametrize("sizes,k,n,gsize", GROUPED_CASES)
@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_gmm_w8a8_grouped_vs_jax(sizes, k, n, gsize, asym, out):
    g = k if gsize == -1 else gsize
    aq, asc, wq, wsc, wzp, gs = _operands(k + n + len(sizes), sizes, k, n, k // g)
    zp = wzp if asym else None
    ref = pallas_gmm.gmm_w8a8_grouped(
        jnp.asarray(aq), jnp.asarray(asc), jnp.asarray(wq), jnp.asarray(wsc),
        jnp.asarray(gs), gsize=g, bm=16, bn=32,
        rhs_zp=None if zp is None else jnp.asarray(zp),
        out_dtype=getattr(jnp, out), interpret=True)
    kernels.reset_launch_counts()
    got = gmm_w8a8_grouped(T(aq), T(asc), T(wq), T(wsc), T(gs), gsize=gsize,
                           rhs_zp=None if zp is None else T(zp),
                           out_dtype=getattr(torch, out))
    assert kernels.launches["gmm_w8a8_grouped"] == 0     # CPU: the plain version
    _assert_close_to_jax(got, ref, out)


@pytest.mark.parametrize("sizes,k,n,gsize", GROUPED_CASES[:3])
@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
def test_gmm_w8a8_grouped_plain_bitwise_vs_unfused_oracle(sizes, k, n, gsize, asym):
    aq, asc, wq, wsc, wzp, gs = _operands(k * 3 + n, sizes, k, n, k // gsize)
    zp = wzp if asym else None
    got = gmm_w8a8_grouped(T(aq), T(asc), T(wq), T(wsc), T(gs), gsize=gsize,
                           rhs_zp=None if zp is None else T(zp),
                           out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(),
                                  _grouped_oracle(aq, asc, wq, wsc, zp, gs, gsize))


@pytest.mark.parametrize("sizes,k,n", [([5, 0, 19, 8, 0, 12], 64, 48),
                                       ([1, 0, 1, 1, 0, 0, 1, 0], 256, 64),
                                       ([11], 96, 32)])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_gmm_w8a8_asym_vs_jax_and_oracle(sizes, k, n, out):
    aq, asc, wq, wsc, wzp, gs = _operands(k + n, sizes, k, n, 1)
    ref = pallas_gmm.gmm_w8a8_asym(
        jnp.asarray(aq), jnp.asarray(asc), jnp.asarray(wq), jnp.asarray(wsc),
        jnp.asarray(wzp), jnp.asarray(gs), bm=16, bn=32,
        out_dtype=getattr(jnp, out), interpret=True)
    kernels.reset_launch_counts()
    got = gmm_w8a8_asym(T(aq), T(asc), T(wq), T(wsc), T(wzp), T(gs),
                        out_dtype=getattr(torch, out))
    assert kernels.launches["gmm_w8a8_asym"] == 0
    _assert_close_to_jax(got, ref, out)
    # the unfused f32 steps in numpy: bitwise
    f32 = gmm_w8a8_asym(T(aq), T(asc), T(wq), T(wsc), T(wzp), T(gs),
                        out_dtype=torch.float32).numpy()
    start = 0
    for e, size in enumerate(sizes):
        a = aq[start:start + size].astype(np.int64)
        acc = (a @ wq[e].astype(np.int64)).astype(np.float32)
        rsum = a.sum(-1, keepdims=True).astype(np.float32)
        sa = asc[start:start + size]
        want = acc * sa * wsc[e] + rsum * sa * wzp[e]
        np.testing.assert_array_equal(f32[start:start + size], want)
        start += size
    # one group with a zero point is the same function through K8's plain version
    same = gmm_w8a8_grouped(T(aq), T(asc), T(wq), T(wsc), T(gs), gsize=-1,
                            rhs_zp=T(wzp), out_dtype=getattr(torch, out))
    assert torch.equal(got, same)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m,k,gsize", [(37, 384, 128), (4, 256, 64)])
def test_quantize_act_grouped_bitwise_vs_jitted_reference(bits, m, k, gsize):
    rng = np.random.default_rng(bits + k)
    x = (rng.standard_normal((m, k)) * 3).astype(np.float32)
    x[1] = 0.0                                    # an all-zero row: the 1e-8 floor
    qj, sj = jax.jit(lambda a: jq.quantize_act_grouped(a, bits, gsize))(jnp.asarray(x))
    for dtype in (torch.float32, torch.bfloat16):
        xt = T(x).to(dtype)
        if dtype == torch.bfloat16:
            qj, sj = jax.jit(lambda a: jq.quantize_act_grouped(a, bits, gsize))(
                jnp.asarray(x).astype(jnp.bfloat16))
        q, s = tq.quantize_act_grouped(xt, bits, gsize)
        assert q.dtype == torch.int8 and s.shape == (m, k // gsize)
        np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    # the op-by-op reference divides: its scales are within an ulp, not equal
    _, se = jq.quantize_act_grouped(jnp.asarray(x), bits, gsize)
    _, s = tq.quantize_act_grouped(T(x), bits, gsize)
    np.testing.assert_allclose(s.numpy(), np.asarray(se), rtol=2.0 ** -23, atol=0)


@pytest.mark.parametrize("m,k,gsize", [(37, 384, 128), (6, 128, 128)])
def test_quantize_act_rows_flex_bitwise_vs_reference(m, k, gsize):
    rng = np.random.default_rng(m + k)
    x = (rng.standard_normal((m, k)) * 2).astype(np.float32)
    bits = rng.choice([4.0, 8.0, 16.0], m).astype(np.float32)
    flags = rng.choice([-1.0, float(gsize)], m).astype(np.float32)
    ref = jax.jit(lambda a, b, f: jq.quantize_act_rows_flex(a, b, f, gsize))
    qj, sj = ref(jnp.asarray(x), jnp.asarray(bits), jnp.asarray(flags))
    q, s = tq.quantize_act_rows_flex(T(x), T(bits), T(flags), gsize)
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    qe, se = jq.quantize_act_rows_flex(jnp.asarray(x), jnp.asarray(bits),
                                       jnp.asarray(flags), gsize)
    np.testing.assert_array_equal(s.numpy(), np.asarray(se))
    # per-token rows: the per-row-bits quantizer's codes, scale replicated
    per_tok = flags <= 0
    q1, s1 = tq.quantize_act_per_row_bits(T(x), T(bits))
    assert torch.equal(q[per_tok], q1[per_tok])
    assert torch.equal(s[per_tok], s1[per_tok].expand(-1, k // gsize))


def test_grouped_wrappers_reject_bad_group_size():
    aq, asc, wq, wsc, _, gs = _operands(0, [4], 96, 16, 1)
    with pytest.raises(ValueError, match="gsize"):
        gmm_w8a8_grouped(T(aq), T(asc), T(wq), T(wsc), T(gs), gsize=64)
    with pytest.raises(ValueError, match="gsize"):
        tq.quantize_act_grouped(T(aq).float(), 8, 64)
