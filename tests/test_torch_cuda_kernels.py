"""The port's CUDA kernels (K1-K15, K3 in its bf16- and int8-cache forms, and
the read-only decode attention: decode_attention_stacked, decode_attention,
decode_attention_q8)
against their plain PyTorch versions on a card, over shapes and dtypes beyond
the serving path's: GQA groups, f32 operands, ragged and empty expert groups,
K not a multiple of the k-tile, S not a multiple of the S-chunk, every mix of
int8-stored and nibble-packed experts, one and many k-groups, a K whose half
is no multiple of the group size.

Needs a CUDA card and nvcc; skips elsewhere. This file imports no jax, so
it also runs where jax is absent:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q

Tolerances: K1 codes/scales and K2 / K4 / K5 outputs bitwise (K4 and K5 also
against K2 on the unpacked codes); K3 and K3q caches (codes and scales)
bitwise and their output, per slot b, within 1e-5 * max|ref[b]| (online
softmax sums in another order), plus one bf16 ulp of the reference element
for bf16 outputs (both round the same f32 value once). K8 and K9 bitwise
(exact int32 group sums, the plain version's f32 steps in its order). K6 and
K7 within ``gmm_weight_only.error_over_bound`` (f32 accumulation over K terms
in any order, + 1 bf16 ulp for a bf16 output) of the float64 product of the
same bf16 weights, K7 bitwise K6 on the unpacked codes; a reference with one
k-group's zero point dropped or one group's scales shifted must fail it.
K4f (the flex form of K4) bitwise its plain version and bitwise K8 on the
unpacked codes; K10's w x a experts bitwise K8 (K2 when per channel) and its
weight-only experts bitwise K6 on the same operands and within K6's bound;
K11 within ``gmm.error_over_bound`` (f32 accumulation over K terms, + 1 bf16
ulp for a bf16 output) of the float64 product, for bf16 and f32 operands.
K12 (the whole FFN) bitwise its plain version, K13 bitwise its plain version
and K12 on the equivalent int8 codes (also at row counts on the edges of the
cluster body's m16 / m32 fragments with tiles straddling experts, at
qwen2_moe's decode and 256-token prefill shapes, each launch counted once,
and over the width domain), K14 bitwise its plain version and K1 +
K2, K15 bitwise K2 / K5 on the same aligned layout. The int8 grouped GEMM's
two schedules (``int8_gmm_schedule``: m16 tiles and split-K at decode, the
64-row tile above M 64) through K2 / K4 / K5 / K9 bitwise, the grouped-scale
GEMM's two (``grouped_gmm_schedule``: the m16 ring kernel with split-K at
whole groups, the 32-row tile above M 64) through K8 / K4f bitwise, the
weight-only GEMM's two (``weight_only_gmm_schedule``, one for K6, K7 and K10:
the m16 ring body with split-K over byte-tile pairs, the 32-row tile above
M 64) with K7 and K10's weight-only rows bitwise K6 and K10's w x a rows
bitwise K8, and K3 / K3q at lengths on the edges of their warp chunks and
S-blocks."""

import pytest
import torch

from mxmoe_tpu_torch.ops import (act_quant, gmm as gmm_float, gmm_mixed_packed,
                                 gmm_mixed_wo_wxa, gmm_w4a8_packed, gmm_w8a8,
                                 gmm_w8a8_asym, gmm_w8a8_grouped, gmm_weight_only,
                                 gmm_weight_only_packed, kernels)
from mxmoe_tpu_torch.quant.packing import build_ragged_mixed, pack_int4_halves
from mxmoe_tpu_torch.serving import decode_attention as da

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,dtype", [(37, 64, torch.float32),
                                       (5, 2816, torch.bfloat16),
                                       (300, 1408, torch.bfloat16)])
def test_quantize_rows_kernel_bitwise(dev, m, k, dtype):
    g = torch.Generator(device=dev).manual_seed(m)
    x = (torch.randn((m, k), generator=g, device=dev) * 3).to(dtype)
    bits = torch.tensor([4.0, 8.0, 16.0], device=dev).repeat(m)[:m].contiguous()
    before = kernels.launches["quantize_rows"]
    q, s = act_quant.quantize_rows(x, bits, gain=1.0 + 3.7e-4)
    qp, sp = act_quant.quantize_rows_plain(x, bits, gain=1.0 + 3.7e-4)
    torch.cuda.synchronize()
    assert kernels.launches["quantize_rows"] == before + 1
    assert torch.equal(q, qp) and torch.equal(s, sp)


@pytest.mark.parametrize("m,k", [(4, 2048), (4, 5632), (256, 5632)])
def test_quantize_rows_kernel_expanded_scalar_bits(dev, m, k):
    """The int8 shared expert's call: one bit width expanded (stride 0) over
    the rows, at its two K."""
    g = torch.Generator(device=dev).manual_seed(k + m)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    bits = torch.tensor(8.0, device=dev).expand(m)
    q, s = act_quant.quantize_rows(x, bits)
    qp, sp = act_quant.quantize_rows_plain(x, bits)
    torch.cuda.synchronize()
    assert torch.equal(q, qp) and torch.equal(s, sp)


@pytest.mark.parametrize("sizes,k,n,out", [
    ([5, 0, 19, 8, 0, 70], 96, 48, torch.bfloat16),       # K % 64 != 0
    ([0, 0, 130, 1, 0], 1408, 2048, torch.float32),
    ([1, 1, 0, 1, 1, 0, 0, 1], 2048, 2816, torch.bfloat16),
])
def test_gmm_w8a8_kernel_bitwise(dev, sizes, k, n, out):
    g = torch.Generator(device=dev).manual_seed(k + n)
    m, e = sum(sizes), len(sizes)
    aq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    asc = torch.rand((m, 1), generator=g, device=dev) * 0.05
    wq = torch.randint(-127, 128, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    wsc = torch.rand((e, 1, n), generator=g, device=dev) * 0.01
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    got = gmm_w8a8.gmm_w8a8(aq, asc, wq, wsc, gs, out_dtype=out)
    ref = gmm_w8a8.gmm_w8a8_plain(aq, asc, wq, wsc, gs, out_dtype=out)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_gmm_w8a8_kernel_rows_past_groups_untouched(dev):
    """Aligned-dispatch padding: rows past sum(group_sizes) are not written."""
    g = torch.Generator(device=dev).manual_seed(1)
    aq = torch.randint(-127, 128, (40, 64), generator=g, device=dev, dtype=torch.int8)
    asc = torch.rand((40, 1), generator=g, device=dev)
    wq = torch.randint(-127, 128, (3, 64, 32), generator=g, device=dev, dtype=torch.int8)
    wsc = torch.rand((3, 1, 32), generator=g, device=dev)
    gs = torch.tensor([8, 0, 16], dtype=torch.int32, device=dev)
    got = gmm_w8a8.gmm_w8a8(aq, asc, wq, wsc, gs, out_dtype=torch.float32)
    ref = gmm_w8a8.gmm_w8a8_plain(aq, asc, wq, wsc, gs, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got[:24], ref[:24])


def _mixed_operands(dev, sizes, pflags, k, n):
    """Activations, per-expert codes (4-bit range where packed) and scales."""
    g = torch.Generator(device=dev).manual_seed(k + n + len(sizes))
    m, e = sum(sizes), len(sizes)
    aq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    asc = torch.rand((m, 1), generator=g, device=dev) * 0.05
    w8 = torch.randint(-127, 128, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    w4 = torch.randint(-8, 8, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    pf = torch.tensor(pflags, dtype=torch.bool, device=dev)
    wq = torch.where(pf[:, None, None], w4, w8)
    wsc = torch.rand((e, 1, n), generator=g, device=dev) * 0.01
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    return aq, asc, wq, wsc, gs


@pytest.mark.parametrize("sizes,pflags,k,n,out", [
    ([5, 0, 19, 8, 0, 70], [1, 1, 0, 1, 0, 0], 96, 48, torch.bfloat16),  # K/2 % 64 != 0
    ([0, 0, 130, 1, 0], [0, 1, 1, 0, 1], 1408, 2048, torch.float32),
    ([1, 1, 0, 1, 1, 0, 0, 1], [1, 0, 1, 0, 1, 0, 1, 0], 2048, 2816, torch.bfloat16),
    ([3, 200, 7], [0, 0, 0], 128, 64, torch.bfloat16),                    # no packed expert
])
def test_gmm_mixed_packed_kernel_bitwise(dev, sizes, pflags, k, n, out):
    aq, asc, wq, wsc, gs = _mixed_operands(dev, sizes, pflags, k, n)
    cat, blk = build_ragged_mixed(wq, pflags)
    pf = torch.tensor(pflags, dtype=torch.int32, device=dev)
    blk = torch.tensor(blk, dtype=torch.int32, device=dev)
    before = kernels.launches["gmm_mixed_packed"]
    got = gmm_mixed_packed.gmm_mixed_packed(aq, asc, cat, wsc, gs, pf, blk,
                                            out_dtype=out)
    ref = gmm_mixed_packed.gmm_mixed_packed_plain(aq, asc, cat, wsc, gs, pf, blk,
                                                  out_dtype=out)
    k2 = gmm_w8a8.gmm_w8a8(aq, asc, wq, wsc, gs, out_dtype=out)
    torch.cuda.synchronize()
    assert kernels.launches["gmm_mixed_packed"] == before + 1
    m = sum(sizes)
    assert torch.equal(got[:m], ref[:m]) and torch.equal(got[:m], k2[:m])


@pytest.mark.parametrize("sizes,k,n,out", [
    ([5, 0, 19, 8, 0, 70], 96, 48, torch.bfloat16),
    ([0, 0, 130, 1, 0], 1408, 2048, torch.float32),
    ([1, 1, 0, 1, 1, 0, 0, 1], 2048, 2816, torch.bfloat16),
])
def test_gmm_w4a8_packed_kernel_bitwise(dev, sizes, k, n, out):
    e = len(sizes)
    aq, asc, wq, wsc, gs = _mixed_operands(dev, sizes, [1] * e, k, n)
    packed = pack_int4_halves(wq)
    before = kernels.launches["gmm_w4a8_packed"]
    got = gmm_w4a8_packed.gmm_w4a8_packed(aq, asc, packed, wsc, gs, out_dtype=out)
    ref = gmm_w4a8_packed.gmm_w4a8_packed_plain(aq, asc, packed, wsc, gs, out_dtype=out)
    k2 = gmm_w8a8.gmm_w8a8(aq, asc, wq, wsc, gs, out_dtype=out)
    ones = torch.ones((e,), dtype=torch.int32, device=dev)
    k4 = gmm_mixed_packed.gmm_mixed_packed(
        aq, asc, packed.reshape(-1, n), wsc, gs, ones,
        torch.arange(e, dtype=torch.int32, device=dev), out_dtype=out)
    torch.cuda.synchronize()
    assert kernels.launches["gmm_w4a8_packed"] == before + 1
    assert torch.equal(got, ref) and torch.equal(got, k2) and torch.equal(got, k4)


def _grouped_operands(dev, sizes, k, n, groups):
    g = torch.Generator(device=dev).manual_seed(k + n + len(sizes) + groups)
    m, e = sum(sizes), len(sizes)
    aq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    asc = torch.rand((m, groups), generator=g, device=dev) * 0.05 + 1e-3
    wq = torch.randint(-127, 128, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    wsc = torch.rand((e, groups, n), generator=g, device=dev) * 0.01 + 1e-4
    wzp = torch.randn((e, groups, n), generator=g, device=dev) * 0.02
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    return aq, asc, wq, wsc, wzp, gs


@pytest.mark.parametrize("sizes,k,n,gsize,out", [
    ([5, 0, 19, 8, 0, 70], 384, 48, 128, torch.bfloat16),     # 3 groups, odd
    ([0, 0, 130, 1, 0], 1408, 2048, 128, torch.float32),      # 11 groups
    ([1, 1, 0, 1, 1, 0, 0, 1], 2048, 2816, 128, torch.bfloat16),
    ([4], 5632, 2048, 128, torch.bfloat16),                   # E = 1, 44 groups
    ([33, 0, 2], 96, 64, -1, torch.float32),                  # one group, K % 64 != 0
    ([7, 40], 256, 32, 64, torch.bfloat16),                   # a group per k-tile
    # the decode body (M <= 64): 1-64 rows an expert, routed and E = 1
    ([1, 0, 16, 17, 0, 2], 1408, 2048, 128, torch.float32),
    ([3, 61], 1408, 2048, 128, torch.bfloat16),               # M 64, no split
    ([64], 2048, 1024, 128, torch.float32),                   # E = 1, split-K
    ([4], 2048, 11264, 128, torch.bfloat16),                  # shared gate_up
    ([4], 5632, 2048, -1, torch.float32),                     # one group, split
    ([2, 0, 1, 1], 1408, 2048, -1, torch.bfloat16),           # one group, routed
])
@pytest.mark.parametrize("asym", [False, True], ids=["sym", "zp"])
def test_gmm_w8a8_grouped_kernel_bitwise(dev, sizes, k, n, gsize, out, asym):
    groups = 1 if gsize == -1 else k // gsize
    aq, asc, wq, wsc, wzp, gs = _grouped_operands(dev, sizes, k, n, groups)
    zp = wzp if asym else None
    before = kernels.launches["gmm_w8a8_grouped"]
    got = gmm_w8a8_grouped.gmm_w8a8_grouped(aq, asc, wq, wsc, gs, gsize=gsize,
                                            rhs_zp=zp, out_dtype=out)
    ref = gmm_w8a8_grouped.gmm_w8a8_grouped_plain(aq, asc, wq, wsc, gs, gsize, zp,
                                                  out_dtype=out)
    torch.cuda.synchronize()
    assert kernels.launches["gmm_w8a8_grouped"] == before + 1
    assert torch.equal(got, ref)


@pytest.mark.parametrize("sizes,k,n,out", [
    ([5, 0, 19, 8, 0, 70], 96, 48, torch.bfloat16),
    ([0, 0, 130, 1, 0], 1408, 2048, torch.float32),
    ([1, 1, 0, 1, 1, 0, 0, 1], 2048, 2816, torch.bfloat16),
])
def test_gmm_w8a8_asym_kernel_bitwise(dev, sizes, k, n, out):
    aq, asc, wq, wsc, wzp, gs = _grouped_operands(dev, sizes, k, n, 1)
    before = kernels.launches["gmm_w8a8_asym"]
    got = gmm_w8a8_asym.gmm_w8a8_asym(aq, asc, wq, wsc, wzp, gs, out_dtype=out)
    ref = gmm_w8a8_asym.gmm_w8a8_asym_plain(aq, asc, wq, wsc, wzp, gs, out_dtype=out)
    # one k-group with a zero point: the same function through K8
    k8 = gmm_w8a8_grouped.gmm_w8a8_grouped(aq, asc, wq, wsc, gs, gsize=-1,
                                           rhs_zp=wzp, out_dtype=out)
    torch.cuda.synchronize()
    assert kernels.launches["gmm_w8a8_asym"] == before + 1
    assert torch.equal(got, ref) and torch.equal(got, k8)
    # a dropped zero-point term is seen
    sym = gmm_w8a8.gmm_w8a8(aq, asc, wq, wsc, gs, out_dtype=out)
    assert not torch.equal(got, sym)


def _weight_only_operands(dev, sizes, k, n, gsize, bits=4):
    g = torch.Generator(device=dev).manual_seed(k + n + len(sizes))
    m, e = sum(sizes), len(sizes)
    groups = 1 if gsize == -1 else k // gsize
    hi = 1 << (bits - 1)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    wq = torch.randint(-hi, hi, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    sc = torch.rand((e, groups, n), generator=g, device=dev) * 0.02 + 1e-3
    zp = torch.randn((e, groups, n), generator=g, device=dev) * 0.05
    return x, wq, sc, zp, torch.tensor(sizes, dtype=torch.int32, device=dev)


WEIGHT_ONLY_CASES = [
    ([5, 0, 19, 8, 0, 70], 384, 48, 128),       # K/2 = 192: a group spans the halves
    ([0, 0, 130, 1, 0], 1408, 2048, 128),       # K/2 = 704, 11 groups
    ([1, 1, 0, 1, 1, 0, 0, 1], 2048, 2816, 128),
    ([1, 1, 0, 1, 1, 0, 0, 1], 2048, 2816, -1),
    ([4], 5632, 2048, 128),                     # E = 1, the shared expert's down
    ([33, 0, 2], 96, 64, -1),                   # K/2 % 64 != 0
]


@pytest.mark.parametrize("sizes,k,n,gsize", WEIGHT_ONLY_CASES)
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_gmm_weight_only_kernels_within_bound(dev, sizes, k, n, gsize, out):
    x, wq, sc, zp, gs = _weight_only_operands(dev, sizes, k, n, gsize)
    before = dict(kernels.launches)
    got = gmm_weight_only.gmm_weight_only(x, wq, sc, zp, gs, gsize, out_dtype=out)
    got_p = gmm_weight_only_packed.gmm_weight_only_packed(
        x, pack_int4_halves(wq), sc, zp, gs, gsize, out_dtype=out)
    torch.cuda.synchronize()
    assert kernels.launches["gmm_weight_only"] == before["gmm_weight_only"] + 1
    assert (kernels.launches["gmm_weight_only_packed"]
            == before["gmm_weight_only_packed"] + 1)
    assert torch.equal(got, got_p)                    # one walk over K for both
    _, ratio = gmm_weight_only.error_over_bound(got, x, wq, sc, zp, gs, gsize)
    assert ratio <= 1.0
    # mutation checks: a reference that drops the last k-group's zero point,
    # or takes that group's scales from its neighbour (the neighbouring
    # column's when there is one group), must lie outside the bound
    groups = sc.shape[1]
    zp_m = zp.clone()
    zp_m[:, groups - 1] = 0.0
    sc_m = sc.clone()
    sc_m[:, groups - 1] = sc[:, groups - 2] if groups > 1 else sc[:, 0].roll(1, -1)
    for sc_r, zp_r in ((sc, zp_m), (sc_m, zp)):
        _, ratio = gmm_weight_only.error_over_bound(got, x, wq, sc_r, zp_r, gs, gsize)
        assert ratio > 1.0


@pytest.mark.parametrize("bits", [1, 2, 3, 8])
def test_gmm_weight_only_kernel_low_bit_codes_in_int8_storage(dev, bits):
    x, wq, sc, zp, gs = _weight_only_operands(dev, [4, 0, 9, 60], 1408, 256, 128,
                                              bits=bits)
    got = gmm_weight_only.gmm_weight_only(x, wq, sc, zp, gs, 128)
    torch.cuda.synchronize()
    _, ratio = gmm_weight_only.error_over_bound(got, x, wq, sc, zp, gs, 128)
    assert ratio <= 1.0


def test_grouped_and_weight_only_wrappers_reject_bad_input(dev):
    aq, asc, wq, wsc, wzp, gs = _grouped_operands(dev, [4], 96, 16, 3)
    with pytest.raises(ValueError, match="gsize"):            # 32 is no k-tile multiple
        gmm_w8a8_grouped.gmm_w8a8_grouped(aq, asc, wq, wsc, gs, gsize=32)
    with pytest.raises(ValueError, match="gsize"):            # K % gsize != 0
        gmm_w8a8_grouped.gmm_w8a8_grouped(aq, asc, wq, wsc, gs, gsize=64)
    with pytest.raises(ValueError, match="rhs_zp"):
        gmm_w8a8_asym.gmm_w8a8_asym(aq, asc[:, :1].contiguous(), wq,
                                    wsc[:, :1].contiguous(), wzp, gs)
    x, wq, sc, zp, gs = _weight_only_operands(dev, [4], 96, 16, -1)
    with pytest.raises(ValueError, match="bf16"):
        gmm_weight_only.gmm_weight_only(x.float(), wq, sc, zp, gs, -1)
    with pytest.raises(ValueError, match="gsize"):
        gmm_weight_only.gmm_weight_only(x, wq, sc, zp, gs, 64)
    with pytest.raises(ValueError, match="rhs_packed"):
        gmm_weight_only_packed.gmm_weight_only_packed(x, wq, sc, zp, gs, -1)


def _assert_within_slot_bound(out, ref, dtype):
    r = ref.float()
    tol = 1e-5 * r.abs().flatten(1).amax(1)[:, None, None]
    if dtype == torch.bfloat16:       # one bf16 ulp of each reference element
        tol = tol + torch.exp2(
            torch.floor(torch.log2(r.abs().clamp_min(2.0 ** -126))) - 7)
    assert bool(((out.float() - r).abs() <= tol).all())


@pytest.mark.parametrize("groups,dk,s_max,dtype", [
    (2, 128, 128, torch.float32),
    (4, 64, 1000, torch.bfloat16),
    (1, 128, 2048, torch.bfloat16),
    (8, 256, 300, torch.float32),
])
def test_decode_attention_q8_kernel_vs_plain(dev, groups, dk, s_max, dtype):
    g = torch.Generator(device=dev).manual_seed(groups * dk + 1)
    nl, b, n_kv, layer = 2, 5, 2, 1
    n_h, dv = n_kv * groups, 128 if dk != 64 else 64

    def codes(d):
        return torch.randint(-127, 128, (nl, b, n_kv, s_max, d), generator=g,
                             device=dev, dtype=torch.int8)

    def scales():
        return torch.rand((nl, b, n_kv, s_max), generator=g, device=dev) * 0.03 + 1e-3

    caches = [codes(dk), scales(), codes(dv), scales()]
    q = torch.randn((b, n_h, dk), generator=g, device=dev).to(dtype)
    kn = (torch.randn((b, n_kv, dk), generator=g, device=dev) * 2).to(dtype)
    vn = (torch.randn((b, n_kv, dv), generator=g, device=dev) * 2).to(dtype)
    kn[0, 0] = 0                      # an all-zero vector takes the 1e-8 floor
    lengths = torch.tensor([0, s_max // 2, s_max, s_max - 1, 257 % s_max],
                           dtype=torch.int32, device=dev)
    valid = torch.tensor([1, 1, 1, 0, 1], dtype=torch.int32, device=dev)
    caches2 = [c.clone() for c in caches]
    before = kernels.launches["decode_attention_update_stacked_q8"]
    out, _ = da.decode_attention_update_stacked(q, kn, vn, *caches, lengths,
                                                layer, valid=valid)
    ref = da.decode_attention_update_q8_plain(q, kn, vn, *caches2, lengths, layer,
                                              valid, 1.0 / dk ** 0.5)
    torch.cuda.synchronize()
    assert kernels.launches["decode_attention_update_stacked_q8"] == before + 1
    for got, want in zip(caches, caches2):
        assert torch.equal(got, want)
    _assert_within_slot_bound(out, ref, dtype)


@pytest.mark.parametrize("groups,dk,s_max,dtype", [
    (2, 128, 128, torch.float32),
    (4, 64, 1000, torch.bfloat16),
    (1, 128, 2048, torch.bfloat16),
    (8, 256, 300, torch.float32),
])
def test_decode_attention_kernel_vs_plain(dev, groups, dk, s_max, dtype):
    g = torch.Generator(device=dev).manual_seed(groups * dk)
    nl, b, n_kv, layer = 2, 5, 2, 1
    n_h, dv = n_kv * groups, 128 if dk != 64 else 64
    ck = torch.randn((nl, b, n_kv, s_max, dk), generator=g, device=dev).to(torch.bfloat16)
    cv = torch.randn((nl, b, n_kv, s_max, dv), generator=g, device=dev).to(torch.bfloat16)
    q = torch.randn((b, n_h, dk), generator=g, device=dev).to(dtype)
    kn = torch.randn((b, n_kv, dk), generator=g, device=dev).to(dtype)
    vn = torch.randn((b, n_kv, dv), generator=g, device=dev).to(dtype)
    lengths = torch.tensor([0, s_max // 2, s_max, s_max - 1, 257 % s_max],
                           dtype=torch.int32, device=dev)
    valid = torch.tensor([1, 1, 1, 0, 1], dtype=torch.int32, device=dev)
    ck2, cv2 = ck.clone(), cv.clone()
    out, _ = da.decode_attention_update_stacked(q, kn, vn, ck, None, cv, None,
                                                lengths, layer, valid=valid)
    ref = da.decode_attention_update_plain(q, kn, vn, ck2, cv2, lengths, layer,
                                           valid, 1.0 / dk ** 0.5)
    torch.cuda.synchronize()
    assert torch.equal(ck, ck2) and torch.equal(cv, cv2)
    _assert_within_slot_bound(out, ref, dtype)


def test_wrappers_reject_bad_input(dev):
    x = torch.randn((4, 64), device=dev).to(torch.float16)
    with pytest.raises(ValueError):
        act_quant.quantize_rows_uniform(x, 8)
    aq = torch.zeros((4, 20), dtype=torch.int8, device=dev)       # K % 16 != 0
    with pytest.raises(ValueError):
        gmm_w8a8.gmm_w8a8(aq, torch.ones((4, 1), device=dev),
                          torch.zeros((1, 20, 8), dtype=torch.int8, device=dev),
                          torch.ones((1, 1, 8), device=dev),
                          torch.tensor([4], dtype=torch.int32, device=dev))
    aq = torch.zeros((4, 64), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="group size"):          # 32 is no k-tile
        gmm_mixed_packed.gmm_mixed_packed(
            aq, torch.ones((4, 2), device=dev),
            torch.zeros((64, 8), dtype=torch.int8, device=dev),
            torch.ones((1, 2, 8), device=dev),
            torch.tensor([4], dtype=torch.int32, device=dev),
            torch.zeros((1,), dtype=torch.int32, device=dev),
            torch.zeros((1,), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):                               # K % 32 != 0
        gmm_w4a8_packed.gmm_w4a8_packed(
            torch.zeros((4, 48), dtype=torch.int8, device=dev),
            torch.ones((4, 1), device=dev),
            torch.zeros((1, 24, 8), dtype=torch.int8, device=dev),
            torch.ones((1, 1, 8), device=dev),
            torch.tensor([4], dtype=torch.int32, device=dev))


_FLEX_PACKED = [
    # K/2 = 96 is no multiple of the group size: group 1 spans the halves
    ([5, 0, 19, 8, 0, 70], [1, 1, 0, 1, 0, 0], 192, 48, 64, torch.bfloat16),
    ([0, 0, 130, 1, 0], [0, 1, 1, 0, 1], 1408, 2048, 128, torch.float32),   # K/2 704
    ([1, 1, 0, 1, 1, 0, 0, 1], [1, 0, 1, 0, 1, 0, 1, 0], 2048, 2816, 128, torch.bfloat16),
    ([3, 200, 7], [0, 0, 0], 128, 64, 64, torch.bfloat16),        # no packed expert
    ([3, 200, 7], [1, 1, 1], 1408, 64, 128, torch.bfloat16),      # all packed
    # the decode body (M <= 64): the straddling group at K 1408, a tile that
    # straddles K/2 (K 192: K/2 = 96), 1-64 rows an expert, E = 1 split
    ([1, 0, 16, 17, 0, 2], [1, 0, 1, 0, 1, 0], 1408, 2048, 128, torch.float32),
    ([3, 5, 1], [1, 1, 1], 1408, 2048, 128, torch.bfloat16),
    ([2, 7, 0, 30], [0, 0, 0, 0], 2048, 2816, 128, torch.bfloat16),
    ([5, 0, 19, 8, 0, 12], [1, 1, 0, 1, 0, 0], 192, 48, 64, torch.bfloat16),
    ([1, 63], [1, 0], 1408, 2048, 128, torch.float32),
    ([4], [1], 2048, 11264, 128, torch.bfloat16),
    ([4], [1], 1408, 2048, 128, torch.float32),
]


@pytest.mark.parametrize("sizes,pflags,k,n,gsize,out,asym", [
    *[(*c, a) for c in _FLEX_PACKED for a in (False, True)],
    # one group: the flex form only with zero points (else it is K4)
    ([9, 0, 40], [1, 0, 1], 96, 32, -1, torch.float32, True),
])
def test_gmm_mixed_packed_flex_kernel_bitwise(dev, sizes, pflags, k, n, gsize, out,
                                              asym):
    groups = 1 if gsize == -1 else k // gsize
    aq, asc, w8, wsc, wzp, gs = _grouped_operands(dev, sizes, k, n, groups)
    pfb = torch.tensor(pflags, dtype=torch.bool, device=dev)
    wq = torch.where(pfb[:, None, None], w8.clamp(-8, 7), w8)
    cat, blk = build_ragged_mixed(wq, pflags)
    pf = torch.tensor(pflags, dtype=torch.int32, device=dev)
    blk = torch.tensor(blk, dtype=torch.int32, device=dev)
    zp = wzp if asym else None
    before = dict(kernels.launches)
    got = gmm_mixed_packed.gmm_mixed_packed(aq, asc, cat, wsc, gs, pf, blk,
                                            rhs_zp=zp, out_dtype=out)
    ref = gmm_mixed_packed.gmm_mixed_packed_plain(aq, asc, cat, wsc, gs, pf, blk,
                                                  rhs_zp=zp, out_dtype=out)
    k8 = gmm_w8a8_grouped.gmm_w8a8_grouped(aq, asc, wq, wsc, gs, gsize=gsize,
                                           rhs_zp=zp, out_dtype=out)
    torch.cuda.synchronize()
    assert (kernels.launches["gmm_mixed_packed_flex"]
            == before["gmm_mixed_packed_flex"] + 1)
    assert kernels.launches["gmm_mixed_packed"] == before["gmm_mixed_packed"]
    assert torch.equal(got, ref) and torch.equal(got, k8)


@pytest.mark.parametrize("sizes,k,n,gsize", [
    ([5, 0, 19, 8, 0, 70], 384, 48, 128),
    ([0, 0, 130, 1, 0, 3], 1408, 2048, 128),
    ([1, 1, 0, 1, 1, 0, 0, 1], 2048, 2816, 128),
    ([1, 1, 0, 1, 1, 0, 0, 1], 2048, 2816, -1),       # per channel
    ([33, 0, 2, 40], 96, 64, -1),
])
@pytest.mark.parametrize("flags", ["all0", "all1", "alternating"])
@pytest.mark.parametrize("asym", [False, True], ids=["sym", "zp"])
def test_gmm_mixed_wo_wxa_kernel(dev, sizes, k, n, gsize, flags, asym):
    groups = 1 if gsize == -1 else k // gsize
    e = len(sizes)
    aq, asc, wq, wsc, wzp, gs = _grouped_operands(dev, sizes, k, n, groups)
    wq = wq.clamp(-8, 7)
    g = torch.Generator(device=dev).manual_seed(k + e)
    x = torch.randn((sum(sizes), k), generator=g, device=dev).to(torch.bfloat16)
    fl = torch.tensor({"all0": [0] * e, "all1": [1] * e,
                       "alternating": [i % 2 for i in range(e)]}[flags],
                      dtype=torch.int32, device=dev)
    zp = wzp if asym else None
    before = kernels.launches["gmm_mixed_wo_wxa"]
    got = gmm_mixed_wo_wxa.gmm_mixed_wo_wxa(x, aq, asc, wq, wsc, fl, gs, rhs_zp=zp,
                                            out_dtype=torch.bfloat16)
    k8 = gmm_w8a8_grouped.gmm_w8a8_grouped(aq, asc, wq, wsc, gs, gsize=gsize,
                                           rhs_zp=zp)
    k6 = gmm_weight_only.gmm_weight_only(x, wq, wsc, wzp if asym else
                                         torch.zeros_like(wsc), gs, gsize)
    plain = gmm_mixed_wo_wxa.gmm_mixed_wo_wxa_plain(x, aq, asc, wq, wsc, fl, gs,
                                                    rhs_zp=zp)
    torch.cuda.synchronize()
    assert kernels.launches["gmm_mixed_wo_wxa"] == before + 1
    row_flag = torch.repeat_interleave(fl, gs.long()).bool()
    assert torch.equal(got[~row_flag], k8[~row_flag])
    assert torch.equal(got[~row_flag], plain[~row_flag])
    assert torch.equal(got[row_flag], k6[row_flag])
    if groups == 1 and not asym:
        k2 = gmm_w8a8.gmm_w8a8(aq, asc, wq, wsc, gs)
        assert torch.equal(got[~row_flag], k2[~row_flag])
    if bool(row_flag.any()):
        # the weight-only rows against the float64 product: zero the other
        # experts' rows out of the comparison by giving them no rows
        gs1 = torch.where(fl.bool(), gs, torch.zeros_like(gs))
        rows = torch.nonzero(row_flag)[:, 0]
        _, ratio = gmm_weight_only.error_over_bound(
            got[rows].contiguous(), x[rows].contiguous(), wq, wsc,
            wzp if asym else torch.zeros_like(wsc), gs1, gsize)
        assert ratio <= 1.0


@pytest.mark.parametrize("sizes,k,n", [
    ([5, 0, 19, 8, 0, 70], 96, 48),               # K % 64 != 0, N < a tile
    ([0, 0, 130, 1, 0], 1408, 2048),
    ([1, 1, 0, 1, 1, 0, 0, 1], 2048, 2816),
    ([0, 0, 0], 64, 64),                          # no rows at all
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32], ids=["obf16", "of32"])
def test_gmm_bf16_kernel_within_bound(dev, sizes, k, n, dtype, out):
    g = torch.Generator(device=dev).manual_seed(k + n)
    m, e = max(sum(sizes), 1), len(sizes)
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    w = (torch.randn((e, k, n), generator=g, device=dev) * 0.05).to(dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    before = kernels.launches["gmm_bf16"]
    got = gmm_float.gmm_bf16(x, w, gs, out_dtype=out)
    torch.cuda.synchronize()
    assert kernels.launches["gmm_bf16"] == before + 1
    if sum(sizes) == 0:
        return
    _, ratio = gmm_float.error_over_bound(got, x, w, gs)
    assert ratio <= 1.0
    # a reference with the last k row's weights dropped lies outside the bound
    w_m = w.clone()
    w_m[:, k - 1] = 0
    _, ratio = gmm_float.error_over_bound(got, x, w_m, gs)
    assert ratio > 1.0
    # the front end's two arms: the hand-written kernel and the stock product
    via = gmm_float.gmm(x, w, gs, backend="pallas")
    stock = gmm_float.gmm(x, w, gs, backend="ragged_dot")
    torch.cuda.synchronize()
    rows = sum(sizes)
    assert torch.equal(via[:rows], gmm_float.gmm_bf16(x, w, gs)[:rows])
    _, ratio = gmm_float.error_over_bound(stock[:rows].contiguous(), x[:rows].contiguous(),
                                          w, gs)
    assert ratio <= 1.0 or dtype == torch.float32


def _aligned_sizes(counts, align=32):
    return [(c + align - 1) // align * align for c in counts]


@pytest.mark.parametrize("sizes,tail,k,dtype,bits", [
    ([48, 0, 80, 5], 11, 256, torch.bfloat16, 8),
    ([64, 0, 64], 0, 2048, torch.float32, 4),
    ([1, 300, 0, 33], 7, 80, torch.bfloat16, 8)])
def test_gmm_w8a8_fusedquant_kernel_bitwise(dev, sizes, tail, k, dtype, bits):
    """K14 bitwise its plain version and K1 (uniform bits) + K2; rows past the
    sum stay unwritten."""
    from mxmoe_tpu_torch.ops import gmm_w8a8_fusedquant as gfq

    g = torch.Generator(device=dev).manual_seed(k)
    m, e, n = sum(sizes) + tail, len(sizes), 384
    x = (torch.randn((m, k), generator=g, device=dev) * 2).to(dtype)
    wq = torch.randint(-127, 128, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    ws = torch.rand((e, 1, n), generator=g, device=dev) * 0.01 + 1e-4
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    rows = sum(sizes)
    for out in (torch.bfloat16, torch.float32):
        before = kernels.launches["gmm_w8a8_fusedquant"]
        got = gfq.gmm_w8a8_fusedquant(x, wq, ws, gs, a_bits=bits, out_dtype=out)
        plain = gfq.gmm_w8a8_fusedquant_plain(x, wq, ws, gs, bits, out)
        aq, asc = act_quant.quantize_rows_uniform(x, bits)
        k2 = gmm_w8a8.gmm_w8a8(aq, asc, wq, ws, gs, out_dtype=out)
        torch.cuda.synchronize()
        assert kernels.launches["gmm_w8a8_fusedquant"] == before + 1
        assert torch.equal(got[:rows], plain[:rows])
        assert torch.equal(got[:rows], k2[:rows])


@pytest.mark.parametrize("sizes,bm,k,n", [
    ((32, 16, 0, 64, 16), 16, 64, 256),          # the reference test's layout
    ((128, 0, 384, 128), 128, 2048, 2816),       # the headline's gate_up widths
    ((256, 128, 0), 128, 1408, 2048),            # its down widths
    ((0, 0, 48), 16, 128, 72)])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_gmm_ws_kernel_bitwise_k2_k5(dev, sizes, bm, k, n, out):
    """K15 bitwise K2 (int8 weights) and K5 (packed weights) on the same
    aligned layout, and their plain versions."""
    from mxmoe_tpu_torch.ops import gmm_ws

    g = torch.Generator(device=dev).manual_seed(n)
    m, e = sum(sizes), len(sizes)
    aq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    asc = torch.rand((m, 1), generator=g, device=dev) * 0.05
    wq = torch.randint(-127, 128, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    w4 = torch.randint(-8, 8, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    wsc = torch.rand((e, 1, n), generator=g, device=dev) * 0.01
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    got = gmm_ws.gmm_w8a8_ws(aq, asc, wq, wsc, sizes, bm=bm, out_dtype=out)
    k2 = gmm_w8a8.gmm_w8a8(aq, asc, wq, wsc, gs, out_dtype=out)
    plain = gmm_ws.gmm_w8a8_ws_plain(aq, asc, wq, wsc, sizes, out)
    packed = pack_int4_halves(w4)
    got4 = gmm_ws.gmm_w4a8_packed_ws(aq, asc, packed, wsc, sizes, bm=bm, out_dtype=out)
    k5 = gmm_w4a8_packed.gmm_w4a8_packed(aq, asc, packed, wsc, gs, out_dtype=out)
    torch.cuda.synchronize()
    assert torch.equal(got, k2) and torch.equal(got, plain)
    assert torch.equal(got4, k5)


def _ffn_operands(dev, counts, k, n, h, seed, align=32):
    g = torch.Generator(device=dev).manual_seed(seed)
    sizes = _aligned_sizes(counts, align)
    m, e = sum(sizes) + 16, len(sizes)
    aq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    asc = torch.rand((m, 1), generator=g, device=dev) * 0.02 + 1e-3
    wgu = torch.randint(-127, 128, (e, k, 2 * n), generator=g, device=dev,
                        dtype=torch.int8)
    sgu = torch.rand((e, 1, 2 * n), generator=g, device=dev) * 2e-4 + 1e-5
    wd = torch.randint(-127, 128, (e, n, h), generator=g, device=dev, dtype=torch.int8)
    sd = torch.rand((e, 1, h), generator=g, device=dev) * 2e-3 + 1e-5
    bits = torch.tensor([4, 6, 8][:e] * (e // 3 + 1), dtype=torch.int32,
                        device=dev)[:e].contiguous()
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    return aq, asc, wgu, sgu, wd, sd, gs, bits


FFN_CASES = [([5, 0, 40, 64], 256, 128, 256),
             ([16] + [0] * 59, 2048, 1408, 2048),          # one live expert
             ([1, 3, 0, 2, 2, 1, 4, 3] + [0] * 52, 2048, 1408, 2048)]


@pytest.mark.parametrize("counts,k,n,h", FFN_CASES)
def test_gmm_ffn_w8a8_kernel_vs_plain(dev, counts, k, n, h):
    """K12 bitwise its plain version (the same f32 steps in order; torch's
    CUDA sigmoid is 1 / (1 + expf(-x)) as the kernel's); down bits 4 / 6 / 8,
    empty experts, the aligned layout's tail rows unwritten."""
    from mxmoe_tpu_torch.ops import gmm_ffn

    aq, asc, wgu, sgu, wd, sd, gs, bits = _ffn_operands(dev, counts, k, n, h, k + n)
    rows = int(gs.sum())
    for out in (torch.bfloat16, torch.float32):
        before = kernels.launches["gmm_ffn_w8a8"]
        got = gmm_ffn.gmm_ffn_w8a8(aq, asc, wgu, sgu, wd, sd, gs, bits, out)
        plain = gmm_ffn.gmm_ffn_w8a8_plain(aq, asc, wgu, sgu, wd, sd, gs, bits, out)
        torch.cuda.synchronize()
        assert kernels.launches["gmm_ffn_w8a8"] == before + 1
        assert torch.equal(got[:rows], plain[:rows])


@pytest.mark.parametrize("counts,k,n,h", FFN_CASES)
@pytest.mark.parametrize("packing", ["none", "alternating", "all"])
def test_gmm_ffn_mixed_packed_kernel_bitwise(dev, counts, k, n, h, packing):
    """K13 bitwise its plain version and K12 on the equivalent int8 codes."""
    from mxmoe_tpu_torch.ops import gmm_ffn

    aq, asc, wgu, sgu, wd, sd, gs, bits = _ffn_operands(dev, counts, k, n, h, 7 + k)
    e = gs.numel()
    pf = {"none": [0] * e, "alternating": [int(i % 2 == 0) for i in range(e)],
          "all": [1] * e}[packing]
    pfb = torch.tensor(pf, dtype=torch.bool, device=dev)[:, None, None]
    wgu = torch.where(pfb, wgu.clamp(-8, 7), wgu)
    wd = torch.where(pfb, wd.clamp(-8, 7), wd)
    gu_cat, gu_blk = build_ragged_mixed(wgu, pf)
    d_cat, d_blk = build_ragged_mixed(wd, pf)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    rows = int(gs.sum())
    got = gmm_ffn.gmm_ffn_mixed_packed(aq, asc, gu_cat, sgu, i32(pf), i32(gu_blk),
                                       d_cat, sd, i32(pf), i32(d_blk), gs, bits)
    plain = gmm_ffn.gmm_ffn_mixed_packed_plain(aq, asc, gu_cat, sgu, i32(pf),
                                               i32(gu_blk), d_cat, sd, i32(pf),
                                               i32(d_blk), gs, bits)
    k12 = gmm_ffn.gmm_ffn_w8a8(aq, asc, wgu, sgu, wd, sd, gs, bits)
    torch.cuda.synchronize()
    assert torch.equal(got[:rows], k12[:rows])
    assert torch.equal(got[:rows], plain[:rows])


def _ffn_k12_k13(dev, aq, asc, wgu, sgu, wd, sd, gs, bits, pf, rows):
    """K12 and K13 (experts with pf[e] packed, their codes clipped to the
    4-bit range) bitwise their plain versions and each other, each launch
    counted once, for both output types."""
    from mxmoe_tpu_torch.ops import gmm_ffn

    pfb = torch.tensor(pf, dtype=torch.bool, device=dev)[:, None, None]
    wgu = torch.where(pfb, wgu.clamp(-8, 7), wgu)
    wd = torch.where(pfb, wd.clamp(-8, 7), wd)
    gu_cat, gu_blk = build_ragged_mixed(wgu, pf)
    d_cat, d_blk = build_ragged_mixed(wd, pf)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    meta = (i32(pf), i32(gu_blk), i32(pf), i32(d_blk))
    for out in (torch.bfloat16, torch.float32):
        n12, n13 = kernels.launches["gmm_ffn_w8a8"], kernels.launches["gmm_ffn_mixed_packed"]
        k12 = gmm_ffn.gmm_ffn_w8a8(aq, asc, wgu, sgu, wd, sd, gs, bits, out)
        k13 = gmm_ffn.gmm_ffn_mixed_packed(aq, asc, gu_cat, sgu, meta[0], meta[1], d_cat,
                                           sd, meta[2], meta[3], gs, bits, out)
        assert kernels.launches["gmm_ffn_w8a8"] == n12 + 1
        assert kernels.launches["gmm_ffn_mixed_packed"] == n13 + 1
        p12 = gmm_ffn.gmm_ffn_w8a8_plain(aq, asc, wgu, sgu, wd, sd, gs, bits, out)
        p13 = gmm_ffn.gmm_ffn_mixed_packed_plain(aq, asc, gu_cat, sgu, meta[0], meta[1],
                                                 d_cat, sd, meta[2], meta[3], gs, bits,
                                                 out)
        torch.cuda.synchronize()
        assert torch.equal(k12[:rows], p12[:rows])
        assert torch.equal(k13[:rows], p13[:rows])
        assert torch.equal(k13[:rows], k12[:rows])


# row counts on the edges of the cluster's m16 / m32 fragments, unaligned (a
# tile straddles two experts); N 192 / H 132: CTAs owning 1 or 2 h units, a
# down tail narrower than a 16-byte piece, a packed down k-tile half full
FFN_EDGES = [([1, 16, 0, 17, 32, 33, 64], 256, 256, 128),
             ([1, 16, 0, 17, 32, 33, 64], 2048, 1408, 2048),
             ([3, 0, 20, 33, 1], 128, 192, 132)]


@pytest.mark.parametrize("counts,k,n,h", FFN_EDGES)
@pytest.mark.parametrize("packing", ["none", "alternating", "all"])
def test_gmm_ffn_kernels_at_row_count_edges(dev, counts, k, n, h, packing):
    aq, asc, wgu, sgu, wd, sd, gs, bits = _ffn_operands(dev, counts, k, n, h, n + h,
                                                        align=1)
    e = gs.numel()
    pf = {"none": [0] * e, "alternating": [int(i % 2 == 0) for i in range(e)],
          "all": [1] * e}[packing]
    _ffn_k12_k13(dev, aq, asc, wgu, sgu, wd, sd, gs, bits, pf, int(gs.sum()))


@pytest.mark.parametrize("tokens", [4, 16, 256])
def test_gmm_ffn_kernels_at_the_serving_shapes(dev, tokens):
    """qwen2_moe's widths over the 32-row aligned dispatch, as the fused
    branch routes them: decode (4 tokens, M 1876; 16 tokens) and a
    256-token prefill chunk, every other expert packed for K13."""
    from mxmoe_tpu_torch.models.configs import QWEN2_MOE_A2_7B as cfg
    from mxmoe_tpu_torch.ops.dispatch import make_dispatch, route_topk

    h, n, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
    g = torch.Generator(device=dev).manual_seed(tokens)
    disp = make_dispatch(route_topk(torch.randn((tokens, e), generator=g, device=dev),
                                    cfg.top_k, cfg.norm_topk_prob), e, align=32)
    gs = disp.group_sizes
    m = disp.token_ids.numel()
    _, _, wgu, sgu, wd, sd, _, bits = _ffn_operands(dev, [1] * e, h, n, h, tokens)
    aq = torch.randint(-127, 128, (m, h), generator=g, device=dev, dtype=torch.int8)
    asc = torch.rand((m, 1), generator=g, device=dev) * 0.02 + 1e-3
    pf = [int(i % 2 == 0) for i in range(e)]
    _ffn_k12_k13(dev, aq, asc, wgu, sgu, wd, sd, gs, bits, pf, int(gs.sum()))


# the read-only decode attention (decode_attention_stacked bf16 / int8,
# decode_attention, decode_attention_q8): K3's bodies without the write
_READ_ONLY = [(2, 128, 128, 128, torch.float32), (4, 64, 64, 1000, torch.bfloat16),
              (1, 256, 128, 2048, torch.bfloat16), (7, 128, 128, 300, torch.float32)]


def _read_only_caches(g, dev, quant, nl, b, n_kv, s_max, dk, dv):
    if quant:
        def codes(d):
            return torch.randint(-127, 128, (nl, b, n_kv, s_max, d), generator=g,
                                 device=dev, dtype=torch.int8)

        def scales():
            return torch.rand((nl, b, n_kv, s_max), generator=g, device=dev) * 0.03 + 1e-3

        return [codes(dk), scales(), codes(dv), scales()]
    return [torch.randn((nl, b, n_kv, s_max, d), generator=g, device=dev)
            .to(torch.bfloat16) if d else None for d in (dk, 0, dv, 0)]


@pytest.mark.parametrize("groups,dk,dv,s_max,dtype", _READ_ONLY)
@pytest.mark.parametrize("quant", [False, True])
def test_decode_attention_read_only_kernels_vs_plain(dev, groups, dk, dv, s_max,
                                                     dtype, quant):
    """Each read-only form within K3's per-slot bound of its plain version;
    nothing written; lengths 0, mid, S - 1, S and past S; the per-layer forms
    give the stacked form's output on the same layer."""
    g = torch.Generator(device=dev).manual_seed(groups * dk + quant)
    nl, b, n_kv, layer = 2, 5, 2, 1
    n_h = n_kv * groups
    caches = _read_only_caches(g, dev, quant, nl, b, n_kv, s_max, dk, dv)
    before = [None if c is None else c.clone() for c in caches]
    q = torch.randn((b, n_h, dk), generator=g, device=dev).to(dtype)
    lengths = torch.tensor([0, s_max // 2, s_max - 1, s_max, s_max + 9],
                           dtype=torch.int32, device=dev)
    scale = 0.77 / dk ** 0.5
    name = "decode_attention_stacked" + ("_q8" if quant else "")
    n0 = kernels.launches[name]
    out, ret = da.decode_attention_stacked(q, *caches, lengths, layer, scale=scale)
    ref = da.decode_attention_stacked_plain(q, *caches, lengths, layer, scale)
    if quant:
        per_layer = da.decode_attention_q8(q, *(c[layer] for c in caches), lengths,
                                           scale=scale)
        counter = "decode_attention_q8"
    else:
        per_layer = da.decode_attention(q, caches[0][layer], caches[2][layer],
                                        lengths, scale=scale)
        counter = "decode_attention"
    torch.cuda.synchronize()
    assert kernels.launches[name] == n0 + 1 and kernels.launches[counter] >= 1
    assert all(r is c for r, c in zip(ret, [c for c in caches if c is not None]))
    for c, c0 in zip(caches, before):
        assert c is None or torch.equal(c, c0)
    _assert_within_slot_bound(out, ref, dtype)
    assert torch.equal(per_layer, out)


@pytest.mark.parametrize("quant", [False, True])
def test_decode_attention_stacked_bitwise_the_update_after_its_write(dev, quant):
    """On the cache K3 / K3q has just written, with the same q, the
    read-only stacked form gives K3's output bit for bit (one body)."""
    g = torch.Generator(device=dev).manual_seed(17 + quant)
    nl, b, n_kv, groups, dk, dv, s_max, layer = 2, 4, 16, 1, 256, 128, 2048, 1
    caches = _read_only_caches(g, dev, quant, nl, b, n_kv, s_max, dk, dv)
    q = torch.randn((b, n_kv * groups, dk), generator=g, device=dev).to(torch.bfloat16)
    kn = torch.randn((b, n_kv, dk), generator=g, device=dev).to(torch.bfloat16)
    vn = torch.randn((b, n_kv, dv), generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.tensor([0, 700, s_max, 1500], dtype=torch.int32, device=dev)
    valid = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device=dev)
    scale = 1.0 / 192 ** 0.5
    upd, _ = da.decode_attention_update_stacked(q, kn, vn, *caches, lengths, layer,
                                                valid=valid, scale=scale)
    ro, _ = da.decode_attention_stacked(q, *caches, lengths, layer, scale=scale)
    torch.cuda.synchronize()
    assert torch.equal(ro, upd)


def test_read_only_wrappers_reject_bad_input(dev):
    q = torch.zeros((2, 4, 32), dtype=torch.bfloat16, device=dev)
    c = torch.zeros((1, 2, 2, 64, 32), dtype=torch.bfloat16, device=dev)
    lens = torch.zeros((2,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="dk in 64/128/256"):      # dk 32
        da.decode_attention_stacked(q, c, None, c, None, lens, 0)
    q = torch.zeros((2, 4, 64), dtype=torch.bfloat16, device=dev)
    c = torch.zeros((1, 2, 2, 64, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="layer"):
        da.decode_attention_stacked(q, c, None, c, None, lens, 1)
    with pytest.raises(ValueError, match="lengths"):
        da.decode_attention(q, c[0], c[0], lens.long())
    with pytest.raises(ValueError, match="per-layer"):
        da.decode_attention(q, c, c, lens)


def test_fused_ffn_refuses_a_width_whose_h_row_does_not_fit(dev):
    """Mixtral's expert N 14336: K12's f32 h row [32, N] exceeds a block's
    shared memory, and the wrapper says so (no silent detour)."""
    from mxmoe_tpu_torch.ops import gmm_ffn

    k, n, h, e = 256, 14336, 256, 2
    aq = torch.zeros((4, k), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        gmm_ffn.gmm_ffn_w8a8(
            aq, torch.ones((4, 1), device=dev),
            torch.zeros((e, k, 2 * n), dtype=torch.int8, device=dev),
            torch.ones((e, 1, 2 * n), device=dev),
            torch.zeros((e, n, h), dtype=torch.int8, device=dev),
            torch.ones((e, 1, h), device=dev),
            torch.tensor([4, 0], dtype=torch.int32, device=dev))


@pytest.mark.parametrize("n,h,fits", [(1408, 4100, True), (1536, 2048, True),
                                      (2560, 256, False), (14336, 256, False)])
def test_fused_ffn_width_domain(dev, n, h, fits):
    """The cluster layout takes every N the single-block body took (N % 64
    == 0 up to 1536, any H % 4: at H 4100 a CTA runs three down passes and
    a tail narrower than a 16-byte piece), bitwise its plain version; it
    refuses qwen2_moe_57b's N 2560 and mixtral's 14336 with the message of
    the test above."""
    from mxmoe_tpu_torch.ops import gmm_ffn

    aq, asc, wgu, sgu, wd, sd, gs, bits = _ffn_operands(dev, [3, 0, 20], 64, n, h, n,
                                                        align=1)
    if not fits:
        with pytest.raises(ValueError, match="shared memory"):
            gmm_ffn.gmm_ffn_w8a8(aq, asc, wgu, sgu, wd, sd, gs, bits)
        return
    rows = int(gs.sum())
    got = gmm_ffn.gmm_ffn_w8a8(aq, asc, wgu, sgu, wd, sd, gs, bits)
    plain = gmm_ffn.gmm_ffn_w8a8_plain(aq, asc, wgu, sgu, wd, sd, gs, bits)
    torch.cuda.synchronize()
    assert torch.equal(got[:rows], plain[:rows])


def test_flash_attention_backend_on_the_card(dev):
    """``attn_backend="flash"`` takes the stock scaled_dot_product_attention
    on a card (GQA, causal): within 4 bf16 ulps of max|out| of the einsum
    backend's output (both round their probabilities to bf16 before P.V, at
    other points of the softmax; a wrong mask or scale moves outputs by
    tenths); the full forward runs through it."""
    from mxmoe_tpu_torch.models import configs, layers, model
    from mxmoe_tpu_torch.models.layers import MoEImpl

    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((2, 96, 8, 128), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((2, 96, 2, 128), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((2, 96, 2, 128), generator=g, device=dev).to(torch.bfloat16)
    flash = layers.attention(q, k, v, backend="flash").float()
    xla = layers.attention(q, k, v, backend="xla").float()
    ulp = torch.exp2(torch.floor(torch.log2(xla.abs().max())) - 7)
    assert (flash - xla).abs().max() <= 4 * ulp
    cfg = configs.tiny_mixtral()
    params = model.init_params(cfg, g, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device=dev, generator=g)
    out = model.forward_logits(params, toks, cfg, MoEImpl(attn_backend="flash"))
    torch.cuda.synchronize()
    assert out.shape == (2, 64, cfg.vocab_size) and bool(torch.isfinite(out).all())


# the int8 grouped GEMM's decode schedule (m16 tiles, cp.async ring, split-K)
# and its prefill tile, through K2 / K4 / K5 / K9 at every M of the schedule's
# edges: each bitwise its plain version, K4 = K5 = K2 on the same codes
_SCHED_M = [1, 4, 16, 17, 24, 64, 65, 256]


def _spread(m, e, seed):
    """m rows over e groups, some empty: a decode routing."""
    g = torch.Generator().manual_seed(seed)
    counts = torch.bincount(torch.randint(0, e, (m,), generator=g), minlength=e)
    counts[1] = 0
    counts[0] += m - int(counts.sum())
    return counts.tolist()


@pytest.mark.parametrize("m", _SCHED_M)
@pytest.mark.parametrize("layout", ["routed", "one_group"])
def test_int8_gemm_schedules_bitwise_k2_k4_k5_k9(dev, m, layout):
    from mxmoe_tpu_torch.ops.gmm_w8a8 import int8_gmm_schedule

    if layout == "routed":
        sizes, k, n = _spread(m, 12, m), 1408, 2048
    else:                            # one group: the shared expert, split-K
        sizes, k, n = [m], 2048, 1024
    e = len(sizes)
    sched = int8_gmm_schedule(m, k, n, e)
    assert (sched.bm == 16) == (m <= 64)
    if layout == "one_group" and m <= 16:
        assert sched.splits > 1
    g = torch.Generator(device=dev).manual_seed(m + k)
    aq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    asc = torch.rand((m, 1), generator=g, device=dev) * 0.05
    w4 = torch.randint(-8, 8, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    wsc = torch.rand((e, 1, n), generator=g, device=dev) * 0.01
    zp = torch.rand((e, 1, n), generator=g, device=dev) * 0.2 - 0.1
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    for out in (torch.bfloat16, torch.float32):
        k2 = gmm_w8a8.gmm_w8a8(aq, asc, w8, wsc, gs, out_dtype=out)
        k9 = gmm_w8a8_asym.gmm_w8a8_asym(aq, asc, w8, wsc, zp, gs, out_dtype=out)
        k2_4 = gmm_w8a8.gmm_w8a8(aq, asc, w4, wsc, gs, out_dtype=out)
        packed = pack_int4_halves(w4)
        k5 = gmm_w4a8_packed.gmm_w4a8_packed(aq, asc, packed, wsc, gs, out_dtype=out)
        pflags = [i % 2 for i in range(e)]
        mixed = torch.where(torch.tensor(pflags, dtype=torch.bool, device=dev)[:, None, None],
                            w4, w8)
        cat, blk = build_ragged_mixed(mixed, pflags)
        pf = torch.tensor(pflags, dtype=torch.int32, device=dev)
        blk = torch.tensor(blk, dtype=torch.int32, device=dev)
        k4 = gmm_mixed_packed.gmm_mixed_packed(aq, asc, cat, wsc, gs, pf, blk,
                                               out_dtype=out)
        k2_mixed = gmm_w8a8.gmm_w8a8(aq, asc, mixed, wsc, gs, out_dtype=out)
        torch.cuda.synchronize()
        assert torch.equal(k2, gmm_w8a8.gmm_w8a8_plain(aq, asc, w8, wsc, gs, out))
        assert torch.equal(k9, gmm_w8a8_asym.gmm_w8a8_asym_plain(aq, asc, w8, wsc, zp,
                                                                  gs, out))
        assert torch.equal(k5, gmm_w4a8_packed.gmm_w4a8_packed_plain(
            aq, asc, packed, wsc, gs, out))
        assert torch.equal(k5, k2_4)
        assert torch.equal(k4, gmm_mixed_packed.gmm_mixed_packed_plain(
            aq, asc, cat, wsc, gs, pf, blk, out_dtype=out))
        assert torch.equal(k4, k2_mixed)


@pytest.mark.parametrize("m", _SCHED_M)
@pytest.mark.parametrize("layout", ["routed", "one_group"])
def test_grouped_gemm_schedules_bitwise_k8_k4f(dev, m, layout):
    """The grouped-scale GEMM's two schedules (``grouped_gmm_schedule``: the
    m16 ring kernel with split-K at whole groups up to M 64, the 32-row tile
    above) through K8 and K4f at g128 (K 1408: group 5 spans the packed
    halves) and with one group, without and with zero points: each bitwise
    its plain version, K4f (every other expert packed) bitwise K8 on the
    same codes."""
    from mxmoe_tpu_torch.ops.gmm_w8a8_grouped import grouped_gmm_schedule

    if layout == "routed":
        sizes, k, n = _spread(m, 12, m + 1), 1408, 2048
    else:                            # one group of rows: split-K at decode
        sizes, k, n = [m], 2048, 1024
    e = len(sizes)
    g = torch.Generator(device=dev).manual_seed(m + k + 1)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    aq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    w4 = torch.randint(-8, 8, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    pflags = [i % 2 for i in range(e)]
    mixed = torch.where(torch.tensor(pflags, dtype=torch.bool, device=dev)[:, None, None],
                        w4, w8)
    cat, blk = build_ragged_mixed(mixed, pflags)
    pf = torch.tensor(pflags, dtype=torch.int32, device=dev)
    blk = torch.tensor(blk, dtype=torch.int32, device=dev)
    for gsize in (128, -1):
        groups = 1 if gsize == -1 else k // gsize
        sched = grouped_gmm_schedule(m, k, n, e, k if gsize == -1 else gsize)
        assert (sched.bm == 16) == (m <= 64)
        if layout == "one_group" and m <= 16:
            assert sched.splits > 1
        asc = torch.rand((m, groups), generator=g, device=dev) * 0.05
        wsc = torch.rand((e, groups, n), generator=g, device=dev) * 0.01
        wzp = torch.randn((e, groups, n), generator=g, device=dev) * 0.02
        for zp, out in ((None, torch.bfloat16), (wzp, torch.float32)):
            if zp is None and gsize == -1:
                continue             # per channel without zp: K4's form, not K4f
            k8 = gmm_w8a8_grouped.gmm_w8a8_grouped(aq, asc, w8, wsc, gs, gsize, zp,
                                                   out_dtype=out)
            k4f = gmm_mixed_packed.gmm_mixed_packed(aq, asc, cat, wsc, gs, pf, blk,
                                                    rhs_zp=zp, out_dtype=out)
            k8_mixed = gmm_w8a8_grouped.gmm_w8a8_grouped(aq, asc, mixed, wsc, gs,
                                                         gsize, zp, out_dtype=out)
            torch.cuda.synchronize()
            assert torch.equal(k8, gmm_w8a8_grouped.gmm_w8a8_grouped_plain(
                aq, asc, w8, wsc, gs, gsize, zp, out_dtype=out))
            assert torch.equal(k4f, gmm_mixed_packed.gmm_mixed_packed_plain(
                aq, asc, cat, wsc, gs, pf, blk, rhs_zp=zp, out_dtype=out))
            assert torch.equal(k4f, k8_mixed)


@pytest.mark.parametrize("m", _SCHED_M)
@pytest.mark.parametrize("layout", ["routed", "one_group"])
def test_weight_only_schedules_k6_k7_k10(dev, m, layout):
    """The weight-only GEMMs' two schedules (``weight_only_gmm_schedule``, one
    for K6, K7 and K10: the m16 ring body with split-K over byte-tile pairs up
    to M 64, the 32-row tile above), routed over 12 groups (two empty, K 1408:
    g128 group 5 spans the halves) and as one group (split-K at decode), at
    g128 with zero points and per channel: K6 within ``error_over_bound`` of
    the float64 product and the same bits on a second launch, K7 bitwise K6,
    K10's weight-only rows bitwise K6 and its w x a rows bitwise K8 (and K2
    per channel without zero points)."""
    from mxmoe_tpu_torch.ops.gmm_w8a8_grouped import weight_only_gmm_schedule

    if layout == "routed":
        sizes, k, n = _spread(m, 12, m + 2), 1408, 2048
        sizes[0] += sizes[5]
        sizes[5] = 0
    else:
        sizes, k, n = [m], 2048, 1024
    e = len(sizes)
    g = torch.Generator(device=dev).manual_seed(m + k + 3)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    aq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    w4 = torch.randint(-8, 8, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    packed = pack_int4_halves(w4)
    fl = torch.tensor([i % 2 for i in range(e)], dtype=torch.int32, device=dev)
    wo_rows = torch.repeat_interleave(fl, gs.long()).bool()
    for gsize in (128, -1):
        groups = 1 if gsize == -1 else k // gsize
        sched = weight_only_gmm_schedule(m, k, n, e, k if gsize == -1 else gsize)
        assert (sched.bm == 16) == (m <= 64)
        if layout == "one_group" and m <= 16:
            assert sched.splits > 1
        sc = torch.rand((e, groups, n), generator=g, device=dev) * 0.02 + 1e-3
        zp = torch.randn((e, groups, n), generator=g, device=dev) * 0.05
        zp10 = zp if gsize == 128 else None
        zp6 = zp if gsize == 128 else torch.zeros_like(sc)
        asc = torch.rand((m, groups), generator=g, device=dev) * 0.05
        for out in (torch.bfloat16, torch.float32):
            k6 = gmm_weight_only.gmm_weight_only(x, w4, sc, zp6, gs, gsize,
                                                 out_dtype=out)
            again = gmm_weight_only.gmm_weight_only(x, w4, sc, zp6, gs, gsize,
                                                    out_dtype=out)
            k7 = gmm_weight_only_packed.gmm_weight_only_packed(
                x, packed, sc, zp6, gs, gsize, out_dtype=out)
            k10 = gmm_mixed_wo_wxa.gmm_mixed_wo_wxa(x, aq, asc, w4, sc, fl, gs,
                                                    rhs_zp=zp10, out_dtype=out)
            k8 = gmm_w8a8_grouped.gmm_w8a8_grouped(aq, asc, w4, sc, gs, gsize,
                                                   zp10, out_dtype=out)
            torch.cuda.synchronize()
            _, ratio = gmm_weight_only.error_over_bound(k6, x, w4, sc, zp6, gs,
                                                        gsize)
            assert ratio <= 1.0
            assert torch.equal(k6, again) and torch.equal(k7, k6)
            assert torch.equal(k10[wo_rows], k6[wo_rows])
            assert torch.equal(k10[~wo_rows], k8[~wo_rows])
            if zp10 is None:
                k2 = gmm_w8a8.gmm_w8a8(aq, asc, w4, sc, gs, out_dtype=out)
                assert torch.equal(k10[~wo_rows], k2[~wo_rows])


def test_grouped_gemm_split_k_tickets_reset_between_launches(dev):
    """K8's split-K launches one after another (the shared expert's down
    product: 11 splits of 4 groups) give the same bits every time."""
    g = torch.Generator(device=dev).manual_seed(6)
    k, n, groups = 5632, 2048, 44
    aq = torch.randint(-127, 128, (4, k), generator=g, device=dev, dtype=torch.int8)
    asc = torch.rand((4, groups), generator=g, device=dev)
    wq = torch.randint(-127, 128, (1, k, n), generator=g, device=dev, dtype=torch.int8)
    wsc = torch.rand((1, groups, n), generator=g, device=dev) * 0.01
    wzp = torch.randn((1, groups, n), generator=g, device=dev) * 0.02
    gs = torch.tensor([4], dtype=torch.int32, device=dev)
    ref = gmm_w8a8_grouped.gmm_w8a8_grouped_plain(aq, asc, wq, wsc, gs, 128, wzp)
    for _ in range(5):
        got = gmm_w8a8_grouped.gmm_w8a8_grouped(aq, asc, wq, wsc, gs, 128, wzp)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
    assert int(kernels.tickets(dev, 1).abs().sum()) == 0


def test_int8_gemm_split_k_tickets_reset_between_launches(dev):
    """Split-K launches one after another (the tickets left at 0 by each
    tile's last block) give the same bits every time."""
    g = torch.Generator(device=dev).manual_seed(5)
    aq = torch.randint(-127, 128, (4, 5632), generator=g, device=dev, dtype=torch.int8)
    asc = torch.rand((4, 1), generator=g, device=dev)
    wq = torch.randint(-127, 128, (1, 5632, 2048), generator=g, device=dev,
                       dtype=torch.int8)
    wsc = torch.rand((1, 1, 2048), generator=g, device=dev) * 0.01
    gs = torch.tensor([4], dtype=torch.int32, device=dev)
    ref = gmm_w8a8.gmm_w8a8_plain(aq, asc, wq, wsc, gs)
    for _ in range(5):
        got = gmm_w8a8.gmm_w8a8(aq, asc, wq, wsc, gs)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
    assert int(kernels.tickets(dev, 1).abs().sum()) == 0


@pytest.mark.parametrize("groups,dk", [(1, 256), (4, 128), (7, 128)])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_decode_attention_chunk_edges(dev, groups, dk, quant):
    """K3 / K3q at lengths on the warp-chunk (32) and block (128) edges:
    the write bitwise, the output within the per-slot bound, and the
    read-only form bitwise K3 / K3q after their write."""
    g = torch.Generator(device=dev).manual_seed(groups * dk + quant)
    nl, n_kv, s_max, layer, dv = 2, 2, 600, 0, 128
    lens = [0, 15, 16, 31, 32, 33, 63, 64, 65, 255, 256, 257, 511, 599, 600]
    b, n_h = len(lens), n_kv * groups
    caches = _read_only_caches(g, dev, quant, nl, b, n_kv, s_max, dk, dv)
    caches2 = [None if c is None else c.clone() for c in caches]
    q = torch.randn((b, n_h, dk), generator=g, device=dev).to(torch.bfloat16)
    kn = torch.randn((b, n_kv, dk), generator=g, device=dev).to(torch.bfloat16)
    vn = torch.randn((b, n_kv, dv), generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    valid = torch.ones((b,), dtype=torch.int32, device=dev)
    valid[3] = 0
    scale = 1.0 / dk ** 0.5
    out, _ = da.decode_attention_update_stacked(q, kn, vn, *caches, lengths, layer,
                                                valid=valid, scale=scale)
    if quant:
        ref = da.decode_attention_update_q8_plain(q, kn, vn, *caches2, lengths, layer,
                                                  valid, scale)
    else:
        ref = da.decode_attention_update_plain(q, kn, vn, caches2[0], caches2[2],
                                               lengths, layer, valid, scale)
    ro, _ = da.decode_attention_stacked(q, *caches, lengths, layer, scale=scale)
    torch.cuda.synchronize()
    for got, want in zip(caches, caches2):
        assert got is None or torch.equal(got, want)
    _assert_within_slot_bound(out, ref, torch.bfloat16)
    assert torch.equal(ro, out)
