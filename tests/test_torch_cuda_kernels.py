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
ulp for a bf16 output) of the float64 product, for bf16 and f32 operands;
its bf16 (wgmma) body at M 1-8192, groups at any row, empty groups, one
group, K 1408-14336 with a K tail, N 1024-5120 with an N tail, and rows
past the groups left as they were.
K12 (the whole FFN) bitwise its plain version, K13 bitwise its plain version
and K12 on the equivalent int8 codes (also at row counts on the edges of the
cluster body's m16 / m32 fragments with tiles straddling experts, at
qwen2_moe's decode and 256-token prefill shapes, each launch counted once,
over the width domain and at qwen2_moe_57b's widths on the 16-CTA cluster),
K14 bitwise its plain version and K1 +
K2, K15 bitwise K2 / K5 on the same aligned layout (at the four models' K,
512 groups, N no multiple of its tile; K % 64, N % 16 and 513 groups
refused), K1 at decode to headline row counts and K 1000-20480. The int8 grouped GEMM's
two schedules (``int8_gmm_schedule``: m16 tiles and split-K at decode, the
64-row tile above M 64) through K2 / K4 / K5 / K9 bitwise, the grouped-scale
GEMM's two (``grouped_gmm_schedule``: the m16 ring kernel with split-K at
whole groups, the 32-row tile above M 64) through K8 / K4f bitwise, the
weight-only GEMM's two (``weight_only_gmm_schedule``, one for K6, K7 and K10:
the m16 ring body with split-K over byte-tile pairs, the 32-row tile above
M 64) with K7 and K10's weight-only rows bitwise K6 and K10's w x a rows
bitwise K8, and K3 / K3q at lengths on the edges of their warp chunks and
S-blocks. The weight-quantized wgmma bodies above their thresholds (K6 / K7
/ K10's body A, K8 / K10's body B) at M 65-65536 and the four models'
expert widths with the same gates, K4f bitwise K8 on them, and shapes
outside their domains on the 32 x 128 bodies. K4 on K2's wgmma body and
K4f / K9 on body B over the ragged (K4, K4f) and stacked (K9) storage at M
65-65536 and the four models' widths, bitwise their plain versions and K2
/ K8 on the same codes, and outside their domains on the old tiles. The offline path on the card: an RTN convert bitwise the CPU's;
the GPTQ sweep (Cholesky, triangular inverse, blocked sweep) on the same W
and H with codes >= 99.9 % equal to the CPU's and its floats within 1e-5 of
the largest; the MoE Hessians within rtol 1e-5 of the CPU's; a whole GPTQ
convert with >= 99 % of each layer's codes equal (the float pass's order,
amplified; see CARD_CONVERT_AGREEMENT_MIN) and GPTQ's proxy loss within 5 %
of the CPU's. The captured decode step and prefill chunk
(``serving/graph.py``) bitwise their eager twins (logits, tokens and every
cache byte), the captured Engine bitwise the eager one, and the ticket
buffers a graph holds shown needed by a mutation run in a subprocess."""

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
                                       (300, 1408, torch.bfloat16),
                                       (9, 1003, torch.bfloat16),    # K % 8 != 0
                                       (7, 77, torch.float32),
                                       (19, 2048, torch.float32),
                                       (3, 6000, torch.float32)])    # a wide f32 row
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


@pytest.mark.parametrize("k", [1000, 2048, 5632, 20480])
@pytest.mark.parametrize("m", [1, 16, 1024, 36736])
def test_quantize_rows_kernel_bitwise_at_every_row_width(dev, m, k):
    """K1's bodies (a warp a row in registers up to 8 KB a row, a block a row
    above) at decode, prefill and the headline's row counts, with mixed 4 /
    8 / 16 bits and a gain."""
    g = torch.Generator(device=dev).manual_seed(m + k)
    x = (torch.randn((m, k), generator=g, device=dev) * 3).to(torch.bfloat16)
    bits = torch.tensor([4.0, 8.0, 16.0], device=dev).repeat(m)[:m].contiguous()
    q, s = act_quant.quantize_rows(x, bits, gain=1.0 - 2.9e-4)
    qp, sp = act_quant.quantize_rows_plain(x, bits, gain=1.0 - 2.9e-4)
    torch.cuda.synchronize()
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


def _summing_to(sizes, m):
    """``sizes`` with the first group grown or cut so that they sum to m."""
    return [sizes[0] + m - sum(sizes), *sizes[1:]]


# K11 with bf16 operands (its wgmma body): name -> (group sizes, K, N)
_BF16_BODY_CASES = {
    "m1": ([0, 1, 0], 2048, 2816),
    "m16_decode": ([1, 0, 2, 1, 3, 0, 1, 1, 2, 1, 0, 4], 2048, 2816),
    "m40_down": ([0, 5, 3, 1, 0, 7, 2, 9, 1, 0, 4, 8], 1408, 2048),
    "m64": ([1, 0, 20, 3, 40], 2048, 2816),
    "m65": ([1, 0, 20, 3, 41], 2048, 2816),
    "m127": ([60, 0, 67], 1408, 2048),
    "m129": ([1, 127, 0, 1], 2048, 2816),
    "chunk1024": (_summing_to([(i * 37) % 31 for i in range(59)] + [0], 1024), 2048,
                  2816),
    "chunk1024_down": (_summing_to([(i * 29) % 33 for i in range(60)], 1024), 1408,
                       2048),
    "m8192": (_summing_to([120 + (i * 53) % 37 for i in range(60)], 8192), 2048, 2816),
    "groups_at_any_row": ([37, 0, 200, 1, 0, 91, 130, 0], 1408, 2048),
    "one_group": ([777], 2048, 2816),
    "first_group_empty": ([0, 129, 127], 2048, 2816),
    "k4096": ([300, 3, 0, 250], 4096, 1024),
    "mixtral_down_k14336": ([130, 70, 2, 90], 14336, 4096),
    "57b_gate_up_n5120": ([33, 0, 250, 101], 3584, 5120),
    "k_tail_n_tail": ([50, 0, 170, 23], 1416, 1400),
}


@pytest.mark.parametrize("case", sorted(_BF16_BODY_CASES))
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32], ids=["obf16", "of32"])
def test_gmm_bf16_wgmma_within_bound(dev, case, out):
    """K11's bf16 body from the decode rows to 8192 rows: the wrapper's
    output within ``gmm.error_over_bound`` of the float64 product; a
    reference with the last k row's weights dropped lies outside it."""
    sizes, k, n = _BF16_BODY_CASES[case]
    m, e = sum(sizes), len(sizes)
    assert gmm_float.bf16_gmm_schedule().body == "wgmma"
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((e, k, n), generator=g, device=dev) * 0.05).to(torch.bfloat16)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    before = kernels.launches["gmm_bf16"]
    got = gmm_float.gmm_bf16(x, w, gs, out_dtype=out)
    torch.cuda.synchronize()
    assert kernels.launches["gmm_bf16"] == before + 1
    assert gmm_float.error_over_bound(got, x, w, gs)[1] <= 1.0
    w_m = w.clone()
    w_m[:, k - 1] = 0
    assert gmm_float.error_over_bound(got, x, w_m, gs)[1] > 1.0


def test_gmm_bf16_wgmma_body_leaves_rows_past_the_groups(dev):
    """The wgmma body (its C entry point): rows past sum(group_sizes),
    inside the last tile and past it, keep what the output held; a group
    past M is cut at M; every stored row is within the bound."""
    g = torch.Generator(device=dev).manual_seed(6)
    m, k, n = 700, 256, 512
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((3, k, n), generator=g, device=dev) * 0.05).to(torch.bfloat16)
    for sizes, rows in (([100, 0, 230], 330), ([400, 200, 300], 700)):
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        out = torch.full((m, n), float("nan"), device=dev)
        kernels.check(kernels.lib().mxmoe_gmm_bf16(
            x.data_ptr(), w.data_ptr(), gs.data_ptr(), out.data_ptr(), 1, 0, m, k, n, 3,
            kernels.stream_ptr(dev)), "gmm_bf16")
        torch.cuda.synchronize()
        assert not bool(torch.isnan(out[:rows]).any())
        assert bool(torch.isnan(out[rows:]).all())
        cut = torch.tensor([min(s, max(rows - sum(sizes[:i]), 0))
                            for i, s in enumerate(sizes)], dtype=torch.int32, device=dev)
        assert gmm_float.error_over_bound(out[:rows].contiguous(), x[:rows].contiguous(),
                                          w, cut)[1] <= 1.0


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
    ((256, 128, 0), 128, 1408, 2048),            # its down widths (K/2 = 704)
    ((0, 0, 48), 16, 128, 80),                   # N no multiple of the tile
    ((128, 0, 256), 128, 4096, 1024),            # mixtral's gate_up K
    ((128, 128), 128, 14336, 512),               # mixtral's down K
    ((0, 256, 128), 128, 3584, 768),             # qwen2_moe_57b's gate_up K
    ((128, 128), 128, 2560, 3584),               # its down K and N
    (tuple((i % 3) * 16 for i in range(512)), 16, 256, 256)])   # 512 groups
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


def test_gmm_ws_domain(dev):
    """K15 takes K a multiple of 64 at any width and N a multiple of 16, at
    most 512 groups; outside that its wrapper raises."""
    from mxmoe_tpu_torch.ops import gmm_ws

    def call(m, k, n, e, sizes):
        aq = torch.zeros((m, k), dtype=torch.int8, device=dev)
        return gmm_ws.gmm_w8a8_ws(aq, torch.ones((m, 1), device=dev),
                                  torch.zeros((e, k, n), dtype=torch.int8, device=dev),
                                  torch.ones((e, 1, n), device=dev), sizes, bm=16)

    assert call(16, 64, 16, 1, (16,)).shape == (16, 16)
    with pytest.raises(ValueError, match="multiple of 16"):
        call(16, 128, 72, 1, (16,))
    with pytest.raises(ValueError, match="multiple of 64"):
        call(16, 96, 64, 1, (16,))
    with pytest.raises(ValueError, match="at most 512"):
        call(16, 64, 16, 513, (16,) + (0,) * 512)


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
    q = torch.zeros((2, 4, 16), dtype=torch.bfloat16, device=dev)
    c = torch.zeros((1, 2, 2, 64, 16), dtype=torch.bfloat16, device=dev)
    lens = torch.zeros((2,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="dk in 32/64/128/256"):   # dk 16
        da.decode_attention_stacked(q, c, None, c, None, lens, 0)
    q = torch.zeros((2, 4, 64), dtype=torch.bfloat16, device=dev)
    c = torch.zeros((1, 2, 2, 64, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="layer"):
        da.decode_attention_stacked(q, c, None, c, None, lens, 1)
    with pytest.raises(ValueError, match="lengths"):
        da.decode_attention(q, c[0], c[0], lens.long())
    with pytest.raises(ValueError, match="per-layer"):
        da.decode_attention(q, c, c, lens)


def test_decode_step_outside_the_kernel_domain_raises(dev):
    """A cached decode step whose head dim (16) K3 cannot take raises on the
    card: no model is served by the plain attention there."""
    import dataclasses

    from mxmoe_tpu_torch.models import configs, model
    from mxmoe_tpu_torch.models.layers import MoEImpl
    from mxmoe_tpu_torch.serving import decode, kv_cache

    cfg = dataclasses.replace(configs.tiny_qwen2_moe(4, 2), head_dim=16)
    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               dtype=torch.float32, device=dev)
    cache = kv_cache.init_kv_cache(cfg, 2, 32, device=dev)
    toks = torch.ones((2, 4), dtype=torch.int32, device=dev)
    _, cache = decode.forward_cached(params, toks, cache, cfg, MoEImpl())
    with pytest.raises(ValueError, match="dk in 32/64/128/256"):
        decode.forward_cached(params, toks[:, :1], cache, cfg, MoEImpl())


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
                                      (2560, 3584, True), (14336, 256, False)])
def test_fused_ffn_width_domain(dev, n, h, fits):
    """The cluster layout takes every N the single-block body took (N % 64
    == 0 up to 1536, any H % 4: at H 4100 a CTA runs three down passes and
    a tail narrower than a 16-byte piece) on 8 CTAs, and qwen2_moe_57b's N
    2560 / H 3584 on 16 (the reference's kernel takes that width), bitwise
    its plain version; it refuses mixtral's 14336 with the message of the
    test above (the reference refuses it too)."""
    from mxmoe_tpu_torch.ops import gmm_ffn

    assert gmm_ffn.ffn_cluster_size(n) == {1408: 8, 1536: 8, 2560: 16, 14336: 0}[n]
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


@pytest.mark.parametrize("tokens", [4, 256])
def test_gmm_ffn_kernels_at_qwen2_moe_57b_widths(dev, tokens):
    """qwen2_moe_57b's experts (K 3584, N 2560, H 3584, 64 experts, top-8)
    over the 32-row aligned dispatch, as the fused branch routes a decode
    step of 4 tokens and a 256-token chunk (2048 routed rows, where "auto"
    still fuses): K12 and K13 (every other expert packed) on the 16-CTA
    cluster bitwise their plain versions and each other; qwen2_moe's and
    ds2's N 1408 keep the 8-CTA one."""
    from mxmoe_tpu_torch.models.configs import QWEN2_MOE_57B as cfg
    from mxmoe_tpu_torch.ops import gmm_ffn
    from mxmoe_tpu_torch.ops.dispatch import make_dispatch, route_topk

    assert gmm_ffn.ffn_cluster_size(1408) == 8
    assert gmm_ffn.ffn_cluster_size(cfg.moe_intermediate_size) == 16
    h, n, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
    assert gmm_ffn.resident_clusters(n, h) > 0
    assert gmm_ffn.resident_clusters(n, h, ragged=True) > 0
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
    """The grouped-scale GEMM's schedules (``grouped_gmm_schedule``: the
    m16 ring kernel with split-K at whole groups up to M 64, the wgmma body
    B above, through the wrappers) through K8 and K4f at g128 (K 1408: group 5 spans the packed
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


# (model, projection, routed rows) of the wgmma bodies' cases: qwen2_moe's
# gate_up from just above the decode rows to the profiler's largest scale,
# and the chunk of every model's two expert products
_WQ_CASES = ([("qwen2_moe", "gate_up", m) for m in (65, 1024, 8192, 65536)]
             + [(model, proj, 1024) for model in ("qwen2_moe", "mixtral", "qwen2_moe_57b")
                for proj in ("gate_up", "down") if (model, proj) != ("qwen2_moe", "gate_up")])


@pytest.mark.parametrize("model,proj,m", _WQ_CASES)
def test_wgmma_bodies_k6_k7_k8_k10_k4f(dev, model, proj, m):
    """The weight-quantized wgmma bodies (``gmm_wq_body.cuh``) at the models'
    expert widths, routed rows over the model's experts: K6 at g128 with
    zero points within ``error_over_bound`` of the float64 product, K7
    bitwise K6, K10 (experts alternating) weight-only rows bitwise K6 and
    w x a rows bitwise K8; K8 without and with zero points and with one
    group bitwise its plain version (with one group and no zp bitwise K2,
    and K10's w x a rows too); K4f (every other expert packed, on body B
    since its storage took it) bitwise K8. Each wrapper's schedule is the
    one its threshold says."""
    from mxmoe_tpu_torch.models import configs
    from mxmoe_tpu_torch.ops.gmm_w8a8_grouped import (
        GROUPED_WGMMA_MIN_M, WO_WGMMA_MIN_M, grouped_gmm_schedule,
        weight_only_gmm_schedule)

    cfg = configs.config_for(model)
    h, nn, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
    k, n = (h, 2 * nn) if proj == "gate_up" else (nn, h)
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    sizes = torch.bincount(torch.randint(0, e, (m,), generator=g, device=dev),
                           minlength=e)
    gs = sizes.to(torch.int32)
    gsize, groups = 128, k // 128
    assert (weight_only_gmm_schedule(m, k, n, e, gsize).bm == 128) == (m >= WO_WGMMA_MIN_M)
    assert (grouped_gmm_schedule(m, k, n, e, gsize, wgmma=True).bm == 128) == (
        m >= GROUPED_WGMMA_MIN_M)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    aq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    asc = torch.rand((m, groups), generator=g, device=dev) * 0.05 + 1e-3
    w4 = torch.randint(-8, 8, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    sc = torch.rand((e, groups, n), generator=g, device=dev) * 0.02 + 1e-3
    zp = torch.randn((e, groups, n), generator=g, device=dev) * 0.05
    fl = torch.tensor([i % 2 for i in range(e)], dtype=torch.int32, device=dev)
    wo_rows = torch.repeat_interleave(fl, gs.long()).bool()
    k6 = gmm_weight_only.gmm_weight_only(x, w4, sc, zp, gs, gsize)
    k7 = gmm_weight_only_packed.gmm_weight_only_packed(x, pack_int4_halves(w4), sc, zp,
                                                       gs, gsize)
    k10 = gmm_mixed_wo_wxa.gmm_mixed_wo_wxa(x, aq, asc, w4, sc, fl, gs, rhs_zp=zp)
    k8_w4 = gmm_w8a8_grouped.gmm_w8a8_grouped(aq, asc, w4, sc, gs, gsize, zp)
    torch.cuda.synchronize()
    _, ratio = gmm_weight_only.error_over_bound(k6, x, w4, sc, zp, gs, gsize)
    assert ratio <= 1.0
    assert torch.equal(k7, k6)
    assert torch.equal(k10[wo_rows], k6[wo_rows])
    assert torch.equal(k10[~wo_rows], k8_w4[~wo_rows])
    del k6, k7, k10, k8_w4
    w8 = torch.randint(-127, 128, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    for z in (None, zp):
        k8 = gmm_w8a8_grouped.gmm_w8a8_grouped(aq, asc, w8, sc, gs, gsize, z)
        torch.cuda.synchronize()
        assert torch.equal(k8, gmm_w8a8_grouped.gmm_w8a8_grouped_plain(
            aq, asc, w8, sc, gs, gsize, z))
    asc1, sc1 = asc[:, :1].contiguous(), sc[:, :1].contiguous()
    k8 = gmm_w8a8_grouped.gmm_w8a8_grouped(aq, asc1, w8, sc1, gs, -1)
    k2 = gmm_w8a8.gmm_w8a8(aq, asc1, w8, sc1, gs)
    k10 = gmm_mixed_wo_wxa.gmm_mixed_wo_wxa(x, aq, asc1, w8, sc1, fl, gs)
    torch.cuda.synchronize()
    assert torch.equal(k8, k2) and torch.equal(k10[~wo_rows], k2[~wo_rows])
    pflags = [i % 2 for i in range(e)]
    mixed = torch.where(torch.tensor(pflags, dtype=torch.bool, device=dev)[:, None, None],
                        w4, w8)
    cat, blk = build_ragged_mixed(mixed, pflags)
    k4f = gmm_mixed_packed.gmm_mixed_packed(
        aq, asc, cat, sc, gs, torch.tensor(pflags, dtype=torch.int32, device=dev),
        torch.tensor(blk, dtype=torch.int32, device=dev), rhs_zp=zp)
    k8 = gmm_w8a8_grouped.gmm_w8a8_grouped(aq, asc, mixed, sc, gs, gsize, zp)
    torch.cuda.synchronize()
    assert torch.equal(k4f, k8)


@pytest.mark.parametrize("k,n,gsize", [(2048, 2040, 128), (2048, 2816, 64),
                                       (1472, 2048, 1472)])
def test_wgmma_bodies_out_of_domain_take_the_32_row_bodies(dev, k, n, gsize):
    """N % 16 != 0, groups of 64 codes and K % 128 != 0 (body A) keep K6 / K7
    / K10 on the 32 x 128 bodies (and K8 where body B's domain ends), with
    the same checks: K6 within its bound, K7 and K10's weight-only rows
    bitwise K6, K8 and K10's w x a rows bitwise K8's plain version."""
    from mxmoe_tpu_torch.ops.gmm_w8a8_grouped import (
        grouped_gmm_schedule, grouped_wgmma_domain, weight_only_gmm_schedule)

    m, e = 1024, 8
    assert weight_only_gmm_schedule(m, k, n, e, gsize).bm == 32
    assert (grouped_gmm_schedule(m, k, n, e, gsize, wgmma=True).bm == 128) == \
        grouped_wgmma_domain(m, k, n, gsize, True)
    g = torch.Generator(device=dev).manual_seed(k + n + gsize)
    gs = torch.tensor(_spread(m, e, 5), dtype=torch.int32, device=dev)
    groups = k // gsize
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    aq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    asc = torch.rand((m, groups), generator=g, device=dev) * 0.05 + 1e-3
    w4 = torch.randint(-8, 8, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    sc = torch.rand((e, groups, n), generator=g, device=dev) * 0.02 + 1e-3
    zp = torch.randn((e, groups, n), generator=g, device=dev) * 0.05
    fl = torch.tensor([i % 2 for i in range(e)], dtype=torch.int32, device=dev)
    wo_rows = torch.repeat_interleave(fl, gs.long()).bool()
    k6 = gmm_weight_only.gmm_weight_only(x, w4, sc, zp, gs, gsize)
    k7 = gmm_weight_only_packed.gmm_weight_only_packed(x, pack_int4_halves(w4), sc, zp,
                                                       gs, gsize)
    k10 = gmm_mixed_wo_wxa.gmm_mixed_wo_wxa(x, aq, asc, w4, sc, fl, gs, rhs_zp=zp)
    k8 = gmm_w8a8_grouped.gmm_w8a8_grouped(aq, asc, w4, sc, gs, gsize, zp)
    torch.cuda.synchronize()
    assert gmm_weight_only.error_over_bound(k6, x, w4, sc, zp, gs, gsize)[1] <= 1.0
    assert torch.equal(k7, k6) and torch.equal(k10[wo_rows], k6[wo_rows])
    assert torch.equal(k8, gmm_w8a8_grouped.gmm_w8a8_grouped_plain(
        aq, asc, w4, sc, gs, gsize, zp))
    assert torch.equal(k10[~wo_rows], k8[~wo_rows])


# (model, projection, routed rows) of K4 / K4f / K9 on the wgmma bodies:
# qwen2_moe's gate_up from just above the decode rows to the profiler's
# largest scale, and the chunk of every model's two expert products
_RAGGED_CASES = ([("qwen2_moe", "gate_up", m) for m in (65, 1024, 8192, 65536)]
                 + [(model, proj, 1024)
                    for model in ("qwen2_moe", "ds2", "mixtral", "qwen2_moe_57b")
                    for proj in ("gate_up", "down") if (model, proj) != ("qwen2_moe",
                                                                        "gate_up")])


def _ragged(w4, w8, pflags, dev):
    """The mixed storage of ``pflags`` over the same codes -> (codes,
    rhs_cat, pflags, blk_offsets)."""
    pfb = torch.tensor(pflags, dtype=torch.bool, device=dev)
    codes = torch.where(pfb[:, None, None], w4, w8)
    cat, blk = build_ragged_mixed(codes, pflags)
    return (codes, cat, pfb.to(torch.int32),
            torch.tensor(blk, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("model,proj,m", _RAGGED_CASES)
def test_wgmma_bodies_k4_k4f_k9(dev, model, proj, m):
    """K4, K4f and K9 above the decode rows on the wgmma bodies, at the
    models' expert widths, routed rows over the model's experts: K4 (every
    other expert packed) bitwise its plain version and K2 on the same codes;
    K4f at g128 with zero points (every other expert packed, and all) and
    with one group bitwise its plain version and K8 on the same codes; K9
    bitwise its plain version and K8 with one group and zero points. Each
    wrapper's schedule is the wgmma body's from M 65 on."""
    from mxmoe_tpu_torch.models import configs
    from mxmoe_tpu_torch.ops.gmm_w8a8 import int8_gmm_schedule
    from mxmoe_tpu_torch.ops.gmm_w8a8_grouped import grouped_gmm_schedule

    cfg = configs.config_for(model)
    h, nn, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
    k, n = (h, 2 * nn) if proj == "gate_up" else (nn, h)
    assert int8_gmm_schedule(m, k, n, e, wgmma=True, ragged=True).bm == 128
    assert grouped_gmm_schedule(m, k, n, e, 128, wgmma=True, mixed=True).bm == 128
    assert gmm_w8a8_asym.asym_gmm_schedule(m, k, n, e).bm == 128
    g = torch.Generator(device=dev).manual_seed(m + k + n + 3)
    gs = torch.bincount(torch.randint(0, e, (m,), generator=g, device=dev),
                        minlength=e).to(torch.int32)
    aq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    w4 = torch.randint(-8, 8, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    asc = torch.rand((m, 1), generator=g, device=dev) * 0.05 + 1e-3
    wsc = torch.rand((e, 1, n), generator=g, device=dev) * 0.01 + 1e-4
    zp1 = torch.randn((e, 1, n), generator=g, device=dev) * 0.02
    alternating = [i % 2 for i in range(e)]
    codes, cat, pf, blk = _ragged(w4, w8, alternating, dev)
    k4 = gmm_mixed_packed.gmm_mixed_packed(aq, asc, cat, wsc, gs, pf, blk)
    k2 = gmm_w8a8.gmm_w8a8(aq, asc, codes, wsc, gs)
    torch.cuda.synchronize()
    assert torch.equal(k4, gmm_mixed_packed.gmm_mixed_packed_plain(aq, asc, cat, wsc, gs,
                                                                   pf, blk))
    assert torch.equal(k4, k2)
    k9 = gmm_w8a8_asym.gmm_w8a8_asym(aq, asc, w8, wsc, zp1, gs)
    k8 = gmm_w8a8_grouped.gmm_w8a8_grouped(aq, asc, w8, wsc, gs, -1, zp1)
    torch.cuda.synchronize()
    assert torch.equal(k9, gmm_w8a8_asym.gmm_w8a8_asym_plain(aq, asc, w8, wsc, zp1, gs))
    assert torch.equal(k9, k8)
    del k4, k2, k9, k8
    groups = k // 128
    gsc = torch.rand((m, groups), generator=g, device=dev) * 0.05 + 1e-3
    gwsc = torch.rand((e, groups, n), generator=g, device=dev) * 0.01 + 1e-4
    gzp = torch.randn((e, groups, n), generator=g, device=dev) * 0.02
    for pflags in (alternating, [1] * e):
        codes, cat, pf, blk = _ragged(w4, w8, pflags, dev)
        for sa, sc, z, gsize in ((gsc, gwsc, gzp, 128), (asc, wsc, zp1, -1)):
            k4f = gmm_mixed_packed.gmm_mixed_packed(aq, sa, cat, sc, gs, pf, blk,
                                                    rhs_zp=z)
            k8 = gmm_w8a8_grouped.gmm_w8a8_grouped(aq, sa, codes, sc, gs, gsize, z)
            torch.cuda.synchronize()
            assert torch.equal(k4f, gmm_mixed_packed.gmm_mixed_packed_plain(
                aq, sa, cat, sc, gs, pf, blk, rhs_zp=z))
            assert torch.equal(k4f, k8)


@pytest.mark.parametrize("k,n,offset", [(1056, 2048, 0), (1344, 2048, 0),
                                        (2048, 2040, 0), (2048, 2816, 4)],
                         ids=["k_mod_64", "k_mod_128", "n_mod_16", "unaligned"])
def test_ragged_bodies_out_of_domain_take_the_old_tiles(dev, k, n, offset):
    """Outside the wgmma domains K4 and K9 keep the 64 x 128 tile and K4f
    the 32 x 128 body: K % 64 != 0 (K4, K4f), K % 128 != 0 (K4f only), N %
    16 != 0 and weights 4 bytes off 16-byte alignment (all three); each
    bitwise its plain version and its sibling (K2, K8) on the same codes."""
    from mxmoe_tpu_torch.ops.gmm_w8a8 import int8_gmm_schedule
    from mxmoe_tpu_torch.ops.gmm_w8a8_grouped import grouped_gmm_schedule

    m, e = 1024, 8
    aligned = offset == 0
    k4_bm = int8_gmm_schedule(m, k, n, e, aligned=aligned, wgmma=True, ragged=True).bm
    k4f_bm = grouped_gmm_schedule(m, k, n, e, k, aligned=aligned, wgmma=True,
                                  mixed=True).bm
    k9_bm = gmm_w8a8_asym.asym_gmm_schedule(m, k, n, e, aligned=aligned).bm
    assert k4_bm == (128 if k % 64 == 0 and aligned and n % 16 == 0 else 64)
    assert k4f_bm == 32 and k9_bm == (128 if aligned and n % 16 == 0 else 64)
    g = torch.Generator(device=dev).manual_seed(k + n + offset)
    gs = torch.tensor(_spread(m, e, 7), dtype=torch.int32, device=dev)
    aq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    w4 = torch.randint(-8, 8, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    asc = torch.rand((m, 1), generator=g, device=dev) * 0.05 + 1e-3
    wsc = torch.rand((e, 1, n), generator=g, device=dev) * 0.01 + 1e-4
    zp = torch.randn((e, 1, n), generator=g, device=dev) * 0.02
    codes, cat, pf, blk = _ragged(w4, w8, [i % 2 for i in range(e)], dev)
    if offset:
        buf = torch.empty((cat.numel() + offset,), dtype=torch.int8, device=dev)
        cat = buf[offset:].view(cat.shape).copy_(cat)
        w8 = buf.new_empty((w8.numel() + offset,))[offset:].view(w8.shape).copy_(w8)
        assert cat.data_ptr() % 16 == offset and w8.data_ptr() % 16 == offset
    k4 = gmm_mixed_packed.gmm_mixed_packed(aq, asc, cat, wsc, gs, pf, blk)
    k4f = gmm_mixed_packed.gmm_mixed_packed(aq, asc, cat, wsc, gs, pf, blk, rhs_zp=zp)
    k9 = gmm_w8a8_asym.gmm_w8a8_asym(aq, asc, w8, wsc, zp, gs)
    torch.cuda.synchronize()
    assert torch.equal(k4, gmm_mixed_packed.gmm_mixed_packed_plain(aq, asc, cat, wsc, gs,
                                                                   pf, blk))
    assert torch.equal(k4, gmm_w8a8.gmm_w8a8(aq, asc, codes, wsc, gs))
    assert torch.equal(k4f, gmm_mixed_packed.gmm_mixed_packed_plain(
        aq, asc, cat, wsc, gs, pf, blk, rhs_zp=zp))
    assert torch.equal(k4f, gmm_w8a8_grouped.gmm_w8a8_grouped(aq, asc, codes, wsc, gs, -1,
                                                              zp))
    assert torch.equal(k9, gmm_w8a8_asym.gmm_w8a8_asym_plain(aq, asc, w8, wsc, zp, gs))


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


# K2 / K5 above the decode rows: the wgmma body over group sizes read on the
# device (csrc/gmm_ws_body.cuh), bitwise the 64 x 128 body it replaced there
# (called through the C entry point with the old schedule) and the plain
# versions; rows past sum(group_sizes) left as they were
_HEADLINE_ROUTED = [
    690, 486, 584, 788, 420, 590, 536, 676, 566, 476, 614, 724, 524, 610,
    532, 310, 530, 810, 448, 410, 546, 572, 408, 450, 574, 420, 534, 562,
    638, 502, 550, 590, 576, 564, 550, 510, 612, 604, 494, 702, 400, 602,
    480, 472, 506, 458, 600, 616, 540, 534, 386, 656, 552, 574, 474, 606,
    572, 334, 546, 572]
_WGMMA_CASES = {
    "m65": (_spread(65, 60, 65), 2048, 2816),
    "m128": (_spread(128, 60, 128), 1408, 2048),
    "chunk1024": (_spread(1024, 60, 1024), 2048, 2816),
    "chunk1536": (_spread(1536, 64, 1536), 1408, 2048),
    "headline32762": (_HEADLINE_ROUTED, 2048, 2816),
    "empty_groups": ([0, 300, 0, 0, 77, 0, 129, 0], 1024, 512),
    "one_group_wide": ([256], 2048, 11264),
    "mixtral_gate_up": ([100, 7, 300, 0, 45, 90, 200, 58], 4096, 1024),
    "mixtral_down": ([130, 70, 2, 90], 14336, 512),
    "57b_gate_up": ([33, 0, 250, 101], 3584, 768),
}


def _old_body(fn, aq, asc, w, wsc, gs, out, packed):
    """The 64 x 128 mma.sync body through the C entry point (``out`` is
    written in place)."""
    m, k = aq.shape
    e, n = wsc.shape[0], wsc.shape[-1]
    sched = gmm_w8a8.int8_gmm_schedule(max(m, gmm_w8a8.DECODE_M + 1), k, n, e, packed)
    assert sched.bm == 64
    args, _ws = gmm_w8a8.schedule_args(sched, aq.device)
    kernels.check(getattr(kernels.lib(), fn)(
        aq.data_ptr(), asc.data_ptr(), w.data_ptr(), wsc.data_ptr(), gs.data_ptr(),
        out.data_ptr(), int(out.dtype == torch.bfloat16), m, k, n, e, *args,
        kernels.stream_ptr(aq.device)), "old " + fn)


@pytest.mark.parametrize("case", sorted(_WGMMA_CASES))
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_int8_wgmma_body_bitwise_old_body_and_plain(dev, case, out):
    sizes, k, n = _WGMMA_CASES[case]
    m, e = sum(sizes), len(sizes)
    assert gmm_w8a8.int8_gmm_schedule(m, k, n, e, wgmma=True).bm == 128
    assert gmm_w8a8.int8_gmm_schedule(m, k, n, e, True, wgmma=True).bm == 128
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    aq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    asc = torch.rand((m, 1), generator=g, device=dev) * 0.05
    w8 = torch.randint(-127, 128, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    w4 = torch.randint(-8, 8, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    wsc = torch.rand((e, 1, n), generator=g, device=dev) * 0.01
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    packed = pack_int4_halves(w4)
    before = (kernels.launches["gmm_w8a8"], kernels.launches["gmm_w4a8_packed"])
    k2 = gmm_w8a8.gmm_w8a8(aq, asc, w8, wsc, gs, out_dtype=out)
    k5 = gmm_w4a8_packed.gmm_w4a8_packed(aq, asc, packed, wsc, gs, out_dtype=out)
    old2 = torch.empty_like(k2)
    old5 = torch.empty_like(k5)
    _old_body("mxmoe_gmm_w8a8", aq, asc, w8, wsc, gs, old2, False)
    _old_body("mxmoe_gmm_w4a8_packed", aq, asc, packed, wsc, gs, old5, True)
    torch.cuda.synchronize()
    assert (kernels.launches["gmm_w8a8"], kernels.launches["gmm_w4a8_packed"]) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(k2, old2) and torch.equal(k5, old5)
    assert torch.equal(k2, gmm_w8a8.gmm_w8a8_plain(aq, asc, w8, wsc, gs, out))
    assert torch.equal(k5, gmm_w4a8_packed.gmm_w4a8_packed_plain(aq, asc, packed, wsc,
                                                                   gs, out))


def test_int8_wgmma_body_leaves_rows_past_the_groups(dev):
    """Rows past sum(group_sizes), inside the last tile and past it, keep what
    the output held; a group past M is cut at M."""
    g = torch.Generator(device=dev).manual_seed(5)
    m, k, n = 700, 256, 512
    aq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    asc = torch.rand((m, 1), generator=g, device=dev)
    wq = torch.randint(-127, 128, (3, k, n), generator=g, device=dev, dtype=torch.int8)
    wsc = torch.rand((3, 1, n), generator=g, device=dev)
    for sizes, rows in (([100, 0, 230], 330), ([400, 200, 300], 700)):
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        out = torch.full((m, n), float("nan"), device=dev)
        sched = gmm_w8a8.int8_gmm_schedule(m, k, n, 3, wgmma=True)
        args, _ws = gmm_w8a8.schedule_args(sched, dev)
        kernels.check(kernels.lib().mxmoe_gmm_w8a8(
            aq.data_ptr(), asc.data_ptr(), wq.data_ptr(), wsc.data_ptr(), gs.data_ptr(),
            out.data_ptr(), 0, m, k, n, 3, *args, kernels.stream_ptr(dev)), "gmm_w8a8")
        ref = gmm_w8a8.gmm_w8a8_plain(aq, asc, wq, wsc, gs, torch.float32)
        torch.cuda.synchronize()
        assert sched.bm == 128
        assert torch.equal(out[:rows], ref[:rows])
        assert bool(torch.isnan(out[rows:]).all())


# K14: the decode body (K2's m16 ring, rows quantized into shared memory) up
# to M 64 and the cooperative wgmma body above, bitwise its plain version and
# K1 + K2; outside the bodies' domain the wrapper runs K1 + K2
@pytest.mark.parametrize("m", [1, 16, 64, 65, 1024, 32762])
@pytest.mark.parametrize("bits", [8, 4])
def test_gmm_w8a8_fusedquant_bodies_bitwise(dev, m, bits):
    from mxmoe_tpu_torch.ops import gmm_w8a8_fusedquant as gfq

    sizes = _HEADLINE_ROUTED if m == 32762 else _spread(m, 60, m)
    k, n, e = 2048, 2816, len(sizes)
    sched = gfq.fusedquant_schedule(m, k, n, e)
    assert sched.bm == (16 if m <= 64 else 128)
    g = torch.Generator(device=dev).manual_seed(m + bits)
    x = (torch.randn((m, k), generator=g, device=dev) * 2).to(torch.bfloat16)
    wq = torch.randint(-127, 128, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    ws = torch.rand((e, 1, n), generator=g, device=dev) * 0.01 + 1e-4
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    for out in (torch.bfloat16, torch.float32):
        before = kernels.launches["gmm_w8a8_fusedquant"]
        got = gfq.gmm_w8a8_fusedquant(x, wq, ws, gs, a_bits=bits, out_dtype=out)
        again = gfq.gmm_w8a8_fusedquant(x, wq, ws, gs, a_bits=bits, out_dtype=out)
        plain = gfq.gmm_w8a8_fusedquant_plain(x, wq, ws, gs, bits, out)
        aq, asc = act_quant.quantize_rows_uniform(x, bits)
        k2 = gmm_w8a8.gmm_w8a8(aq, asc, wq, ws, gs, out_dtype=out)
        torch.cuda.synchronize()
        assert kernels.launches["gmm_w8a8_fusedquant"] == before + 2
        assert torch.equal(got, plain) and torch.equal(got, k2) and torch.equal(got, again)


@pytest.mark.parametrize("m,k,n,e", [(16, 14336, 512, 8), (48, 4096, 1024, 8),
                                     (300, 14336, 512, 8), (200, 80, 384, 3)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_gmm_w8a8_fusedquant_wide_k_and_f32(dev, m, k, n, e, dtype):
    """mixtral's K at decode (split-K) and above it (rows wider than a
    warp's registers in the quantize phase: read twice), K 80, f32
    activations."""
    from mxmoe_tpu_torch.ops import gmm_w8a8_fusedquant as gfq

    sizes = _spread(m, e, m + k)
    g = torch.Generator(device=dev).manual_seed(k + m)
    x = (torch.randn((m, k), generator=g, device=dev) * 3).to(dtype)
    wq = torch.randint(-127, 128, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    ws = torch.rand((e, 1, n), generator=g, device=dev) * 0.01 + 1e-4
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    before = kernels.launches["gmm_w8a8_fusedquant"]
    got = gfq.gmm_w8a8_fusedquant(x, wq, ws, gs, out_dtype=torch.float32)
    plain = gfq.gmm_w8a8_fusedquant_plain(x, wq, ws, gs, 8, torch.float32)
    aq, asc = act_quant.quantize_rows_uniform(x, 8)
    k2 = gmm_w8a8.gmm_w8a8(aq, asc, wq, ws, gs, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert kernels.launches["gmm_w8a8_fusedquant"] == before + 1
    assert torch.equal(got, plain) and torch.equal(got, k2)


def test_gmm_w8a8_fusedquant_outside_the_domain_runs_k1_k2(dev):
    from mxmoe_tpu_torch.ops import gmm_w8a8_fusedquant as gfq

    g = torch.Generator(device=dev).manual_seed(9)
    sizes = [5, 0, 90]
    x = torch.randn((95, 256), generator=g, device=dev).to(torch.bfloat16)
    wq = torch.randint(-127, 128, (3, 256, 40), generator=g, device=dev, dtype=torch.int8)
    ws = torch.rand((3, 1, 40), generator=g, device=dev) * 0.01
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    assert gfq.fusedquant_schedule(95, 256, 40, 3) is None
    before = dict(kernels.launches)
    got = gfq.gmm_w8a8_fusedquant(x, wq, ws, gs)
    plain = gfq.gmm_w8a8_fusedquant_plain(x, wq, ws, gs)
    torch.cuda.synchronize()
    assert kernels.launches["gmm_w8a8_fusedquant"] == before["gmm_w8a8_fusedquant"]
    assert kernels.launches["quantize_rows"] == before["quantize_rows"] + 1
    assert kernels.launches["gmm_w8a8"] == before["gmm_w8a8"] + 1
    assert torch.equal(got, plain)


def _tiny_offline_ckpt(tmp_path):
    import dataclasses

    from mxmoe_tpu_torch.models import configs, synth_ckpt

    cfg = dataclasses.replace(configs.tiny_qwen2_moe(8, 2), hidden_size=256,
                              moe_intermediate_size=384, shared_expert_intermediate_size=256)
    synth_ckpt.make_checkpoint(cfg, str(tmp_path / "hf"), seed=3, dtype=torch.bfloat16)
    return cfg


@pytest.mark.parametrize("kw", [dict(quant="w8a8_g-1_sym"),
                                dict(quant="w4a8_g-1_sym", pack_int4=True),
                                dict(qconfig="mixed"), dict(qconfig="flex")],
                         ids=["w8a8", "w4a8-packed", "mixed-rtn", "flex-rtn"])
def test_convert_on_the_card_is_the_cpu_convert_bitwise(dev, tmp_path, monkeypatch, kw):
    """RTN convert with its quantization on the card writes the artifact the
    CPU writes, bit for bit; load_params puts it on the card."""
    from mxmoe_tpu_torch.models import configs, convert
    from mxmoe_tpu_torch.serving.bench_serving import MIXES, alternating_mixed_config

    cfg = _tiny_offline_ckpt(tmp_path)
    monkeypatch.setattr(configs, "config_for", lambda m: cfg)
    kw = dict(kw)
    if "qconfig" in kw:
        path = str(tmp_path / "q.json")
        alternating_mixed_config(2, 8, True, MIXES[kw["qconfig"]][0]).save(path)
        kw["qconfig"] = path
    for device in ("cpu", "cuda"):
        convert.convert(str(tmp_path / "hf"), "tiny", str(tmp_path / device),
                        device=device, **kw)
    a = convert.load_params(str(tmp_path / "cpu"), device="cpu")
    b = convert.load_params(str(tmp_path / "cuda"))
    flat_a, flat_b = convert._flatten(a), convert._flatten(b)
    assert sorted(flat_a) == sorted(flat_b)
    for k, v in flat_b.items():
        assert v.is_cuda and v.dtype == flat_a[k].dtype, k
        assert torch.equal(v.cpu(), flat_a[k]), k


# the share of GPTQ codes equal between two sweeps of the same W and H
# (test_torch_convert.py's bound against the JAX package): the sweep feeds
# rounding forward, so a flipped tie moves later columns
CODE_AGREEMENT_MIN = 0.999
# the same, a layer, between a whole convert on the card and on the CPU.
# The sweep on the same W and H agrees at CODE_AGREEMENT_MIN (above), but
# the card's float pass sums in another order and GPTQ amplifies that: the
# Hessians of 16-64 calibration rows a family against K 256 are of low
# rank, so float32-level changes in H move codes, and layer 1's inputs come
# through layer 0's quantized forward, whose 4-bit activation rounding
# flips. With the card's Hessian rows shifted by one (a card-only fault)
# this test saw as few as 92 % equal.
CARD_CONVERT_AGREEMENT_MIN = 0.99
# GPTQ's proxy loss on the card within this share of the CPU's, per family
CARD_PROXY_REL = 0.05


@pytest.mark.parametrize("scheme", ["w4a16_g-1_sym", "w4a16_g16_asym", "w3a16_g-1_asym",
                                    "w4a16_g32_asym_mse"])
@pytest.mark.parametrize("kw", [dict(), dict(static_groups=True),
                                dict(act_order=True, static_groups=True)],
                         ids=["plain", "static", "actorder-static"])
def test_gptq_sweep_on_the_card_is_the_cpu_sweep(dev, scheme, kw):
    """gptq_quantize_kn's Cholesky, triangular inverse and blocked sweep on
    the card against the CPU's on the same weights and full-rank Hessians:
    codes at least CODE_AGREEMENT_MIN equal, scales, zero points and the
    fake-quantized weights within 1e-5 of their largest value."""
    from mxmoe_tpu_torch.quant import gptq
    from mxmoe_tpu_torch.quant.schemes import parse_scheme

    g = torch.Generator().manual_seed(0)
    w = torch.randn((4, 256, 384), generator=g)
    x = torch.randn((4, 1024, 256), generator=g)
    h = 2 * torch.bmm(x.transpose(1, 2), x)
    cfg = parse_scheme(scheme)
    ref = gptq.gptq_quantize_kn(w, h, cfg, **kw)
    got = gptq.gptq_quantize_kn(w.to(dev), h.to(dev), cfg, **kw)
    assert float((got.codes.cpu() == ref.codes).double().mean()) >= CODE_AGREEMENT_MIN
    for name in ("scale", "zp", "w_fq"):
        r, c = getattr(ref, name), getattr(got, name)
        assert c.is_cuda and c.dtype == r.dtype and c.shape == r.shape, name
        assert float((c.cpu() - r).abs().max()) <= 1e-5 * max(float(r.abs().max()), 1e-30), name


@pytest.mark.parametrize("backend", ["ragged_dot", "pallas"])
def test_moe_hessians_on_the_card(dev, tmp_path, backend):
    """make_moe_hessian_fn on the card (routing, dispatch, the float experts
    through the stock grouped product or K11, the masked batched Gram
    products) against the CPU's on one layer of a checkpoint and the same
    rows: rtol 1e-5, as against the JAX package."""
    from mxmoe_tpu_torch.models.hf_loader import params_from_safetensors
    from mxmoe_tpu_torch.quant.quantizer import make_moe_hessian_fn

    cfg = _tiny_offline_ckpt(tmp_path)
    params = params_from_safetensors(str(tmp_path / "hf"), cfg, dtype=torch.float32)
    lp = {k: v[0] for k, v in params["layers"].items()}
    x = torch.randn((200, cfg.hidden_size), generator=torch.Generator().manual_seed(1))
    ref = make_moe_hessian_fn(cfg, backend)(x, lp)
    before = kernels.launches["gmm_bf16"]
    got = make_moe_hessian_fn(cfg, backend)(x.to(dev), {k: v.to(dev) for k, v in lp.items()})
    torch.cuda.synchronize()
    assert (kernels.launches["gmm_bf16"] > before) == (backend == "pallas")
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        torch.testing.assert_close(got[k].cpu(), r, rtol=1e-5,
                                   atol=1e-5 * float(r.abs().max()), msg=k)


def _gptq_qconfig(path, routed, shared):
    from mxmoe_tpu_torch.quant.schemes import (QLayerConfig, QModelConfig,
                                               build_uniform_expert, parse_scheme)

    experts = {str(i): build_uniform_expert(parse_scheme(routed[i % len(routed)]))
               for i in range(8)}
    experts[str(8)] = build_uniform_expert(parse_scheme(shared))
    QModelConfig(layers={str(l): QLayerConfig(experts=dict(experts))
                         for l in range(2)}).save(path)
    return path


@pytest.mark.parametrize("routed,shared,method", [
    (("w4a4_g-1_sym", "w8a8_g-1_sym"), "w8a8_g-1_sym", "gptq"),
    (("w4a8_g16_sym", "w8a8_g-1_sym"), "w8a8_g16_asym", "gptq"),
    (("w4a4_g-1_sym", "w8a8_g-1_sym"), "w8a8_g-1_sym", "gptq-had")],
    ids=["mixed-gptq", "flex-g16-fake-shared-gptq", "mixed-gptq-had"])
def test_gptq_convert_on_the_card_is_the_cpu_convert(dev, tmp_path, monkeypatch, routed,
                                                     shared, method):
    """A 2-layer GPTQ convert with its float pass, Hessians and sweep on the
    card against the CPU convert of the same shards: every layer's codes at
    least CARD_CONVERT_AGREEMENT_MIN equal (and the fake-quantized shared
    expert's weights of the grouped mix as many within 1e-5 of their
    largest value), the int32 metadata and act bits equal, scales and zero
    points within 1e-5 of the largest; GPTQ's proxy loss below RTN's on
    every reached family and within CARD_PROXY_REL of the CPU's."""
    from mxmoe_tpu_torch.models import configs, convert

    cfg = _tiny_offline_ckpt(tmp_path)
    monkeypatch.setattr(configs, "config_for", lambda m: cfg)
    qconfig = _gptq_qconfig(str(tmp_path / "q.json"), routed, shared)
    stats = {}
    for device in ("cpu", "cuda"):
        stats[device] = {}
        convert.convert(str(tmp_path / "hf"), "tiny", str(tmp_path / device),
                        dtype=torch.float32, qconfig=qconfig, method=method,
                        calib_nsamples=2, calib_seqlen=32, device=device,
                        stats=stats[device])
    a = convert._flatten(convert.load_params(str(tmp_path / "cpu"), device="cpu"))
    b = convert._flatten(convert.load_params(str(tmp_path / "cuda")))
    assert sorted(a) == sorted(b)
    fake_shared = "layers.shared_gate_up_q" not in a
    assert fake_shared == shared.endswith("g16_asym")
    bad = []
    for k, r in a.items():
        g = b[k].cpu()
        assert b[k].is_cuda and g.dtype == r.dtype and g.shape == r.shape, k
        if r.dtype == torch.int32 or "act_" in k:
            if not torch.equal(g, r):
                bad.append((k, "differs"))
        elif r.dtype == torch.int8 or (fake_shared and k.startswith("layers.shared_")
                                       and k != "layers.shared_gate"):
            close = (g.double() - r.double()).abs() <= 1e-5 * float(r.abs().max())
            shares = [float(close[l].double().mean()) for l in range(cfg.num_layers)]
            if min(shares) < CARD_CONVERT_AGREEMENT_MIN:
                bad.append((k, "equal share a layer", shares))
        else:
            err = float((g.double() - r.double()).abs().max())
            if not err <= 1e-5 * max(float(r.abs().max()), 1e-30):
                bad.append((k, "max abs diff", err, float(r.abs().max())))
    assert not bad, bad
    gc, gd = (torch.cat(stats[d]["proxy"]["gptq"]) for d in ("cpu", "cuda"))
    rd = torch.cat(stats["cuda"]["proxy"]["rtn"])
    live = rd > 0
    assert bool((gd[live] < rd[live]).all())
    assert float(((gd - gc).abs() / gc.clamp_min(1e-30))[live].max()) <= CARD_PROXY_REL


def test_grouped_hessians_on_the_card(dev):
    """accumulate_hessian's grouped product on the card (no host read of the
    sizes) against the CPU's per-expert loop: bf16 rows, f32 sums."""
    from mxmoe_tpu_torch.quant import gptq

    g = torch.Generator(device=dev).manual_seed(0)
    xs = torch.randn((1000, 256), generator=g, device=dev).bfloat16()
    gs = torch.tensor([100, 0, 500, 400], dtype=torch.int32, device=dev)
    h = gptq.accumulate_hessian(xs, gs, 4)
    ref = gptq.accumulate_hessian(xs.cpu(), gs.cpu(), 4)
    assert h.dtype == torch.float32 and h.shape == (4, 256, 256)
    torch.testing.assert_close(h.cpu(), ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))


# --- the solve half: calibration, gate trace and the scheme registry -------

def _solve_inputs(tmp_path):
    from mxmoe_tpu_torch.models.hf_loader import params_from_safetensors
    from mxmoe_tpu_torch.quant.data import synthetic_tokens

    cfg = _tiny_offline_ckpt(tmp_path)
    params = params_from_safetensors(str(tmp_path / "hf"), cfg, dtype=torch.float32)
    return cfg, params, torch.from_numpy(synthetic_tokens(4, 64, cfg.vocab_size))


@pytest.mark.parametrize("method,rel", [("rtn", 1e-3), ("gptq", 1e-2)])
def test_calibrate_model_on_the_card(dev, tmp_path, method, rel):
    """calibrate_model with one layer at a time on the card (K11 for the
    grouped products) against the CPU's on the same float32 checkpoint: each
    loss within ``rel`` of its layer's largest (f32 sums in other orders; GPTQ's
    codes on the card agree with the CPU's on >= 99.9 %, and one code on the
    other side of a rounding boundary moves a loss further)."""
    from mxmoe_tpu_torch.quant import calibrate
    from mxmoe_tpu_torch.quant.schemes import parse_scheme

    cfg, params, toks = _solve_inputs(tmp_path)
    schemes = {s: parse_scheme(s) for s in ("w4a4_g-1_sym", "w4a16_g128_asym")}
    ref = calibrate.calibrate_model(params, toks, cfg, schemes, method=method,
                                    backend="pallas", device="cpu", verbose=False)
    before = kernels.launches["gmm_bf16"]
    got = calibrate.calibrate_model(params, toks, cfg, schemes, method=method,
                                    backend="pallas", device=dev, verbose=False)
    assert kernels.launches["gmm_bf16"] > before
    for s in schemes:
        assert sorted(got[s]) == sorted(ref[s])
        for layer in ref[s]:
            r = torch.tensor([ref[s][layer][e] for e in sorted(ref[s][layer])])
            g = torch.tensor([got[s][layer][e] for e in sorted(ref[s][layer])])
            assert bool(torch.isfinite(g).all())
            torch.testing.assert_close(g, r, rtol=0, atol=rel * float(r.abs().max()))


def test_trace_gate_stats_on_the_card(dev, tmp_path):
    """trace_gate_stats through K11 on the card against the CPU: equal access
    counts but where a token's k-th and (k+1)-th router logits lie within 1e-5
    (either expert may be picked), the weight sums then within 1e-4."""
    import numpy as np

    from mxmoe_tpu_torch.trace import gate

    cfg, params, toks = _solve_inputs(tmp_path)
    ref = gate.trace_gate_stats(params, toks, cfg, backend="pallas", device="cpu")
    before = kernels.launches["gmm_bf16"]
    got = gate.trace_gate_stats(params, toks, cfg, backend="pallas", device=dev)
    assert kernels.launches["gmm_bf16"] > before
    assert (got.access_freq.sum(1) == toks.numel() * cfg.top_k).all()
    x, cos, sin = gate._embed_and_dense(params, toks, cfg, "cpu")
    ties = []
    for _, lp, x2d in gate._moe_layers(params, x, cos, sin, cfg, "pallas", "cpu"):
        srt = torch.sort(x2d @ lp["router"], dim=-1, descending=True).values
        ties.append(int((srt[:, cfg.top_k - 1] - srt[:, cfg.top_k] < 1e-5).sum()))
    d = np.abs(got.access_freq - ref.access_freq).sum(1)
    assert (d <= 2 * np.array(ties)).all(), (d, ties)
    if not any(ties):
        np.testing.assert_allclose(got.weights_sum, ref.weights_sum, rtol=1e-4)


@pytest.mark.parametrize("tokens", [8, 256], ids=["decode", "prefill"])
@pytest.mark.parametrize("scheme", ["w16a16_g-1_sym", "w8a8_g-1_sym", "w8a8_g-1_asym",
                                    "w4a4_g-1_sym_packed", "w4a16_g-1_sym",
                                    "w4a16_g128_asym", "w4a16_g128_asym_packed",
                                    "w4a4_g128_sym", "w4a4_g128_asym"])
def test_registry_scheme_on_the_card(dev, scheme, tokens):
    """bench.kernels: each scheme's launcher on the card launches its kernel
    and agrees with its plain version on the same operands: the int8 kinds
    (K2, K9, K5, K8) bitwise; K6 / K7 within ``gmm_weight_only.error_over_bound``
    and K11 within ``gmm.error_over_bound`` of the float64 product."""
    from mxmoe_tpu_torch.bench import kernels as registry
    from mxmoe_tpu_torch.bench import workloads
    from mxmoe_tpu_torch.quant.packing import unpack_int4_halves

    wl = workloads.synthetic_workload(8, tokens, 2, 256, 256, seed=5)
    ops = registry.build_operands(wl, scheme, device="cpu")
    name = registry.kernel_of(scheme)
    launch = registry.make_launcher(scheme)
    want = launch(ops)
    before = kernels.launches[name]
    got = launch({k: v.to(dev) for k, v in ops.items()}).cpu()
    assert kernels.launches[name] == before + 1
    if name == "gmm_bf16":
        assert gmm_float.error_over_bound(got, ops["lhs"], ops["rhs"], ops["gs"])[1] <= 1.0
    elif name.startswith("gmm_weight_only"):
        q = unpack_int4_halves(ops["rhs"]) if scheme.endswith("_packed") else ops["rhs"]
        g = 256 if "g-1" in scheme else 128
        assert gmm_weight_only.error_over_bound(got, ops["lhs"], q, ops["rhs_sc"],
                                                ops["rhs_zp"], ops["gs"], g)[1] <= 1.0
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("quant,int8_kv,fused,temperature",
                         [("w8a8_g-1_sym", False, False, 0.0),
                          ("mixed-packed", True, False, 0.0),
                          ("mixed-packed", True, True, 0.0),
                          ("w8a8_g-1_sym", False, False, 0.8)],
                         ids=["uniform", "mixed-packed-int8kv", "fused-ffn", "sampled"])
def test_captured_step_is_its_eager_twin_bitwise(dev, quant, int8_kv, fused, temperature):
    """A captured decode step (``serving/graph.py``) and its eager twin, a
    ``forward_cached`` + ``sample_tokens`` loop, from the same cache state
    (qwen2_moe at full width, 2 layers, 4 slots at 5-200 positions, one
    inactive) and, when sampled (temperature 0.8, top-k 50), the same
    generator state: bitwise equal logits and tokens over 8 steps, the
    inactive slot's cache and length untouched. Between the 4th and the 5th
    replay the shared tickets are grown past their size by an eager call and
    the freed memory is written over: the graph keeps replaying on the
    tickets it was captured against. After the replays every ticket and the
    grid barrier's arrival count are back to 0, and the launches counted are
    the warm-up run's and the replays' (the capture's own are not)."""
    import dataclasses
    import functools

    from mxmoe_tpu_torch.models import configs
    from mxmoe_tpu_torch.serving import bench_serving, decode, graph, kv_cache

    cfg = dataclasses.replace(configs.config_for("qwen2_moe"), num_layers=2)
    params, impl = bench_serving.init_for_serving(
        cfg, torch.Generator(device=dev).manual_seed(0),
        functools.partial(bench_serving.quantize_for_serving, quant=quant,
                          fused_ffn=fused), dev)
    init = kv_cache.init_quant_kv_cache if int8_kv else kv_cache.init_kv_cache
    cache = init(cfg, 4, 256, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (4, 200), generator=g, device=dev,
                           dtype=torch.int32)
    _, c = decode.forward_cached(params, prompt, cache, cfg, impl,
                                 valid_lengths=torch.tensor([5, 200, 0, 77],
                                                            dtype=torch.int32, device=dev))
    cache.lengths.copy_(c.lengths)
    twin = kv_cache.clone_cache(cache)
    tok = torch.randint(0, cfg.vocab_size, (4,), generator=g, device=dev,
                        dtype=torch.int32)
    valid = torch.tensor([1, 1, 0, 1], dtype=torch.int32, device=dev)
    top_k = 50 if temperature else 0
    gen = torch.Generator(device=dev).manual_seed(7)
    gen_twin = torch.Generator(device=dev)
    gen_twin.set_state(gen.get_state())
    step = graph.DecodeGraph(params, cfg, impl, cache, temperature, top_k, gen)
    step.load(tok, valid)
    kernels.reset_launch_counts()
    got_logits, got_toks = [], []
    for i in range(8):
        if i == 4:
            held = kernels.tickets(cache.lengths.device, 0)
            size = held.numel()
            grown = kernels.tickets(cache.lengths.device, size + 1)
            assert grown.data_ptr() != held.data_ptr()
            del held
            litter = [torch.full((size,), 7, dtype=torch.int32, device=dev)
                      for _ in range(16)]
        got_toks.append(step.run()[:, 0].clone())
        got_logits.append(step.logits.clone())
    counts = dict(kernels.launches)
    assert step.graph is not None and sum(step.counts.values()) > 0
    assert all(counts[k] == 9 * n for k, n in step.counts.items()), (counts, step.counts)
    last = tok[:, None]
    for i in range(8):
        logits, twin = decode.forward_cached(params, last, twin, cfg, impl,
                                             valid_lengths=valid)
        nxt = decode.sample_tokens(logits[:, -1], gen_twin, temperature, top_k)
        assert torch.equal(got_logits[i], logits), i
        assert torch.equal(got_toks[i], nxt), i
        last = nxt[:, None]
    if temperature:
        # the step sampled: its tokens are not all the greedy ones
        assert any(not torch.equal(t, lg[:, -1].argmax(-1).to(torch.int32))
                   for t, lg in zip(got_toks, got_logits))
        assert torch.equal(gen.get_state(), gen_twin.get_state())
    assert torch.equal(cache.lengths, twin.lengths)
    assert cache.lengths.tolist() == [13, 208, 0, 85]
    for f in dataclasses.fields(cache):
        assert torch.equal(getattr(cache, f.name), getattr(twin, f.name)), f.name
    torch.cuda.synchronize()
    for t in [*kernels._tickets.values(), *kernels._retired_tickets]:
        assert int(t.abs().sum()) == 0
    for b in kernels._barriers.values():
        assert int(b[0]) == 0


def _served_2_layers(dev, quant, fused):
    import dataclasses
    import functools

    from mxmoe_tpu_torch.models import configs
    from mxmoe_tpu_torch.serving import bench_serving

    cfg = dataclasses.replace(configs.config_for("qwen2_moe"), num_layers=2)
    params, impl = bench_serving.init_for_serving(
        cfg, torch.Generator(device=dev).manual_seed(0),
        functools.partial(bench_serving.quantize_for_serving, quant=quant,
                          fused_ffn=fused), dev)
    return cfg, params, impl


@pytest.mark.parametrize("quant,int8_kv,fused",
                         [("w8a8_g-1_sym", False, False),
                          ("mixed-packed", True, False),
                          ("mixed-packed", True, True)],
                         ids=["uniform", "mixed-packed-int8kv", "fused-ffn"])
def test_captured_prefill_chunk_is_its_eager_twin_bitwise(dev, quant, int8_kv, fused):
    """A captured prefill chunk (``graph.PrefillGraph``) and its eager twin,
    ``forward_cached`` over a clone of the same cache (qwen2_moe at full
    width, 2 layers, 4 slots at 0-300 positions of 512): two 256-token
    chunks, the second ragged (valid 256 / 100 / 0 / 37: one slot inactive,
    one whose chunk overflows S_max), bitwise equal logits and every cache
    byte after each; the launches counted are the warm-up run's and the
    replays' (the capture's own are not), beside the twin's."""
    import dataclasses

    from mxmoe_tpu_torch.serving import decode, graph, kv_cache

    cfg, params, impl = _served_2_layers(dev, quant, fused)
    init = kv_cache.init_quant_kv_cache if int8_kv else kv_cache.init_kv_cache
    cache = init(cfg, 4, 512, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (4, 300), generator=g, device=dev,
                           dtype=torch.int32)
    _, c = decode.forward_cached(params, prompt, cache, cfg, impl,
                                 valid_lengths=torch.tensor([0, 300, 7, 300],
                                                            dtype=torch.int32, device=dev))
    cache.lengths.copy_(c.lengths)
    cache.lengths[3] = 490                      # 22 free positions
    twin = kv_cache.clone_cache(cache)
    chunk = graph.PrefillGraph(params, cfg, impl, cache, 256)
    kernels.reset_launch_counts()
    for valid in ([256, 256, 0, 256], [256, 100, 0, 37]):
        toks = torch.randint(0, cfg.vocab_size, (4, 256), generator=g, device=dev,
                             dtype=torch.int32)
        v = torch.tensor(valid, dtype=torch.int32, device=dev)
        chunk.load(toks, v)
        got = chunk.run().clone()
        with torch.no_grad():
            want, out = decode.forward_cached(params, toks, twin, cfg, impl,
                                              valid_lengths=v)
        twin.lengths.copy_(out.lengths)
        assert torch.equal(got, want)
        for f in dataclasses.fields(cache):
            assert torch.equal(getattr(cache, f.name), getattr(twin, f.name)), f.name
    assert cache.lengths.tolist() == [512, 512, 7, 512]
    counts = dict(kernels.launches)
    assert chunk.graph is not None and sum(chunk.counts.values()) > 0
    # the warm-up run, two replays and the twin's two chunks
    assert all(counts[k] == 5 * n for k, n in chunk.counts.items()), (counts, chunk.counts)


@pytest.mark.parametrize("int8_kv", [False, True], ids=["bf16", "int8"])
def test_engine_captured_prefill_is_the_eager_engine_bitwise(dev, int8_kv):
    """``Engine.submit`` (the batch-1 staging graph, then the copy into the
    slot) and ``submit_batch`` (the full-width graph) against an Engine with
    ``cuda_graphs=False`` (eager chunks over the slot's view and the whole
    cache): a 300-token prompt (two chunks, the second ragged) and a
    48-token one, then two prompts at once beside the two active slots;
    every cache byte, the lengths and the first tokens equal after each, and
    the same greedy tokens to the end (mixed-packed at full width, 2
    layers)."""
    import dataclasses

    import numpy as np

    from mxmoe_tpu_torch.serving.engine import Engine, EngineConfig

    cfg, params, impl = _served_2_layers(dev, "mixed-packed", False)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (300, 48, 513, 20)]
    engines = [Engine(params, cfg, EngineConfig(batch_slots=4, max_len=1024,
                                                prefill_chunk=256, int8_kv=int8_kv,
                                                cuda_graphs=cap), impl)
               for cap in (True, False)]

    def same():
        a, b = engines
        for f in dataclasses.fields(a.cache):
            assert torch.equal(getattr(a.cache, f.name), getattr(b.cache, f.name)), f.name
        assert (a._last_tokens == b._last_tokens).all()
        assert (a._host_len == b._host_len).all()

    for p in prompts[:2]:
        rids = [e.submit(p, max_new_tokens=6) for e in engines]
        assert rids[0] == rids[1]
        same()
    rids = [e.submit_batch(prompts[2:], max_new_tokens=6) for e in engines]
    assert rids[0] == rids[1] == [2, 3]
    same()
    assert engines[0]._slot_prefill.graph is not None
    assert engines[0]._batch_prefill.graph is not None
    outs = [e.run_to_completion(chunk=4) for e in engines]
    assert outs[0] == outs[1]


_TICKET_SCRIPT = r'''
import dataclasses, functools, sys
import torch
from mxmoe_tpu_torch.models import configs
from mxmoe_tpu_torch.ops import kernels
from mxmoe_tpu_torch.serving import bench_serving, decode, graph, kv_cache

if sys.argv[1] == "bypassed":
    class Dropped(list):
        def append(self, t):
            pass
    kernels._retired_tickets = Dropped()
dev = torch.device("cuda")
cfg = dataclasses.replace(configs.config_for("qwen2_moe"), num_layers=2)
params, impl = bench_serving.init_for_serving(
    cfg, torch.Generator(device=dev).manual_seed(0),
    functools.partial(bench_serving.quantize_for_serving, quant="mixed-packed"), dev)
cache = kv_cache.init_quant_kv_cache(cfg, 4, 2048, device=dev)
g = torch.Generator(device=dev).manual_seed(1)
prompt = torch.randint(0, cfg.vocab_size, (4, 1800), generator=g, device=dev,
                       dtype=torch.int32)
with torch.no_grad():
    _, c = decode.forward_cached(params, prompt, cache, cfg, impl, valid_lengths=torch.tensor(
        [1800, 700, 1500, 40], dtype=torch.int32, device=dev))
cache.lengths.copy_(c.lengths)
twin = kv_cache.clone_cache(cache)
tok = torch.randint(0, cfg.vocab_size, (4,), generator=g, device=dev, dtype=torch.int32)
valid = torch.ones((4,), dtype=torch.int32, device=dev)
step = graph.DecodeGraph(params, cfg, impl, cache)
step.load(tok, valid)
got, litter = [], []
for i in range(8):
    if i == 2:
        held = kernels.tickets(dev, 0)
        size, lo = held.numel(), held.data_ptr()
        hi = lo + 4 * size
        kernels.tickets(dev, size + 1)
        del held
        # write 7s over the memory the old buffer held, if the allocator
        # gives it out again (it does once freed): allocate on each stream
        # until the litter covers it
        covered = set()
        for s in (torch.cuda.current_stream(dev), graph.capture_stream(dev)):
            with torch.cuda.stream(s):
                for _ in range(20000):
                    t = torch.full((size,), 7, dtype=torch.int32, device=dev)
                    litter.append(t)
                    a, b = t.data_ptr(), t.data_ptr() + 4 * size
                    covered |= {p for p in (lo, hi - 1) if a <= p < b}
                    if len(covered) == 2:
                        break
            if len(covered) == 2:
                break
        torch.cuda.synchronize()
        print("littered" if len(covered) == 2 else "not littered")
    step.run()
    got.append(step.logits.clone())
last, same = tok[:, None], True
for i in range(8):
    logits, twin = decode.forward_cached(params, last, twin, cfg, impl, valid_lengths=valid)
    same = same and torch.equal(got[i], logits)
    last = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
torch.cuda.synchronize()
print("equal" if same else "differs")
print("launches a replay:", step.counts, file=sys.stderr)
'''


@pytest.mark.parametrize("mode", ["kept", "bypassed"])
def test_replay_after_ticket_growth_needs_the_retired_tickets(dev, mode):
    """The mutation check of the tickets a graph holds (``ops/kernels.py``
    ``_retired_tickets``): a decode graph (qwen2_moe full width, 2 layers,
    mixed-packed + int8 KV at 40-1800 of 2048 positions: the int8 shared
    expert's split-K GEMMs and K3q over many S-chunks take tickets)
    replays after the tickets grew, and small blocks
    are allocated and filled with 7s on both streams until they cover the
    old buffer's memory, or 20000 a stream. Kept, that memory is never given
    out and every replay's logits equal an eager twin's; with the retirement
    bypassed (the old buffer freed), the 7s land on it and the replays give
    other logits, fail, or hang. Each mode runs in a subprocess with its own time limit, so a
    hang cannot stall the card run."""
    import os
    import subprocess
    import sys

    kernels.lib()                               # built once, by this process
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        p = subprocess.run([sys.executable, "-c", _TICKET_SCRIPT, mode], cwd=root,
                           capture_output=True, text=True, timeout=240)
    except subprocess.TimeoutExpired:
        assert mode == "bypassed", "the graph over kept tickets hung"
        print(mode, "ran into its time limit")
        return
    out = p.stdout.split()
    print(mode, p.returncode, out, p.stderr[-300:])
    if mode == "kept":
        # the kept buffer is never given out again; the replays are right
        assert p.returncode == 0 and out == ["not", "littered", "equal"], \
            (p.stdout, p.stderr[-2000:])
    else:
        # the freed buffer was written over, and the graph went wrong on it
        assert p.returncode != 0 or out == ["littered", "differs"], (p.stdout,
                                                                     p.stderr[-2000:])
