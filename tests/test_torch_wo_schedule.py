"""The weight-only GEMMs' shared schedule and order of work. K6
``gmm_weight_only``, K7 ``gmm_weight_only_packed`` and the weight-only rows of
K10 ``gmm_mixed_wo_wxa`` run one decode body on one schedule
(``gmm_w8a8_grouped.weight_only_gmm_schedule``): the schedule at the decode
shapes of the main path, the three wrappers handing the kernels the same grid
and split count, the split-K byte-tile pairs covering K once, the split
workspace's slot arithmetic of ``csrc/gmm_weight_only_tile.cuh`` written out,
the body's order of work (``split_partials`` / ``weight_only_split_plain``:
byte-tile pairs, low and high halves summed apart and added once, splits
added in ascending order) against the float64 product and against the JAX
kernels in interpret mode, and the body's int8 -> f32 conversion without I2F
written in torch integer ops.

Tolerances. ``weight_only_split_plain`` against the float64 product of the
same bf16 weights: ``accumulation_bound`` (K * 2^-24 * sum|lhs||w|, any order
of the K - 1 additions); a partial sum with one split or the high halves
dropped lies outside it. Against the JAX kernels in interpret mode, as
test_torch_gmm_weight_only.py: bf16 outputs within one bf16 ulp of the
reference element, f32 outputs within (K * 2^-24 + 2^-22) * sum|lhs||w| (XLA
contracts the dequantization into an FMA and sums K in another order). The
magic-number conversion and the dequantized bf16 weights: bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.ops import pallas_gmm
from mxmoe_tpu.quant import packing as jp
from mxmoe_tpu_torch.ops import gmm_mixed_wo_wxa, gmm_weight_only_packed, kernels
from mxmoe_tpu_torch.ops import gmm_weight_only as wo
from mxmoe_tpu_torch.ops.gmm_w8a8 import DECODE_M, SMS
from mxmoe_tpu_torch.ops.gmm_w8a8_grouped import (WO_WGMMA_MIN_M, grouped_gmm_schedule,
                                                  weight_only_gmm_schedule)
from mxmoe_tpu_torch.quant.packing import pack_int4_halves, unpack_int4_halves

T = torch.from_numpy
PART = 16 * 64 + 16       # workspace words a (tile, split): the w x a body's part
PAIR = 64                 # code rows of one half of a byte-tile pair

# (K, N) of the expert products on the main path: qwen2_moe routed gate_up /
# down; the E = 1 weight-only shared expert's gate_up / down (N 5632)
ROUTED = [(2048, 2816), (1408, 2048)]
SHARED = [(2048, 11264), (5632, 2048)]


def _cdiv(a, b):
    return -(-a // b)


def _g(k, gsize):
    return k if gsize == -1 else gsize


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gsize", [128, -1], ids=["g128", "per_channel"])
@pytest.mark.parametrize("k,n", ROUTED)
def test_decode_schedule_routed(k, n, gsize):
    """16 routed rows over 60 experts: the m16 x 64 grid, m-tiles bounded by
    M, no split (the grid alone fills the card)."""
    s = weight_only_gmm_schedule(16, k, n, 60, _g(k, gsize))
    assert (s.bm, s.bn, s.grid_n, s.grid_m, s.splits) == (16, 64, n // 64, 16, 1)
    assert s.blocks >= 2 * SMS


@pytest.mark.parametrize("gsize", [128, -1], ids=["g128", "per_channel"])
@pytest.mark.parametrize("k,n", SHARED)
def test_decode_schedule_splits_the_shared_expert(k, n, gsize):
    """The weight-only shared expert (E = 1, M 4): 176 / 32 column blocks,
    so K is split until the grid holds two blocks an SM."""
    s = weight_only_gmm_schedule(4, k, n, 1, _g(k, gsize))
    assert s.bm == 16 and s.grid_m == 1 and s.splits > 1
    assert s.blocks >= 2 * SMS


@pytest.mark.parametrize("m", [1, 2, 4, 15, 16, 17, 24, 32, 48, 63, 64, 65, 128, 256])
def test_decode_body_up_to_decode_m(m):
    """The decode body up to DECODE_M; above it the 32 x 128 bodies below
    the wgmma bodies' threshold, the wgmma walk from it on."""
    s = weight_only_gmm_schedule(m, 1408, 2048, 60, 128)
    if m <= DECODE_M:
        assert (s.bm, s.bn, s.grid_m) == (16, 64, min(_cdiv(m, 16) + 59, m))
    elif m < WO_WGMMA_MIN_M:
        assert (s.bm, s.bn, s.grid_n, s.grid_m, s.splits) == (
            32, 128, 16, _cdiv(m, 32) + 59, 1)
    else:
        assert (s.bm, s.bn, s.grid_n, s.grid_m, s.splits) == (
            128, 256, 8, _cdiv(m, 128) + 60, 1)


@pytest.mark.parametrize("k,n,gsize,decode", [
    (384, 48, 128, True),      # K/2 = 192: every half-tile in one group
    (96, 64, 96, True),        # one group; K/2 % 64 != 0 (zero-filled rows)
    (192, 64, 64, False),      # K/2 = 96: a high half-tile spans two groups
    (256, 64, 32, False),      # groups smaller than a k-tile
    (2048, 40, 128, False),    # N % 16 != 0
])
def test_decode_domain(k, n, gsize, decode):
    s = weight_only_gmm_schedule(4, k, n, 3, gsize)
    assert (s.bm == 16) == decode
    if decode:      # the w x a body's own schedule: one grid for K10's bodies
        assert s == grouped_gmm_schedule(4, k, n, 3, gsize)
    assert weight_only_gmm_schedule(4, k, n, 3, gsize, aligned=False).bm == 32


class _Recorder:
    """Stands in for the kernel library: records each entry point's arguments."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def call(*args):
            self.calls[name] = args
            return 0
        return call


@pytest.mark.parametrize("m,k,n,e,gsize", [
    (16, 2048, 2816, 60, 128), (16, 1408, 2048, 60, -1), (4, 5632, 2048, 1, 128),
    (4, 2048, 11264, 1, -1), (65, 1408, 2048, 60, 128), (1, 96, 64, 3, -1),
    (8, 192, 64, 2, 64)])
def test_k6_k7_k10_launch_one_schedule(monkeypatch, m, k, n, e, gsize):
    """The three wrappers, on tensors of the meta device (no data, not the
    CPU, so each takes its kernel path) with the library recorded: K6, K7
    and K10 pass the kernels the same bm, grid_m, splits and k-tiles a split,
    ``weight_only_gmm_schedule``'s, and a workspace exactly when they split."""
    rec = _Recorder()
    monkeypatch.setattr(kernels, "lib", lambda: rec)
    monkeypatch.setattr(kernels, "require", lambda cond, msg: None)
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(kernels, "launches", dict(kernels.launches))
    meta = torch.device("meta")
    groups = 1 if gsize == -1 else k // gsize
    x = torch.empty((m, k), dtype=torch.bfloat16, device=meta)
    aq = torch.empty((m, k), dtype=torch.int8, device=meta)
    asc = torch.empty((m, groups), device=meta)
    wq = torch.empty((e, k, n), dtype=torch.int8, device=meta)
    wp = torch.empty((e, k // 2, n), dtype=torch.int8, device=meta)
    sc = torch.empty((e, groups, n), device=meta)
    gs = torch.empty((e,), dtype=torch.int32, device=meta)
    fl = torch.empty((e,), dtype=torch.int32, device=meta)
    wo.gmm_weight_only(x, wq, sc, sc, gs, gsize)
    gmm_weight_only_packed.gmm_weight_only_packed(x, wp, sc, sc, gs, gsize)
    gmm_mixed_wo_wxa.gmm_mixed_wo_wxa(x, aq, asc, wq, sc, fl, gs, rhs_zp=sc)
    s = weight_only_gmm_schedule(m, k, n, e, _g(k, gsize))
    want = (s.bm, s.grid_m, s.splits, s.k_tiles_per_split)
    for name, at in (("mxmoe_gmm_weight_only", 12), ("mxmoe_gmm_weight_only_packed", 12),
                     ("mxmoe_gmm_mixed_wo_wxa", 15)):
        args = rec.calls[name]
        assert args[at - 1] == _g(k, gsize)                  # gsize
        assert tuple(args[at:at + 4]) == want, name
        assert (args[at + 4] is None) == (s.splits == 1)     # workspace
    assert kernels.launches["gmm_weight_only"] == 1
    assert kernels.launches["gmm_mixed_wo_wxa"] == 1


def _body_splits(k, splits):
    """The decode body's split arithmetic, as written in wo_decode_body:
    pairs P = cdiv(K/2, 64), ceil(P / splits) a split; the pairs each split
    walks, the splits that write a partial, the partials the last block
    reads."""
    pairs = _cdiv(k // 2, PAIR)
    pps = _cdiv(pairs, splits)
    walked, written = [], []
    for z in range(splits):
        p0 = z * pps
        np_ = max(min(p0 + pps, pairs) - p0, 0)
        walked.append(list(range(p0, p0 + np_)))
        if np_ > 0:
            written.append(z)
    read = list(range(_cdiv(pairs, pps)))
    return walked, written, read


SPLIT_SHAPES = [(4, 2048, 11264, 1, 128), (4, 5632, 2048, 1, 128),
                (4, 2048, 11264, 1, 2048), (4, 5632, 2048, 1, 5632),
                (4, 2048, 5632, 1, 128), (1, 96, 64, 1, 96), (4, 1408, 64, 1, 1408),
                (2, 384, 48, 1, 128)]


@pytest.mark.parametrize("m,k,n,e,gsize", SPLIT_SHAPES)
def test_splits_cover_k_once(m, k, n, e, gsize):
    """Every code row of K lies in exactly one (split, pair, half)."""
    s = weight_only_gmm_schedule(m, k, n, e, gsize)
    assert s.bm == 16 and s.splits > 1
    walked, _, _ = _body_splits(k, s.splits)
    k2 = k // 2
    rows = [r for pairs in walked for p in pairs
            for r0 in (p * PAIR, k2 + p * PAIR)
            for r in range(r0, r0 + min(PAIR, k2 - p * PAIR))]
    assert sorted(rows) == list(range(k))


@pytest.mark.parametrize("m,k,n,e,gsize", SPLIT_SHAPES)
def test_split_slots_written_are_the_slots_read(m, k, n, e, gsize):
    """The splits that walk a pair write their partial at slot (tile, z, 0)
    of the w x a body's [tiles, splits, gmax, PART] layout (K10 runs both
    bodies over one workspace: a tile's slots are its own whatever its
    body), and the tile's last block reads exactly those, in ascending z,
    all inside the workspace the schedule sizes."""
    s = weight_only_gmm_schedule(m, k, n, e, gsize)
    _, written, read = _body_splits(k, s.splits)
    assert written == read
    tiles = s.grid_n * s.grid_m
    gmax = 1 if gsize == k else s.k_tiles_per_split * 64 // gsize
    stride = gmax * PART                                   # as wo_decode_body
    slots = [(t * s.splits + z) * stride for t in range(tiles) for z in read]
    assert len(set(slots)) == len(slots)
    # a w x a tile t' writes (t' * splits + z') * gmax + j, j < gmax: no two
    # tiles' regions meet
    assert all(t * s.splits * stride <= (t * s.splits + z) * stride
               < (t + 1) * s.splits * stride for t in range(tiles) for z in read)
    assert max(slots) + 15 * 64 + 63 < s.ws_ints and s.tickets == tiles


@pytest.mark.parametrize("k,splits", [(1408, 11), (2048, 3), (96, 4), (5632, 16)])
def test_empty_splits_only_at_the_end(k, splits):
    """A split past the last pair walks none and writes none; the splits
    before it all walk ceil(P / splits) pairs but the last that holds one."""
    walked, written, _ = _body_splits(k, splits)
    sizes = [len(w) for w in walked]
    assert sizes[:len(written)] == sorted(sizes[:len(written)], reverse=True)
    assert all(n == 0 for n in sizes[len(written):])


# ---------------------------------------------------------------------------
# the order of work
# ---------------------------------------------------------------------------

def _operands(seed, sizes, k, n, gsize, bits=4):
    rng = np.random.default_rng(seed)
    m, e = int(sum(sizes)), len(sizes)
    g = 1 if gsize == -1 else k // gsize
    hi = 1 << (bits - 1)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wq = rng.integers(-hi, hi, (e, k, n), dtype=np.int8)
    sc = (rng.random((e, g, n)) * 0.02 + 1e-3).astype(np.float32)
    zp = (rng.standard_normal((e, g, n)) * 0.05).astype(np.float32)
    return x, wq, sc, zp, np.asarray(sizes, np.int32)


def _weights(wq, sc, zp, gsize, dtype):
    q, s, z = T(wq), T(sc), T(zp)
    return lambda e: wo.dequantize_expert(q[e], s[e], z[e], gsize, dtype)


ORDER_CASES = [(1408, 128), (2048, 128), (1408, -1), (96, -1), (384, 128)]


@pytest.mark.parametrize("k,gsize", ORDER_CASES)
@pytest.mark.parametrize("splits", [1, 3, 11, 16])
def test_split_order_within_bound(k, gsize, splits):
    sizes, n = [3, 0, 2, 1, 0, 4], 48
    x, wq, sc, zp, gs = _operands(k + splits, sizes, k, n, gsize)
    xt = T(x).to(torch.bfloat16)
    weight_of = _weights(wq, sc, zp, _g(k, gsize), torch.bfloat16)
    got = wo.weight_only_split_plain(xt, weight_of, n, T(gs), splits,
                                     out_dtype=torch.float32)
    for out in (got, got.to(torch.bfloat16)):
        _, ratio = wo.error_over_bound(out, xt, T(wq), T(sc), T(zp), T(gs), gsize)
        assert ratio <= 1.0
    # the packed storage walks the same pairs: the same bits on the same codes
    pk = pack_int4_halves(T(wq))
    packed_of = lambda e: wo.dequantize_expert(unpack_int4_halves(pk[e]), T(sc)[e],
                                               T(zp)[e], _g(k, gsize), torch.bfloat16)
    assert torch.equal(wo.weight_only_split_plain(xt, packed_of, n, T(gs), splits,
                                                  out_dtype=torch.float32), got)


@pytest.mark.parametrize("k,gsize,splits", [(1408, 128, 11), (2048, 128, 2),
                                            (1408, -1, 5), (384, 128, 3)])
@pytest.mark.parametrize("mutation", ["drop_split", "drop_high_half"])
def test_split_order_mutations_are_seen(k, gsize, splits, mutation):
    """The bound catches a fold that loses one split's partial or the high
    halves (code rows K/2 ..) of every pair."""
    n = 48
    x, wq, sc, zp, gs = _operands(7 * k + splits, [5], k, n, gsize)
    xt = T(x).to(torch.bfloat16)
    weight_of = _weights(wq, sc, zp, _g(k, gsize), torch.bfloat16)
    parts = wo.split_partials(xt, weight_of(0), splits)
    assert len(parts) > 1 or mutation == "drop_high_half"
    good = wo.fold_partials(parts)
    if mutation == "drop_split":
        bad = wo.fold_partials(parts[:1] + parts[2:])
    else:
        bad = wo.fold_partials([(lo, torch.zeros_like(hi)) for lo, hi in parts])
    _, ratio_good = wo.error_over_bound(good, xt, T(wq), T(sc), T(zp), T(gs), gsize)
    _, ratio_bad = wo.error_over_bound(bad, xt, T(wq), T(sc), T(zp), T(gs), gsize)
    assert ratio_good <= 1.0 < ratio_bad


JAX_CASES = [([5, 0, 3, 1, 0, 4], 384, 64, 128), ([2, 1, 0, 6], 256, 64, -1),
             ([7], 384, 32, 128)]


@pytest.mark.parametrize("sizes,k,n,gsize", JAX_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [1, 2])
def test_split_order_vs_jax(sizes, k, n, gsize, dtype, splits):
    """The decode body's order against the JAX K6 and K7 in interpret mode."""
    x, wq, sc, zp, gs = _operands(k + n + splits, sizes, k, n, gsize)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj, xt = jnp.asarray(x).astype(jdt), T(x).to(tdt)
    g = _g(k, gsize)
    args = (jnp.asarray(sc), jnp.asarray(zp), jnp.asarray(gs))
    refs = (pallas_gmm.gmm_weight_only(xj, jnp.asarray(wq), *args, gsize=g, bm=16,
                                       bn=32, out_dtype=jdt, interpret=True),
            pallas_gmm.gmm_weight_only_packed(
                xj, jp.pack_int4_halves(jnp.asarray(wq)), *args, gsize=g, bm=16,
                bn=32, out_dtype=jdt, interpret=True))
    got = wo.weight_only_split_plain(xt, _weights(wq, sc, zp, g, tdt), n, T(gs),
                                     splits, out_dtype=tdt).float().numpy()
    mag = wo.grouped_weight_only_plain(
        xt.float().abs(), lambda e: _weights(wq, sc, zp, g, torch.float32)(e).abs(),
        n, T(gs), torch.float64, torch.float64).numpy()
    for ref in refs:
        r = np.asarray(ref.astype(jnp.float32))
        d = np.abs(got - r)
        if dtype == "bfloat16":
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(r), 2.0 ** -126))) - 7)
            assert (d <= ulp).all()
        else:
            assert (d <= mag * (k * 2.0 ** -24 + 2.0 ** -22)).all()


# ---------------------------------------------------------------------------
# the conversion without I2F
# ---------------------------------------------------------------------------

def magic_f32(biased: torch.Tensor, bias: int) -> torch.Tensor:
    """The decode body's code -> f32 (``biased_code``), in torch integer ops:
    the biased byte u (a code plus ``bias``, 0..255) becomes the f32 bits
    0x4B000000 | u (2^23 + u: what __byte_perm(u, 0x4B000000, 0x754i)
    builds), and 2^23 + bias is subtracted."""
    bits = (biased.to(torch.int32) & 0xFF) | 0x4B000000
    return bits.view(torch.float32) - (8388608.0 + bias)


def int8_biased(codes: torch.Tensor) -> torch.Tensor:
    return (codes.to(torch.int32) & 0xFF) ^ 0x80          # the byte ^ 0x80


def nibble_biased(packed: torch.Tensor, high: bool) -> torch.Tensor:
    b = packed.to(torch.int32) & 0xFF
    return ((b >> 4 if high else b) & 0x0F) ^ 0x08


def bf16_rne_bits(f: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 bits rounded to nearest even in integer ops, as
    cvt.rn.bf16x2.f32 rounds a finite value."""
    u = f.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) & 0xFFFF


def test_magic_conversion_of_all_int8_codes():
    codes = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    got = magic_f32(int8_biased(codes), 128)
    want = codes.float()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))   # +0, not -0


def test_magic_conversion_of_all_nibbles():
    """Every byte of a packed tile: its low and high nibbles, each the signed
    4-bit code of the halves layout."""
    byte = torch.arange(256, dtype=torch.int32).to(torch.uint8).to(torch.int8)
    lo = (((byte.to(torch.int32) & 0xF) ^ 8) - 8).float()
    hi = ((((byte.to(torch.int32) >> 4) & 0xF) ^ 8) - 8).float()
    assert torch.equal(magic_f32(nibble_biased(byte, False), 8).view(torch.int32),
                       lo.view(torch.int32))
    assert torch.equal(magic_f32(nibble_biased(byte, True), 8).view(torch.int32),
                       hi.view(torch.int32))
    assert sorted(set(lo.tolist())) == list(range(-8, 8))


SCALES = {"small": (1e-3, 0.02), "negative": (-0.05, -1e-4), "zero": (0.0, 0.0),
          "large": (1e3, 3e4)}
ZPS = {"negative": (-0.3, -1e-3), "zero": (0.0, 0.0), "large": (-2e4, 2e4)}


@pytest.mark.parametrize("scale", sorted(SCALES))
@pytest.mark.parametrize("zp", sorted(ZPS))
def test_dequantized_bits_equal_dequantize_expert(scale, zp):
    """The body's weights (magic code, __fmul_rn, __fadd_rn, one RNE to bf16)
    bitwise ``dequantize_expert``'s, for int8-stored codes and both nibbles of
    the packed storage, g64 over K 256."""
    rng = np.random.default_rng(len(scale) * 31 + len(zp))
    k, n, gsize = 256, 24, 64
    s_lo, s_hi = SCALES[scale]
    z_lo, z_hi = ZPS[zp]
    sc = T((rng.random((k // gsize, n)) * (s_hi - s_lo) + s_lo).astype(np.float32))
    zpt = T((rng.random((k // gsize, n)) * (z_hi - z_lo) + z_lo).astype(np.float32))
    w8 = T(rng.integers(-128, 128, (k, n), dtype=np.int8))
    w4 = T(rng.integers(-8, 8, (k, n), dtype=np.int8))
    pk = pack_int4_halves(w4)

    def body(f):
        w = f.reshape(k // gsize, gsize, n) * sc[:, None, :]   # __fmul_rn
        w = w + zpt[:, None, :]                                # __fadd_rn
        return bf16_rne_bits(w.reshape(k, n))

    k2 = k // 2
    f4 = torch.cat([magic_f32(nibble_biased(pk, False), 8),
                    magic_f32(nibble_biased(pk, True), 8)])   # rows k, then K/2 + k
    for f, codes in ((magic_f32(int8_biased(w8), 128), w8), (f4, w4)):
        want = wo.dequantize_expert(codes, sc, zpt, gsize, torch.bfloat16)
        want_bits = want.view(torch.int16).to(torch.int64) & 0xFFFF
        assert torch.equal(body(f), want_bits)
    assert f4.shape[0] == 2 * k2
