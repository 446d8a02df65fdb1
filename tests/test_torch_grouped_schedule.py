"""The grouped-scale GEMM's decode schedule (K8 ``gmm_w8a8_grouped`` and K4f,
the flex form of ``gmm_mixed_packed``, share one decode kernel):
``grouped_gmm_schedule`` at the decode shapes of the main path, the split
workspace's slot arithmetic of ``csrc/gmm_grouped_tile.cuh`` written out, and
the kernel's order of work (``grouped_decode_plain``: the logical walk, a
packed expert's byte rows read once for each half of K, int32 group sums
added per group in split order; the one-pass walk of a packed expert, its
high half's group sums held and the straddling group's two parts added;
groups folded in ascending order).

Tolerances. ``grouped_decode_plain`` against the plain versions of K8 and K4f
and against K8 on the unpacked codes: bitwise (exact int32 group sums, the
same f32 steps in the same group order). Against the JAX kernels in
interpret mode: XLA on the CPU contracts ``x * s_b + acc`` into one FMA
where the port rounds every product and sum on its own, so f32 outputs
agree within 2^-21 * max|ref| (four f32 ulps at the largest output) and
bf16 outputs within one bf16 ulp of the reference element, as for K8 and
K4f themselves (test_torch_gmm_grouped.py, test_torch_gmm_mixed_packed_flex.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.ops import pallas_gmm
from mxmoe_tpu.quant import packing as jp
from mxmoe_tpu_torch.ops.gmm_mixed_packed import gmm_mixed_packed_plain
from mxmoe_tpu_torch.ops.gmm_w8a8 import (DECODE_M, K_TILE, SMS, grouped_decode_plain,
                                          logical_rows)
from mxmoe_tpu_torch.ops.gmm_w8a8_grouped import (GROUPED_BM, MAX_SPLITS,
                                                  grouped_gmm_schedule,
                                                  gmm_w8a8_grouped_plain)
from mxmoe_tpu_torch.quant.packing import build_ragged_mixed, pack_int4_halves

T = torch.from_numpy
PART = 16 * 64 + 16       # int32 of one (split, group) part: m16 x 64 + row sums

# (K, N) of the expert products on the main path: qwen2_moe routed gate_up /
# down (H 2048, N 1408); the E = 1 shared experts of qwen2_moe (N 5632) and
# ds2 (two shared experts, N 2816)
ROUTED = [(2048, 2816), (1408, 2048)]
SHARED = [(2048, 11264), (5632, 2048), (2048, 5632), (2816, 2048)]


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [4, 16, 24])
@pytest.mark.parametrize("e", [60, 64])
@pytest.mark.parametrize("k,n", ROUTED)
def test_decode_schedule_fills_the_card_routed(m, e, k, n):
    s = grouped_gmm_schedule(m, k, n, e, 128)
    assert s.bm == 16 and s.bn == 64 and s.blocks >= 2 * SMS, s
    assert s.grid_m == min(-(-m // 16) + e - 1, m)            # bounded by M


@pytest.mark.parametrize("m", [4, 16, 24])
@pytest.mark.parametrize("k,n", SHARED)
@pytest.mark.parametrize("grouped", [True, False], ids=["g128", "one_group"])
def test_decode_schedule_fills_the_card_one_expert(m, k, n, grouped):
    """E = 1 (a grouped or asymmetric shared expert): where the grid alone is
    short (32-176 column blocks a row block), K is split."""
    s = grouped_gmm_schedule(m, k, n, 1, 128 if grouped else k)
    assert s.bm == 16 and s.blocks >= 2 * SMS, s
    assert (s.splits > 1) == (s.grid_n * s.grid_m < 2 * SMS)


@pytest.mark.parametrize("m,k,n,e,gsize", [
    (4, 2048, 11264, 1, 128), (4, 5632, 2048, 1, 128), (4, 2816, 2048, 1, 128),
    (4, 1408, 2048, 60, 128), (4, 2048, 2816, 60, 128), (4, 5632, 2048, 1, 5632),
    (1, 96, 48, 3, 96), (4, 2048, 1024, 1, 256), (4, 1408, 64, 1, 1408)])
def test_splits_cut_k_at_whole_groups(m, k, n, e, gsize):
    s = grouped_gmm_schedule(m, k, n, e, gsize)
    kt = -(-k // K_TILE)
    assert s.splits > 1 and s.splits <= MAX_SPLITS
    if gsize != k:                                  # whole groups a split
        assert s.k_tiles_per_split % (gsize // K_TILE) == 0
    bounds = [min(z * s.k_tiles_per_split, kt) for z in range(s.splits + 1)]
    assert bounds[-1] == kt and bounds[-2] < kt            # every split holds a tile
    gmax = 1 if gsize == k else s.k_tiles_per_split * K_TILE // gsize
    assert s.ws_ints == s.grid_n * s.grid_m * s.splits * gmax * PART
    assert s.tickets == s.grid_n * s.grid_m


def test_prefill_and_unaligned_take_the_32_row_tile():
    assert grouped_gmm_schedule(DECODE_M + 1, 2048, 2816, 60, 128).bm == GROUPED_BM
    s = grouped_gmm_schedule(256, 2048, 2816, 60, 128)
    assert (s.bm, s.bn, s.grid_n, s.grid_m, s.splits) == (32, 128, 22, 8 + 59, 1)
    assert grouped_gmm_schedule(16, 96, 40, 3, 96).bm == GROUPED_BM     # N % 16
    assert grouped_gmm_schedule(16, 2048, 2816, 60, 128, aligned=False).bm == 32
    # at decode M the routed shapes need no split
    s = grouped_gmm_schedule(16, 2048, 2816, 60, 128)
    assert (s.grid_n, s.grid_m, s.splits, s.k_tiles_per_split) == (44, 16, 1, 32)
    s = grouped_gmm_schedule(16, 1408, 2048, 60, 128)
    assert (s.grid_n, s.grid_m, s.splits, s.k_tiles_per_split) == (32, 16, 1, 22)


def _kernel_slots(k, gsize, tps, splits):
    """The decode kernel's split-K index arithmetic, as written in
    gmm_grouped_tile.cuh: the (split, slot) each split writes for each group
    it holds, and the (split, slot) the last block reads for each group."""
    kt = -(-k // K_TILE)
    groups = k // gsize
    gmax = 1 if groups == 1 else tps * K_TILE // gsize
    written = {}
    for z in range(splits):
        kt0 = z * tps
        nk = max(min(kt0 + tps, kt) - kt0, 0)
        for t in range(nk):
            tg = kt0 + t
            closes = ((tg + 1) * K_TILE) % gsize == 0 or tg == kt - 1
            if closes or t == nk - 1:
                g = tg * K_TILE // gsize
                j = g - kt0 * K_TILE // gsize
                assert 0 <= j < gmax
                assert (z, j) not in written.values()
                written[(z, g)] = (z, j)
    read = {}
    for g in range(groups):
        tf = g * gsize // K_TILE
        tl = min(((g + 1) * gsize + K_TILE - 1) // K_TILE, kt) - 1
        for z in range(tf // tps, tl // tps + 1):
            read[(z, g)] = (z, g - z * tps * K_TILE // gsize)
    return written, read


@pytest.mark.parametrize("m,k,n,e,gsize", [
    (4, 2048, 11264, 1, 128), (4, 5632, 2048, 1, 128), (4, 2816, 2048, 1, 128),
    (4, 2048, 5632, 1, 128), (4, 1408, 2048, 60, 128), (4, 2048, 2816, 60, 128),
    (4, 5632, 2048, 1, 5632), (4, 2048, 11264, 1, 2048), (1, 96, 48, 3, 96),
    (4, 1408, 64, 1, 1408)])
def test_split_slots_written_are_the_slots_read(m, k, n, e, gsize):
    """Every (split, group) part the splits write is read once by the tile's
    last block and nothing else is: the workspace needs no zeroing."""
    s = grouped_gmm_schedule(m, k, n, e, gsize)
    written, read = _kernel_slots(k, gsize, s.k_tiles_per_split, s.splits)
    assert written == read


# ---------------------------------------------------------------------------
# the order of work, bitwise the plain versions
# ---------------------------------------------------------------------------

def _operands(seed, sizes, k, n, groups, w4=False):
    rng = np.random.default_rng(seed)
    m, e = int(sum(sizes)), len(sizes)
    aq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    asc = (rng.random((m, groups)) * 0.05 + 1e-3).astype(np.float32)
    hi = 8 if w4 else 128
    wq = rng.integers(-hi + (not w4), hi, (e, k, n)).astype(np.int8)
    wsc = (rng.random((e, groups, n)) * 0.01 + 1e-4).astype(np.float32)
    wzp = (rng.standard_normal((e, groups, n)) * 0.02).astype(np.float32)
    return aq, asc, wq, wsc, wzp, np.asarray(sizes, np.int32)


# decode-like routing: one to a few rows an expert, empty experts between
SIZES = [1, 0, 3, 1, 0, 0, 2, 5]
# k-tiles a split: whole groups of two k-tiles at g128 (the schedule's
# cuts), 0 = unsplit
SPLITS_G128 = [0, 2, 6]
SPLITS_ONE_GROUP = [0, 3, 5]


def _tps(k, tps):
    return tps or -(-k // K_TILE)


@pytest.mark.parametrize("k", [2048, 1408])
@pytest.mark.parametrize("grouped,tps", [*[(True, t) for t in SPLITS_G128],
                                         *[(False, t) for t in SPLITS_ONE_GROUP]])
@pytest.mark.parametrize("asym", [False, True], ids=["sym", "zp"])
def test_decode_order_bitwise_k8_plain(k, grouped, tps, asym):
    gsize = 128 if grouped else k
    aq, asc, wq, wsc, wzp, gs = _operands(k + tps + asym, SIZES, k, 32, k // gsize)
    zp = T(wzp) if asym else None
    out = torch.float32 if asym else torch.bfloat16
    got = grouped_decode_plain(T(aq), T(asc), lambda e: (T(wq)[e], False), T(wsc),
                               T(gs), gsize, _tps(k, tps), zp, out)
    ref = gmm_w8a8_grouped_plain(T(aq), T(asc), T(wq), T(wsc), T(gs), gsize, zp,
                                 out_dtype=out)
    assert torch.equal(got, ref)


STORAGES = {"all_packed": [1] * len(SIZES), "alternating": [i % 2 for i in
                                                            range(len(SIZES))],
            "none_packed": [0] * len(SIZES)}


@pytest.mark.parametrize("k", [2048, 1408])
@pytest.mark.parametrize("storage", sorted(STORAGES))
@pytest.mark.parametrize("grouped,tps,one_pass", [
    (True, 0, True), (True, 0, False), (True, 6, True), (False, 0, True),
    (False, 5, True)], ids=["g128-one_pass", "g128-logical", "g128-split",
                            "one_group-one_pass", "one_group-split"])
@pytest.mark.parametrize("asym", [False, True], ids=["sym", "zp"])
def test_decode_order_bitwise_k4f_plain(k, storage, grouped, tps, one_pass, asym):
    """K 1408 at g128: group 5 (k 640-767) is the low nibbles of byte rows
    640-703 and the high nibbles of byte rows 0-63, summed into one int32
    group sum (the one-pass walk holds the high part and adds the low part
    at the end; the logical walk sums them in k order). With one group the
    one-pass walk's low and high halves are both that group's."""
    gsize = 128 if grouped else k
    pflags = STORAGES[storage]
    aq, asc, wq, wsc, wzp, gs = _operands(7 * k + tps, SIZES, k, 32, k // gsize,
                                          w4=True)
    w8 = np.random.default_rng(k).integers(-127, 128, wq.shape).astype(np.int8)
    wq = np.where(np.asarray(pflags, bool)[:, None, None], wq, w8)
    cat, blk = build_ragged_mixed(T(wq), pflags)
    k2 = k // 2
    zp = T(wzp) if asym else None

    def storage_of(e):
        rows = k2 if pflags[e] else k
        return cat[blk[e] * k2: blk[e] * k2 + rows], bool(pflags[e])

    got = grouped_decode_plain(T(aq), T(asc), storage_of, T(wsc), T(gs), gsize,
                               _tps(k, tps), zp, torch.float32, one_pass=one_pass)
    ref = gmm_mixed_packed_plain(T(aq), T(asc), cat, T(wsc), T(gs),
                                 torch.tensor(pflags, dtype=torch.int32),
                                 torch.tensor(blk, dtype=torch.int32), rhs_zp=zp,
                                 out_dtype=torch.float32)
    same_codes = gmm_w8a8_grouped_plain(T(aq), T(asc), T(wq), T(wsc), T(gs), gsize,
                                        zp, out_dtype=torch.float32)
    assert torch.equal(got, ref) and torch.equal(got, same_codes)


@pytest.mark.parametrize("k", [192, 1408, 2048])
def test_logical_rows_of_packed_storage(k):
    """Tiles of 64 code rows, and the tile that straddles K/2 when K/2 % 64
    != 0 (K 192: rows 64-127 are byte rows 64-95 low and 0-31 high)."""
    w = T(np.random.default_rng(k).integers(-8, 8, (k, 24)).astype(np.int8))
    packed = pack_int4_halves(w)
    for k0 in range(0, k, K_TILE):
        k1 = min(k0 + K_TILE, k)
        assert torch.equal(logical_rows(packed, True, k, k0, k1), w[k0:k1])
        assert torch.equal(logical_rows(w, False, k, k0, k1), w[k0:k1])


@pytest.mark.parametrize("one_pass", [True, False], ids=["one_pass", "logical"])
def test_a_dropped_straddle_part_is_seen(one_pass):
    """Both walks are sensitive to the straddling group: reading group 5's
    high rows from the low nibbles changes the output."""
    k, gsize = 1408, 128
    aq, asc, wq, wsc, _, gs = _operands(5, [2, 3], k, 32, k // gsize, w4=True)
    packed = pack_int4_halves(T(wq))
    good = grouped_decode_plain(T(aq), T(asc), lambda e: (packed[e], True), T(wsc),
                                T(gs), gsize, 22, None, torch.float32,
                                one_pass=one_pass)
    bad_block = packed.clone()
    # byte rows 0-63 with their high nibbles replaced by the low ones
    lo = bad_block[:, :64].to(torch.int32) & 0xF
    bad_block[:, :64] = (((lo | (lo << 4)) ^ 0x80) - 0x80).to(torch.int8)
    bad = grouped_decode_plain(T(aq), T(asc), lambda e: (bad_block[e], True),
                               T(wsc), T(gs), gsize, 22, None, torch.float32,
                               one_pass=one_pass)
    assert not torch.equal(good, bad)


# ---------------------------------------------------------------------------
# against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------

def _assert_close_to_jax(got, ref, out):
    g = got.float().numpy()
    r = np.asarray(ref.astype(jnp.float32))
    if out == "float32":
        np.testing.assert_allclose(g, r, rtol=0, atol=2.0 ** -21 * np.abs(r).max())
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(r), 2.0 ** -126))) - 7)
        assert (np.abs(g - r) <= ulp).all()


JAX_SIZES = [1, 0, 2, 1, 0, 3]


@pytest.mark.parametrize("k,gsize,tps", [(1408, 128, 4), (2048, 128, 0),
                                         (1408, 1408, 3)])
@pytest.mark.parametrize("asym", [False, True], ids=["sym", "zp"])
def test_decode_order_vs_jax_gmm_w8a8_grouped(k, gsize, tps, asym):
    n = 128
    aq, asc, wq, wsc, wzp, gs = _operands(k + gsize, JAX_SIZES, k, n, k // gsize)
    zp = wzp if asym else None
    ref = pallas_gmm.gmm_w8a8_grouped(
        jnp.asarray(aq), jnp.asarray(asc), jnp.asarray(wq), jnp.asarray(wsc),
        jnp.asarray(gs), gsize=gsize, bm=16, bn=128,
        rhs_zp=None if zp is None else jnp.asarray(zp), out_dtype=jnp.float32,
        interpret=True)
    got = grouped_decode_plain(T(aq), T(asc), lambda e: (T(wq)[e], False), T(wsc),
                               T(gs), gsize, _tps(k, tps),
                               None if zp is None else T(zp), torch.float32)
    _assert_close_to_jax(got, ref, "float32")


@pytest.mark.parametrize("k,storage", [(1408, "alternating"), (1408, "all_packed"),
                                       (2048, "alternating")])
@pytest.mark.parametrize("asym", [False, True], ids=["sym", "zp"])
def test_decode_order_vs_jax_gmm_mixed_packed_flex(k, storage, asym):
    n, gsize = 128, 128
    pflags = {"alternating": [i % 2 for i in range(len(JAX_SIZES))],
              "all_packed": [1] * len(JAX_SIZES)}[storage]
    aq, asc, wq, wsc, wzp, gs = _operands(3 * k, JAX_SIZES, k, n, k // gsize, w4=True)
    zp = wzp if asym else None
    cat_j, blk_j = jp.build_ragged_mixed(jnp.asarray(wq), pflags)
    ref = pallas_gmm.gmm_mixed_packed(
        jnp.asarray(aq), jnp.asarray(asc), cat_j, jnp.asarray(wsc), jnp.asarray(gs),
        jnp.asarray(pflags, jnp.int32), jnp.asarray(blk_j, jnp.int32), bm=16, bn=128,
        rhs_zp=None if zp is None else jnp.asarray(zp), out_dtype=jnp.bfloat16,
        interpret=True)
    cat, blk = build_ragged_mixed(T(wq), pflags)
    k2 = k // 2

    def storage_of(e):
        rows = k2 if pflags[e] else k
        return cat[blk[e] * k2: blk[e] * k2 + rows], bool(pflags[e])

    got = grouped_decode_plain(T(aq), T(asc), storage_of, T(wsc), T(gs), gsize,
                               _tps(k, 0), None if zp is None else T(zp),
                               torch.bfloat16)
    _assert_close_to_jax(got, ref, "bfloat16")
