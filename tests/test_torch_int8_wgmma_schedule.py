"""The wgmma body over group sizes read on the device (K2 / K5 above the
decode rows, K14's second phase; ``csrc/gmm_ws_body.cuh``) and K14's two
bodies, written out on the CPU:

* the walk: ``ops/gmm_ws.py::ws_device_work_items`` and the kernel's cursor
  (``WsWalk``, transcribed below) give every CTA the same items; each
  (group, n-tile, m-tile) is visited once, every stored row lies in its own
  group and is stored once an n-tile, rows past ``sum(group_sizes)`` (or M)
  are never stored: at the headline's 32762 unaligned rows, a prefill chunk,
  empty groups, one group, 1024 groups, groups past M;
* the schedules: ``int8_gmm_schedule(..., wgmma=True)`` from the decode
  edge on, the domain edges that keep the 64 x 128 body, the decode
  schedule unchanged; ``fusedquant_schedule`` (K2's decode schedule, the
  wgmma body above, K1 + K2 outside the domain);
* K14 emulated: the large-M design (every row quantized once with K1's
  arithmetic, then the walk's 128-row tiles over the codes, rows of the next
  group multiplied and not stored) and the decode body (a block's amax over
  all of K, each k-tile of its split quantized into the A stage, the
  splits' exact partials added in order), each bitwise ``gmm_w8a8_fusedquant_plain`` and K1 + K2's plain
  versions at K 1408 / 2048 / 4096 and unaligned sizes, and, with the scale
  taken as the JAX kernel's interpret mode takes it (a multiply by
  f32(1 / upper), pinned in ``tests/test_torch_gmm_ws.py``), bitwise the JAX
  ``gmm_w8a8_fusedquant`` in interpret mode; with K1's division, bitwise it
  on every row whose two scales agree (the others are one ulp apart, where
  a code may round the other way). A decode block that took its amax over
  its own k-range only, or a walk whose tiles start at multiples of 128,
  must fail (mutation checks).

Tolerance: none. The int32 sums are exact in any order (float64 here, exact
for these magnitudes) and every f32 step is the plain version's.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.ops import pallas_gmm
from mxmoe_tpu_torch.bench import workloads
from mxmoe_tpu_torch.ops import act_quant, gmm_w8a8, gmm_ws
from mxmoe_tpu_torch.ops import gmm_w8a8_fusedquant as gfq
from mxmoe_tpu_torch.ops.gmm_w8a8 import (DECODE_M, WGMMA_MAX_K, WGMMA_MIN_M,
                                          int8_gmm_schedule)
from mxmoe_tpu_torch.ops.gmm_ws import WS_BM, WS_BN

HEADLINE = tuple(workloads.QWEN2_MOE_L10_BS8192_ROUTED_M)


def _chunk(rows, e, seed):
    """A prefill chunk's routing: ``rows`` over ``e`` experts, some empty."""
    rng = np.random.default_rng(seed)
    counts = np.bincount(rng.integers(0, e, rows), minlength=e)
    counts[1] = 0
    counts[0] += rows - counts.sum()
    return tuple(int(c) for c in counts)


# name -> (group sizes, N, M)
WALK_CASES = {
    "headline unaligned": (HEADLINE, 2816, sum(HEADLINE)),
    "qwen2_moe chunk": (_chunk(1024, 60, 1), 2816, 1024),
    "ds2 chunk": (_chunk(1536, 64, 2), 2048, 1536),
    "empty groups": ((0, 0, 130, 0, 1, 0, 257, 0), 512, 388),
    "one group": ((256,), 11264, 256),
    "1024 groups": (tuple((i * 7) % 5 for i in range(1024)), 256, 2048),
    "tail past the groups": ((5, 0, 90), 768, 200),
    "groups past M": ((100, 300, 50), 512, 330),
    "first group empty": ((0, 129, 127), 300, 256),
}


def _cursor_walk(sizes, n, m, cta, grid):
    """The kernel's ``WsWalk::seek`` over items cta, cta + grid, ...: the
    group cursor moves forward only, reading a group's size when it gets
    there; a group stores rows [row0, min(row0 + size, M))."""
    nt = -(-n // WS_BN)

    def tiles(size, row0):
        return -(-max(min(size, m - row0), 0) // WS_BM)

    g, item0, row0 = 0, 0, 0
    size = sizes[0]
    mt = tiles(size, 0)
    out, w = [], cta
    while True:
        while w >= item0 + mt * nt:
            item0 += mt * nt
            row0 += size
            g += 1
            if g >= len(sizes):
                return out
            size = sizes[g]
            mt = tiles(size, row0)
        r = w - item0
        out.append((g, r // mt, r % mt, row0 + (r % mt) * WS_BM, min(row0 + size, m)))
        w += grid


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_each_item_once_and_the_cursor_is_the_walk(case):
    sizes, n, m = WALK_CASES[case]
    items = gmm_ws.ws_device_work_items(sizes, n, m)
    keys = [it[:3] for it in items]
    assert len(keys) == len(set(keys))
    for grid in (1, 7, 132):
        seen = []
        for cta in range(grid):
            walk = _cursor_walk(sizes, n, m, cta, grid)
            assert walk == items[cta::grid]
            seen += walk
        assert sorted(seen) == sorted(items)


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_stored_rows_lie_in_their_group_once(case):
    sizes, n, m = WALK_CASES[case]
    starts = list(itertools.accumulate(sizes, initial=0))
    stored = {}
    for g, j, i, m0, row_end in gmm_ws.ws_device_work_items(sizes, n, m):
        assert m0 == starts[g] + i * WS_BM and row_end == min(starts[g + 1], m)
        rows = range(m0, min(m0 + WS_BM, row_end))
        assert len(rows) > 0                     # no item without a stored row
        # the first consumer warpgroup's 64 rows always hold a stored row
        assert m0 < row_end
        for r in rows:
            assert starts[g] <= r < starts[g + 1] and r < m
            assert (r, j) not in stored          # never written twice
            stored[(r, j)] = g
    # every row of the groups up to M stored once an n-tile, nothing past
    live = min(sum(sizes), m)
    nt = -(-n // WS_BN)
    assert sorted(stored) == [(r, j) for r in range(live) for j in range(nt)]


def test_tiles_start_at_the_group_not_at_a_multiple_of_128():
    """Two neighbouring groups write disjoint rows of one 128-row window."""
    items = gmm_ws.ws_device_work_items((100, 60), 256, 160)
    assert [it[3:] for it in items] == [(0, 100), (100, 160)]


def test_headline_items_match_the_aligned_layout():
    """The unaligned headline walks K15's 287 m-tiles an n-tile; 35 of them
    end within 64 rows, where the second warpgroup issues no MMA."""
    items = gmm_ws.ws_device_work_items(HEADLINE, 2816, sum(HEADLINE))
    aligned = gmm_ws.ws_work_items([(s + 127) // 128 * 128 for s in HEADLINE], 2816)
    assert len(items) == len(aligned) == 287 * 11
    half = {(g, i) for g, j, i, m0, end in items if end - m0 <= 64}
    assert len(half) == 35


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------

ROUTED = [(2048, 2816), (1408, 2048)]


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "packed"])
@pytest.mark.parametrize("m", [WGMMA_MIN_M, 128, 1024, 1536, 32762, 36736])
def test_k2_k5_take_the_wgmma_body_above_the_decode_rows(m, packed):
    assert WGMMA_MIN_M == DECODE_M + 1
    for k, n in ROUTED + [(2048, 11264), (5632, 2048), (14336, 4096), (3584, 2560)]:
        s = int8_gmm_schedule(m, k, n, 60, packed, wgmma=True)
        assert (s.bm, s.bn, s.splits) == (128, 256, 1), (k, n, s)
        assert s.k_tiles_per_split == -(-k // 128) and s.grid_n == -(-n // 256)
        assert s.grid_m == -(-m // 128) + 60
        # K4 and K9 (no wgmma) keep the 64 x 128 body
        assert int8_gmm_schedule(m, k, n, 60, packed).bm == 64


@pytest.mark.parametrize("m", [1, 4, 16, 17, 24, 64])
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "packed"])
def test_decode_schedule_unchanged(m, packed):
    for k, n in ROUTED:
        for e in (1, 60):
            assert int8_gmm_schedule(m, k, n, e, packed, wgmma=True) == \
                int8_gmm_schedule(m, k, n, e, packed)
            assert int8_gmm_schedule(m, k, n, e, packed, wgmma=True).bm == 16


@pytest.mark.parametrize("m,k,n,packed,aligned", [
    (1024, 2048, 2824, False, True),      # N % 16 != 0
    (1024, 2048, 2816, False, False),     # weights not 16-byte aligned
    (1024, 96, 512, True, True),          # packed K % 64 != 0
    (1024, 2 * WGMMA_MAX_K, 256, False, True),   # K past the int32 bound
])
def test_domain_edges_keep_the_64_row_tile(m, k, n, packed, aligned):
    assert int8_gmm_schedule(m, k, n, 8, packed, aligned, wgmma=True).bm == 64
    assert int8_gmm_schedule(m, k, n, 8, packed, aligned, wgmma=True) == \
        int8_gmm_schedule(m, k, n, 8, packed, aligned)


def test_int8_k_needs_only_16():
    """int8 weights: any K % 16 (the box past K reads zeros)."""
    assert int8_gmm_schedule(300, 80, 384, 3, wgmma=True).bm == 128
    assert int8_gmm_schedule(300, 96, 384, 3, True, wgmma=True).bm == 64


@pytest.mark.parametrize("m,k,n,e", [(16, 2048, 2816, 60), (16, 1408, 2048, 60),
                                     (4, 2048, 11264, 1), (4, 5632, 2048, 1),
                                     (16, 14336, 4096, 8), (64, 4096, 1024, 8),
                                     (1, 80, 384, 4), (33, 3584, 2560, 64)])
def test_fusedquant_decode_schedule_is_k2s(m, k, n, e):
    """K14 at decode rows runs K2's decode body on K2's schedule: the same
    grid, splits at whole k-tiles covering K once."""
    s = gfq.fusedquant_schedule(m, k, n, e)
    assert s == int8_gmm_schedule(m, k, n, e) and s.bm == 16
    kt = -(-k // 64)
    assert (s.splits - 1) * s.k_tiles_per_split < kt <= s.splits * s.k_tiles_per_split
    if s.splits > 1:
        assert s.ws_ints == s.grid_n * s.grid_m * s.splits * (16 * 64 + 16)
        assert s.tickets == s.grid_n * s.grid_m


def test_fusedquant_schedule_edges():
    assert gfq.fusedquant_schedule(65, 2048, 2816, 60).bm == 128
    assert gfq.fusedquant_schedule(32762, 2048, 2816, 60).bm == 128
    assert gfq.fusedquant_schedule(1024, 2048, 2824, 60) is None   # N % 16
    assert gfq.fusedquant_schedule(16, 2048, 2824, 60) is None
    assert gfq.fusedquant_schedule(1024, 2048, 2816, 60, aligned=False) is None


# ---------------------------------------------------------------------------
# K14 emulated
# ---------------------------------------------------------------------------

def _box_rows(t, r0, r1):
    """t[r0:r1] with zero rows past t's end (a TMA box past M)."""
    out = torch.zeros((r1 - r0, t.shape[1]), dtype=t.dtype)
    out[:max(min(r1, t.shape[0]) - r0, 0)] = t[r0:r1]
    return out


def _scales(x, bits, reciprocal=False, k0=0, k1=None):
    """K1's scales of x's rows (amax over codes k0..k1), or the JAX kernel's
    interpret reading (amax * f32(1 / upper))."""
    upper = float((1 << (bits - 1)) - 1)
    amax = torch.clamp(x.float()[:, k0:k1].abs().amax(-1, keepdim=True), min=1e-8)
    if reciprocal:
        return amax * torch.tensor(1.0 / upper, dtype=torch.float32)
    return amax / upper


def large_m_emulated(x, wq, wsc, sizes, bits, out_dtype, reciprocal=False):
    """K14's large-M design: phase 1 quantizes every row once (K1's
    arithmetic), phase 2 walks ``ws_device_work_items`` over the codes, each
    item's 128-row A tile from the codes (rows of the next group included,
    zeros past M), K2's epilogue on its stored rows."""
    m, k = x.shape
    n = wq.shape[2]
    s = _scales(x, bits, reciprocal)
    q = torch.round(x.float() / s).to(torch.int8)
    out = torch.zeros((m, n), dtype=out_dtype)
    for g, j, i, m0, row_end in gmm_ws.ws_device_work_items(sizes, n, m):
        n0 = j * WS_BN
        cols = min(WS_BN, n - n0)
        acc = _box_rows(q, m0, m0 + WS_BM).double() @ wq[g, :, n0:n0 + cols].double()
        rows = min(WS_BM, row_end - m0)
        res = (acc[:rows].float() * s[m0:m0 + rows]) * wsc[g, :, n0:n0 + cols]
        out[m0:m0 + rows, n0:n0 + cols] = res.to(out_dtype)
    return out


def decode_emulated(x, wq, wsc, sizes, bits, out_dtype, own_range_amax=False):
    """K14's decode body at ``fusedquant_schedule``'s splits: per block (an
    m16 tile of a group, 64 columns, a split of K) the rows' scales from
    their amax over all of K, each k-tile of the split quantized with them
    (into its A stage), an exact partial; the partials added in split
    order; K2's epilogue. ``own_range_amax``: the mutation, each split's
    amax over its own range."""
    m, k = x.shape
    n = wq.shape[2]
    e = len(sizes)
    sched = gfq.fusedquant_schedule(m, k, n, e)
    assert sched.bm == 16
    tps, kt = sched.k_tiles_per_split, -(-k // 64)
    out = torch.zeros((m, n), dtype=out_dtype)
    starts = list(itertools.accumulate(sizes, initial=0))
    for g, size in enumerate(sizes):
        lo, hi = starts[g], min(starts[g] + size, m)
        if hi <= lo:
            continue
        for t in range(lo // 16, (hi - 1) // 16 + 1):
            r0, r1 = max(lo, 16 * t), min(hi, 16 * t + 16)
            full = _scales(x[r0:r1], bits)
            for n0 in range(0, n, 64):
                cols = min(64, n - n0)
                acc = torch.zeros((r1 - r0, cols), dtype=torch.float64)
                for z in range(sched.splits):
                    k0, k1 = z * tps * 64, min((z + 1) * tps * 64, kt * 64, k)
                    s = _scales(x[r0:r1], bits, k0=k0, k1=k1) if own_range_amax else full
                    for t0 in range(k0, k1, 64):          # a k-tile's A stage
                        t1 = min(t0 + 64, k1)
                        codes = torch.round(x[r0:r1, t0:t1].float() / s)
                        acc += codes.double() @ wq[g, t0:t1, n0:n0 + cols].double()
                res = (acc.float() * full) * wsc[g, :, n0:n0 + cols]
                out[r0:r1, n0:n0 + cols] = res.to(out_dtype)
    return out


def _fq_operands(m, k, n, sizes, seed, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((m, k)) * 2).astype(np.float32)).to(dtype)
    wq = torch.from_numpy(rng.integers(-127, 128, (len(sizes), k, n)).astype(np.int8))
    wsc = torch.from_numpy(rng.uniform(0.005, 0.02, (len(sizes), 1, n)).astype(np.float32))
    return x, wq, wsc, torch.tensor(sizes, dtype=torch.int32)


def _k1_k2_plain(x, wq, wsc, gs, bits, out_dtype):
    aq, asc = act_quant.quantize_rows_plain(x, torch.full((x.shape[0],), float(bits)))
    return gmm_w8a8.gmm_w8a8_plain(aq, asc, wq, wsc, gs, out_dtype)


@pytest.mark.parametrize("k", [1408, 2048, 4096])
@pytest.mark.parametrize("bits", [8, 4])
def test_large_m_design_bitwise_plain_k1_k2_and_the_jax_reading(k, bits):
    sizes, m, n = (7, 0, 45, 131, 19), 208, 384      # 202 routed rows, 6 past them
    x, wq, wsc, gs = _fq_operands(m, k, n, sizes, seed=k + bits)
    got = {}
    for out_dtype in (torch.float32, torch.bfloat16):
        got[out_dtype] = large_m_emulated(x, wq, wsc, sizes, bits, out_dtype)
        assert torch.equal(got[out_dtype], gfq.gmm_w8a8_fusedquant_plain(
            x, wq, wsc, gs, bits, out_dtype))
        assert torch.equal(got[out_dtype], _k1_k2_plain(x, wq, wsc, gs, bits, out_dtype))
    ref = np.asarray(pallas_gmm.gmm_w8a8_fusedquant(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), jnp.asarray(wq.numpy()),
        jnp.asarray(wsc.numpy()), jnp.asarray(gs.numpy()), a_bits=bits, bm=16, bn=128,
        out_dtype=jnp.float32, interpret=True))
    rows = sum(sizes)
    recip = large_m_emulated(x, wq, wsc, sizes, bits, torch.float32, reciprocal=True)
    np.testing.assert_array_equal(recip.numpy()[:rows], ref[:rows])
    # the port's reading departs from it only on rows whose two scales differ,
    # by one ulp
    s_div, s_rec = _scales(x, bits), _scales(x, bits, reciprocal=True)
    ulps = (s_div.view(torch.int32) - s_rec.view(torch.int32)).abs()[:rows, 0]
    same = (ulps == 0).numpy()
    assert int(ulps.max()) <= 1 and same.any()
    np.testing.assert_array_equal(got[torch.float32].numpy()[:rows][same], ref[:rows][same])


@pytest.mark.parametrize("k", [1408, 2048, 4096])
@pytest.mark.parametrize("m,sizes", [(16, (3, 0, 5, 1, 7)), (37, (20, 0, 0, 17)),
                                     (64, (1, 62, 0, 1))])
def test_decode_design_with_split_k_bitwise_plain_and_k1_k2(k, m, sizes):
    x, wq, wsc, gs = _fq_operands(m, k, 128, sizes, seed=m + k)
    sched = gfq.fusedquant_schedule(m, k, 128, len(sizes))
    assert sched.splits > 1
    got = decode_emulated(x, wq, wsc, sizes, 8, torch.bfloat16)
    assert torch.equal(got, gfq.gmm_w8a8_fusedquant_plain(x, wq, wsc, gs, 8,
                                                          torch.bfloat16))
    assert torch.equal(got, _k1_k2_plain(x, wq, wsc, gs, 8, torch.bfloat16))


def test_decode_split_needs_the_full_row_amax():
    """Mutation check: splits that scale by their own k-range's amax no
    longer give K1 + K2."""
    sizes, m, k = (9, 7), 16, 2048
    x, wq, wsc, gs = _fq_operands(m, k, 64, sizes, seed=3)
    x[:, :1024] *= 4                               # the first split holds the amax
    assert gfq.fusedquant_schedule(m, k, 64, 2).splits > 1
    good = decode_emulated(x, wq, wsc, sizes, 8, torch.float32)
    bad = decode_emulated(x, wq, wsc, sizes, 8, torch.float32, own_range_amax=True)
    plain = gfq.gmm_w8a8_fusedquant_plain(x, wq, wsc, gs, 8, torch.float32)
    assert torch.equal(good, plain) and not torch.equal(bad, plain)


def test_large_m_catches_a_tile_at_a_multiple_of_128():
    """Mutation check: a walk whose m-tiles start at multiples of 128 (as K15's
    aligned layout may) stores another group's rows with this group's
    weights."""
    sizes, m, k, n = (100, 60, 0, 40), 200, 256, 256
    x, wq, wsc, gs = _fq_operands(m, k, n, sizes, seed=8)
    plain = gfq.gmm_w8a8_fusedquant_plain(x, wq, wsc, gs, 8, torch.float32)
    assert torch.equal(large_m_emulated(x, wq, wsc, sizes, 8, torch.float32), plain)
    orig = gmm_ws.ws_device_work_items
    try:
        gmm_ws.ws_device_work_items = lambda s, nn, mm: [
            (g, j, i, (m0 // WS_BM) * WS_BM, end) for g, j, i, m0, end in orig(s, nn, mm)]
        bad = large_m_emulated(x, wq, wsc, sizes, 8, torch.float32)
    finally:
        gmm_ws.ws_device_work_items = orig
    assert not torch.equal(bad, plain)
