"""K15's order of work, written out on the CPU: the persistent CTAs' walk
over work items (``ops/gmm_ws.py::ws_work_items`` and the kernel's
incremental cursor, transcribed below), and the B stage the producer
warpgroup writes (the raw weight tile in four quarter boxes,
``ws_k_tile_quarters``; the 4 x 4 byte units with the lane rotation of
``csrc/gmm_ws.cu::transform_b``; the 128-byte swizzle wgmma reads). The
product taken stage by stage from those stages, with K2's epilogue, is held
bitwise against the port's plain versions (K2 / K5) and the JAX kernels
``gmm_w8a8_ws`` / ``gmm_w4a8_packed_ws`` (interpret mode, as
``tests/test_torch_gmm_ws.py`` runs them) at K 1408, 2048 and 4096.

Tolerance: none. The int32 sum is exact in any order (float64 here, exact
for these magnitudes), and the epilogue rounds the same f32 products once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.ops import pallas_gmm
from mxmoe_tpu.quant.packing import pack_int4_halves as jax_pack
from mxmoe_tpu_torch.bench import workloads
from mxmoe_tpu_torch.ops import gmm_ws
from mxmoe_tpu_torch.ops.gmm_ws import WS_BK, WS_BM, WS_BN, WS_QK
from mxmoe_tpu_torch.quant.packing import pack_int4_halves

HEADLINE = tuple((s + 127) // 128 * 128 for s in workloads.QWEN2_MOE_L10_BS8192_ROUTED_M)
WALK_CASES = {
    "headline": (HEADLINE, 2816),
    "empty groups": ((0, 128, 0, 0, 384, 16, 0), 2048),
    "512 groups": (tuple((i % 5) * 16 for i in range(512)), 512),
    "narrow N": ((48, 0, 200), 80),
    "one group": ((1000,), 5120),
}


def _cursor_walk(sizes, n, cta, grid):
    """The kernel's ``WsWalk::seek`` over items cta, cta + grid, ...: the
    group cursor only moves forward."""
    nt = -(-n // WS_BN)
    g, item0, row0 = 0, 0, 0
    mt = -(-sizes[0] // WS_BM)
    out, w = [], cta
    while True:
        while w >= item0 + mt * nt:
            item0 += mt * nt
            row0 += sizes[g]
            g += 1
            if g >= len(sizes):
                return out
            mt = -(-sizes[g] // WS_BM)
        r = w - item0
        out.append((g, r // mt, r % mt, row0 + (r % mt) * WS_BM, row0 + sizes[g]))
        w += grid


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_work_items_cover_each_tile_once(case):
    sizes, n = WALK_CASES[case]
    items = gmm_ws.ws_work_items(sizes, n)
    nt = -(-n // WS_BN)
    want = {(g, j, i) for g, s in enumerate(sizes) for j in range(nt)
            for i in range(-(-s // WS_BM))}
    assert len(items) == len(set(items)) == len(want) and set(items) == want


@pytest.mark.parametrize("grid", [1, 7, 132])
@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_cta_cursor_is_the_walk_and_stores_inside_groups(case, grid):
    sizes, n = WALK_CASES[case]
    items = gmm_ws.ws_work_items(sizes, n)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    stored = {}
    seen = []
    for cta in range(min(grid, len(items))):
        walk = _cursor_walk(sizes, n, cta, grid)
        assert [w[:3] for w in walk] == items[cta::grid]
        seen += [w[:3] for w in walk]
        for g, j, i, m0, row_end in walk:
            assert m0 == starts[g] + i * WS_BM and row_end == starts[g + 1]
            rows = range(m0, min(m0 + WS_BM, row_end))
            assert len(rows) > 0                 # no item without a stored row
            for r in rows:
                assert starts[g] <= r < starts[g + 1]
                assert (r, j) not in stored      # no row stored twice a column
                stored[(r, j)] = g
    assert sorted(seen) == sorted(items)
    # every row of every group stored once for each n-tile
    assert len(stored) == int(sum(sizes)) * -(-n // WS_BN)


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_m_tiles_of_one_column_are_adjacent(case):
    sizes, n = WALK_CASES[case]
    items = gmm_ws.ws_work_items(sizes, n)
    pos = {}
    for idx, (g, j, i) in enumerate(items):
        pos.setdefault((g, j), []).append((idx, i))
    for run in pos.values():
        idxs, tiles = zip(*run)
        assert list(idxs) == list(range(idxs[0], idxs[0] + len(idxs)))
        assert list(tiles) == list(range(len(tiles)))


def test_quarters_of_the_packed_halves_at_k1408():
    """K/2 = 704 is no multiple of 128: k-tile 5 (codes 640-767) takes two
    quarters of low nibbles (rows 640, 672) and two of high (rows 0, 32)."""
    q = gmm_ws.ws_k_tile_quarters(1408, packed=True)
    assert len(q) == 11
    assert q[0] == [(0, False), (32, False), (64, False), (96, False)]
    assert q[5] == [(640, False), (672, False), (0, True), (32, True)]
    assert q[10] == [(576, True), (608, True), (640, True), (672, True)]
    assert gmm_ws.ws_k_tile_quarters(1408, packed=False)[5] == [
        (640, False), (672, False), (704, False), (736, False)]
    # every code of K once: low nibbles of rows 0..703, high nibbles of 0..703
    got = sorted((r + d, hi) for tile in q for r, hi in tile for d in range(WS_QK))
    assert got == sorted([(r, False) for r in range(704)] + [(r, True) for r in range(704)])


# ---------------------------------------------------------------------------
# the B transform, unit by unit
# ---------------------------------------------------------------------------

def _swizzled(n, k):
    """Byte offset of (row n, code k) in a K-major tile of 128-byte rows with
    the 128-byte swizzle (16-byte chunk c of row n at chunk c ^ (n % 8))."""
    return n * WS_BK + (((k >> 4) ^ (n & 7)) << 4) + (k & 15)


def _transform_units():
    """transform_b's blocks: for producer warp pw, lane, code row j and
    column c of the thread's 16 x 16 block -> (raw byte offset, B stage byte
    offset)."""
    pw, lane, j, c = np.meshgrid(np.arange(4), np.arange(32), np.arange(16),
                                 np.arange(16), indexing="ij")
    kb = lane & 7
    ns = ((lane >> 3) + 4 * pw + kb) & 15
    k, n = 16 * kb + j, 16 * ns + c
    return k * WS_BN + n, _swizzled(n, k)


SRC, DST = _transform_units()
_RR, _KK = np.meshgrid(np.arange(WS_BM), np.arange(WS_BK), indexing="ij")
A_SWZ = torch.from_numpy(_swizzled(_RR, _KK).ravel())


def test_transform_writes_each_stage_byte_once():
    assert sorted(DST.ravel().tolist()) == list(range(WS_BN * WS_BK))
    assert sorted(SRC.ravel().tolist()) == list(range(WS_BK * WS_BN))


def _conflict_free_128(addr):
    """A warp's 16-byte accesses (one address a lane, [32]) run as four
    quarter-warps; each is free of bank conflicts when its 8 lanes touch 8
    different 16-byte bank groups."""
    groups = (addr // 16) % 8
    return all(len(set(groups[8 * p:8 * p + 8].tolist())) == 8 for p in range(4))


def test_transform_reads_and_writes_are_bank_conflict_free():
    """Each 16-byte load (fixed pw, code row j) and store (fixed pw, column
    c) of a warp: every quarter-warp hits 8 different bank groups, and each
    lane's 16 bytes are contiguous."""
    for pw in range(4):
        for x in range(16):
            load = SRC[pw, :, x, :]                     # [lane, 16 columns]
            store = DST[pw, :, :, x]                    # [lane, 16 code rows]
            for acc in (load, store):
                assert (np.diff(acc, axis=1) == 1).all() and (acc[:, 0] % 16 == 0).all()
                assert _conflict_free_128(acc[:, 0])


def _b_stage(raw, high):
    """The stage transform_b writes: raw [128 byte rows, 256] int8, high[q]
    the nibble of quarter q (None: int8 codes) -> [256 * 128] int8."""
    raw_u = raw.to(torch.int16) & 0xFF
    codes = raw_u.clone()
    for q, hi in enumerate(high):
        if hi is None:
            continue
        rows = slice(q * WS_QK, (q + 1) * WS_QK)
        nib = (raw_u[rows] >> 4) & 0xF if hi else raw_u[rows] & 0xF
        codes[rows] = ((nib ^ 8) - 8) & 0xFF               # sext4, as a byte
    stage = torch.empty(WS_BN * WS_BK, dtype=torch.int16)
    stage[torch.from_numpy(DST.ravel())] = codes.reshape(-1)[torch.from_numpy(SRC.ravel())]
    return ((stage + 128) % 256 - 128).to(torch.int8)


def _operand(stage, rows):
    """wgmma's reading of a K-major swizzled tile: [rows, 128] codes."""
    n, k = np.meshgrid(np.arange(rows), np.arange(WS_BK), indexing="ij")
    return stage[torch.from_numpy(_swizzled(n, k))]


def _box(t, r0, r1, c0, c1):
    """t[r0:r1, c0:c1] with zeros outside t (a TMA box past the data)."""
    out = torch.zeros((r1 - r0, c1 - c0), dtype=t.dtype)
    rs, re = max(r0, 0), min(r1, t.shape[0])
    cs, ce = max(c0, 0), min(c1, t.shape[1])
    if rs < re and cs < ce:
        out[rs - r0:re - r0, cs - c0:ce - c0] = t[rs:re, cs:ce]
    return out


def ws_emulated(aq, asc, rhs, wsc, sizes, packed, out_dtype):
    """K15 stage by stage: each CTA's items, each k-tile's A box (swizzled as
    TMA lands it) and B stage (four raw quarter boxes through transform_b),
    the wgmma products summed exactly, K2's epilogue on the stored rows."""
    m, k = aq.shape
    n = rhs.shape[2]
    out = torch.zeros((m, n), dtype=out_dtype)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    quarters = gmm_ws.ws_k_tile_quarters(k, packed)
    for g, j, i in gmm_ws.ws_work_items(sizes, n):
        m0, n0, row_end = int(starts[g]) + i * WS_BM, j * WS_BN, int(starts[g + 1])
        acc = torch.zeros((WS_BM, WS_BN), dtype=torch.float64)
        for t, quads in enumerate(quarters):
            a = _box(aq, m0, m0 + WS_BM, t * WS_BK, (t + 1) * WS_BK)
            a_stage = torch.empty(WS_BM * WS_BK, dtype=torch.int8)
            a_stage[A_SWZ] = a.reshape(-1)                 # as TMA lands it
            raw = torch.cat([_box(rhs[g], row, row + WS_QK, n0, n0 + WS_BN)
                             for row, _ in quads])
            b = _b_stage(raw, [hi if packed else None for _, hi in quads])
            acc += (_operand(a_stage, WS_BM).double()
                    @ _operand(b, WS_BN).double().T)
        rows = min(WS_BM, row_end - m0)
        cols = min(WS_BN, n - n0)
        res = (acc[:rows, :cols].float() * asc[m0:m0 + rows]) * wsc[g, :, n0:n0 + cols]
        out[m0:m0 + rows, n0:n0 + cols] = res.to(out_dtype)
    return out


@pytest.mark.parametrize("k", [1408, 2048, 4096])
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "packed"])
@pytest.mark.parametrize("out", ["bf16", "f32"])
def test_emulated_stages_bitwise_plain_and_jax(k, packed, out):
    sizes, n, bm = (16, 0, 48, 32), 512, 16
    rng = np.random.default_rng(k + packed)
    m, e = sum(sizes), len(sizes)
    hi_w = 7 if packed else 127
    aq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    asc = rng.uniform(0.01, 0.02, (m, 1)).astype(np.float32)
    wq = rng.integers(-hi_w - packed, hi_w + 1, (e, k, n)).astype(np.int8)
    wsc = rng.uniform(0.01, 0.02, (e, 1, n)).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[out]
    a, s, w = (torch.from_numpy(v) for v in (aq, asc, wsc))
    if packed:
        rhs = pack_int4_halves(torch.from_numpy(wq))
        ref = pallas_gmm.gmm_w4a8_packed_ws(
            jnp.asarray(aq), jnp.asarray(asc), jax_pack(jnp.asarray(wq)), jnp.asarray(wsc),
            sizes, bm=bm, bn=n, out_dtype=jdt, interpret=True)
        plain = gmm_ws.gmm_w4a8_packed_ws(a, s, rhs, w, sizes, bm=bm, out_dtype=tdt)
    else:
        rhs = torch.from_numpy(wq)
        ref = pallas_gmm.gmm_w8a8_ws(jnp.asarray(aq), jnp.asarray(asc), jnp.asarray(wq),
                                     jnp.asarray(wsc), sizes, bm=bm, bn=n,
                                     out_dtype=jdt, interpret=True)
        plain = gmm_ws.gmm_w8a8_ws(a, s, rhs, w, sizes, bm=bm, out_dtype=tdt)
    got = ws_emulated(a, s, rhs, w, sizes, packed, tdt)
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_emulation_catches_a_wrong_nibble():
    """Mutation check: the packed straddle tile read with its high quarters'
    nibble flipped no longer matches the plain version."""
    sizes, k, n = (16,), 1408, 256
    rng = np.random.default_rng(3)
    aq = torch.from_numpy(rng.integers(-127, 128, (16, k)).astype(np.int8))
    asc = torch.full((16, 1), 0.01)
    w4 = torch.from_numpy(rng.integers(-8, 8, (1, k, n)).astype(np.int8))
    wsc = torch.full((1, 1, n), 0.01)
    rhs = pack_int4_halves(w4)
    plain = gmm_ws.gmm_w4a8_packed_ws(aq, asc, rhs, wsc, sizes, bm=16,
                                      out_dtype=torch.float32)
    good = ws_emulated(aq, asc, rhs, wsc, sizes, True, torch.float32)
    assert torch.equal(good, plain)
    orig = gmm_ws.ws_k_tile_quarters
    try:
        gmm_ws.ws_k_tile_quarters = lambda kk, p: [
            [(r, (not hi) if t == 5 and q >= 2 else hi) for q, (r, hi) in enumerate(tile)]
            for t, tile in enumerate(orig(kk, p))]
        bad = ws_emulated(aq, asc, rhs, wsc, sizes, True, torch.float32)
    finally:
        gmm_ws.ws_k_tile_quarters = orig
    assert not torch.equal(bad, plain)


def test_redesigned_modules_import_no_jax():
    """The wrappers of the wgmma body (K15, K2 / K5, K14) and K1, and the
    benches that time them, import neither jax nor the JAX package."""
    import subprocess
    import sys

    mods = ["mxmoe_tpu_torch.ops.gmm_ws", "mxmoe_tpu_torch.ops.act_quant",
            "mxmoe_tpu_torch.ops.gmm_w8a8", "mxmoe_tpu_torch.ops.gmm_w4a8_packed",
            "mxmoe_tpu_torch.ops.gmm_w8a8_fusedquant",
            "mxmoe_tpu_torch.bench.redesign_ab", "mxmoe_tpu_torch.bench.variant_ab",
            "mxmoe_tpu_torch.bench.headline_profile"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'mxmoe_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
