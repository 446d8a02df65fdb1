"""K11's bf16 body (the persistent wgmma body of ``csrc/gmm_bf16.cu``),
written out on the CPU:

* the schedule: ``ops.gmm.bf16_gmm_schedule`` names the wgmma body for bf16
  operands and the FMA loop for f32 ones. The wrapper, on meta tensors with
  the library recorded, calls the entry point once with the operands' type,
  at the decode rows and above, and refuses K or N off a multiple of 8 and
  misaligned operands without calling the library;
* the walk at K11's tile (128 x 256 work items, the walk of
  ``gmm_ws_body.cuh``, ``gmm_ws.ws_device_work_items``) and the tile
  arithmetic written out below (``_k_tiles``: 64-deep k-tiles, boxes past
  K read as zeros; ``_n_boxes``: four 64-column weight boxes an n-tile,
  columns past N read as zeros and not stored) emulated item by item:
  every stored row lies in its own group and is stored once an n-tile,
  rows past the groups (or M) never, and the result is within
  ``gmm.error_over_bound`` of the float64 product; a walk whose tiles start
  at multiples of 128 must fail (mutation check);
* the output tile in shared memory: each (row, chunk) its own slot, no bank
  conflict in the consumers' writes or the storers' reads;
* ``bench.kernels.scheme_tile`` names the w16a16 tile the profiler's table
  keys on.

Tolerance: ``gmm.error_over_bound`` (f32 accumulation of K terms in any
order, + 1 bf16 ulp for a bf16 output), the kernel's own gate.
"""

import itertools

import numpy as np
import pytest
import torch

from mxmoe_tpu_torch.bench import kernels as registry
from mxmoe_tpu_torch.bench import workloads
from mxmoe_tpu_torch.ops import gmm, gmm_ws, kernels
from mxmoe_tpu_torch.trace import profiler


BK, BOX_N = 64, 64     # the kernel's k-tile and weight box (csrc/gmm_bf16.cu)


def _k_tiles(k):
    """The wgmma body's k-tiles: (first k, rows of it inside K); the A and B
    boxes read zeros past K, so a tail tile needs no tail code."""
    return [(k0, min(BK, k - k0)) for k0 in range(0, k, BK)]


def _n_boxes(n):
    """For each 256-column n-tile, its four weight boxes: (first column,
    columns of it inside N)."""
    return [[(c, max(min(BOX_N, n - c), 0)) for c in range(t, t + gmm.WGMMA_BN, BOX_N)]
            for t in range(0, n, gmm.WGMMA_BN)]


@pytest.mark.parametrize("dtype,body,tile", [
    (torch.bfloat16, "wgmma", (128, 256)),
    (torch.float32, "f32", (32, 128))])
def test_body_by_dtype(dtype, body, tile):
    s = gmm.bf16_gmm_schedule(dtype)
    assert (s.body, s.bm, s.bn) == (body, *tile)


class _Recorder:
    """Stands in for the kernel library: records each entry point's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def _require_but_the_device(cond, msg):
    """``kernels.require`` with every check but the one that meta tensors
    cannot pass (that they lie on a CUDA device)."""
    if not cond and "one CUDA device" not in msg:
        raise ValueError(msg)


def _on_meta(monkeypatch):
    monkeypatch.setattr(kernels, "require", _require_but_the_device)
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(kernels, "launches", dict(kernels.launches))


@pytest.mark.parametrize("m,dtype", [
    (1, torch.bfloat16), (16, torch.bfloat16), (64, torch.bfloat16),
    (65, torch.bfloat16), (4096, torch.bfloat16), (16, torch.float32),
    (4096, torch.float32)])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_wrapper_launches_the_body_of_its_dtype(monkeypatch, m, dtype, out):
    """On meta tensors (no data, not the CPU, so the wrapper takes its kernel
    path) with the library recorded: one call to the entry point, with the
    operands' and the output's types and the shapes; one launch counted."""
    rec = _Recorder()
    monkeypatch.setattr(kernels, "lib", lambda: rec)
    _on_meta(monkeypatch)
    k, n, e = 1408, 2048, 60
    meta = torch.device("meta")
    x = torch.empty((m, k), dtype=dtype, device=meta)
    w = torch.empty((e, k, n), dtype=dtype, device=meta)
    gs = torch.empty((e,), dtype=torch.int32, device=meta)
    got = gmm.gmm_bf16(x, w, gs, out_dtype=out)
    assert got.shape == (m, n) and got.dtype == out
    (name, args), = rec.calls
    assert name == "mxmoe_gmm_bf16"
    assert args[4:10] == (int(dtype == torch.bfloat16), int(out == torch.bfloat16),
                          m, k, n, e)
    assert kernels.launches["gmm_bf16"] == 1


@pytest.mark.parametrize("k,n,offset,what", [
    (1412, 2816, 0, "K=1412 % 8"),
    (2048, 2812, 0, "N=2812 % 8"),
    (2048, 2816, 1, "misaligned operand")])
@pytest.mark.parametrize("m", [16, 1024])
def test_wrapper_refuses_what_no_body_takes(monkeypatch, m, k, n, offset, what):
    """K or N off a multiple of 8 (TMA's 16-byte strides) and rows not on 16
    bytes: the wrapper raises at the decode rows and above, before it asks
    the schedule, and calls no entry point."""
    rec = _Recorder()
    monkeypatch.setattr(kernels, "lib", lambda: rec)
    _on_meta(monkeypatch)
    meta, e = torch.device("meta"), 4
    x = torch.empty((m * k + offset,), dtype=torch.bfloat16, device=meta)
    x = x[offset:].view(m, k)
    w = torch.empty((e, k, n), dtype=torch.bfloat16, device=meta)
    gs = torch.empty((e,), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match=what):
        gmm.gmm_bf16(x, w, gs)
    assert rec.calls == [] and kernels.launches["gmm_bf16"] == 0


def test_k_tiles_and_boxes_cover_the_tails():
    # K 1416: 22 full k-tiles and one of 8 rows; the boxes read zeros past K
    tiles = _k_tiles(1416)
    assert len(tiles) == 23 and tiles[-1] == (1408, 8)
    assert [k0 for k0, _ in tiles] == list(range(0, 1416, 64))
    assert sum(rows for _, rows in tiles) == 1416
    assert _k_tiles(2048)[-1] == (1984, 64)
    # N 1400: six n-tiles of four 64-column boxes; the last holds 120 columns
    boxes = _n_boxes(1400)
    assert len(boxes) == 6 and all(len(b) == 4 for b in boxes)
    assert boxes[-1] == [(1280, 64), (1344, 56), (1408, 0), (1472, 0)]
    cols = [c for b in boxes for c0, w in b for c in range(c0, c0 + w)]
    assert cols == list(range(1400))
    assert [b[0][0] for b in _n_boxes(2816)] == list(range(0, 2816, 256))
    # the body's tile is the walk's
    assert (gmm.WGMMA_BM, gmm.WGMMA_BN) == (gmm_ws.WS_BM, gmm_ws.WS_BN)
    assert gmm.WGMMA_BN == 4 * BOX_N and BK * 2 == 128      # one 128-byte row


def _emulate(x, w, sizes, m, aligned_tiles=False):
    """The wgmma body item by item: each (group, n-tile, m-tile) multiplies
    128 rows from its first row (rows past M read as zeros) with the group's
    weights, k-tile by k-tile in f32, and stores the rows of its group below
    M and the columns below N. -> (output, NaN where nothing was stored;
    stores per (row, n-tile))."""
    k, n = x.shape[1], w.shape[2]
    out = torch.full((m, n), float("nan"))
    stores = {}
    xp = torch.cat([x.float(), torch.zeros((gmm.WGMMA_BM, k))])
    items = gmm_ws.ws_device_work_items(sizes, n, m)
    if aligned_tiles:        # the mutation: tiles at multiples of 128
        items = [(g, j, i, m0 // 128 * 128, end) for g, j, i, m0, end in items]
    for g, j, _, m0, row_end in items:
        acc = torch.zeros((gmm.WGMMA_BM, gmm.WGMMA_BN))
        rows = xp[m0:m0 + gmm.WGMMA_BM]
        for k0, kr in _k_tiles(k):
            for b, (c0, cw) in enumerate(_n_boxes(n)[j]):
                wt = torch.zeros((BK, BOX_N))
                wt[:kr, :cw] = w[g, k0:k0 + kr, c0:c0 + cw].float()
                at = torch.zeros((gmm.WGMMA_BM, BK))
                at[:, :kr] = rows[:, k0:k0 + kr]
                acc[:, b * 64:(b + 1) * 64] += at @ wt
        n0 = j * gmm.WGMMA_BN
        nc = min(gmm.WGMMA_BN, n - n0)
        for r in range(m0, min(m0 + gmm.WGMMA_BM, row_end)):
            out[r, n0:n0 + nc] = acc[r - m0, :nc]
            stores[(r, j)] = stores.get((r, j), 0) + 1
    return out, stores


# name -> (group sizes, M, K, N)
WALK_CASES = {
    "groups at any row": ((37, 0, 100, 1, 0, 91, 30, 0), 259, 72, 264),
    "empty groups": ((0, 0, 130, 0, 1, 0, 0), 131, 64, 256),
    "one group holds every row": ((300,), 300, 136, 200),
    "sizes below M": ((100, 0, 70), 200, 72, 264),
    "groups past M": ((100, 300, 50), 330, 64, 136),
    "M not a multiple of 128": ((129, 127, 2), 258, 16, 8),
}


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_emulated_body_stores_each_row_once_within_the_bound(case):
    sizes, m, k, n = WALK_CASES[case]
    rng = np.random.default_rng(sum(sizes) + k + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((len(sizes), k, n)).astype(np.float32)
                         * 0.05).bfloat16()
    out, stores = _emulate(x, w, sizes, m)
    live = min(sum(sizes), m)
    nt = len(_n_boxes(n))
    assert sorted(stores) == [(r, j) for r in range(live) for j in range(nt)]
    assert set(stores.values()) == {1}
    assert not bool(torch.isnan(out[:live]).any())
    assert bool(torch.isnan(out[live:]).all())
    starts = list(itertools.accumulate(sizes, initial=0))
    cut = torch.tensor([max(min(s, live - s0), 0) for s0, s in zip(starts, sizes)],
                       dtype=torch.int32)
    _, ratio = gmm.error_over_bound(out[:live].bfloat16(), x[:live], w, cut)
    assert ratio <= 1.0
    _, ratio = gmm.error_over_bound(out[:live], x[:live], w, cut)
    assert ratio <= 1.0


def test_tiles_at_multiples_of_128_fail():
    """A group starting inside a 128-row window loses its first rows to the
    previous tile's window (and that tile writes the next group's rows with
    its own weights)."""
    sizes, m, k, n = WALK_CASES["groups at any row"]
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((len(sizes), k, n)).astype(np.float32)
                         ).bfloat16()
    out, stores = _emulate(x, w, sizes, m, aligned_tiles=True)
    gs = torch.tensor(sizes, dtype=torch.int32)
    bad = bool(torch.isnan(out[:m]).any()) or set(stores.values()) != {1}
    if not bad:
        _, ratio = gmm.error_over_bound(out, x, w, gs)
        bad = ratio > 1.0
    assert bad


def _tile_at(r, chunk):
    """The output tile's 16-byte slot of chunk ``chunk`` of row ``r``
    (``BwTile::at`` in csrc/gmm_bf16.cu: 128 rows of 512 bytes, chunk c of
    row r at c ^ (r % 8))."""
    return r * 32 + (chunk ^ (r & 7))


def test_output_tile_slots_and_banks():
    """Every (row, chunk) of the tile has its own slot; the consumers' bf16
    writes (a warp: 8 rows x 4 lanes, 4 bytes each, for one 8-column group)
    and the storers' reads (a quarter-warp: 8 chunks of one row, 16 bytes
    each) meet no bank conflict (32 banks of 4 bytes). A row holds 256 bf16
    columns, the whole tile, or 128 f32 columns: an f32 tile goes out in
    two passes."""
    slots = {_tile_at(r, c) for r in range(128) for c in range(32)}
    assert slots == set(range(128 * 32))
    assert [256 // (512 // elem) for elem in (2, 4)] == [1, 2]
    for warp in range(4):
        for h in range(2):
            for jj in range(32):
                banks = set()
                for lane in range(32):
                    r = warp * 16 + (lane >> 2) + 8 * h
                    byte = 16 * jj + 4 * (lane & 3)
                    banks.add((_tile_at(r, byte >> 4) * 16 + (byte & 15)) // 4 % 32)
                assert len(banks) == 32
    for r in range(128):
        for c0 in range(0, 32, 8):
            slots = [_tile_at(r, c) for c in range(c0, c0 + 8)]
            assert len({s % 8 for s in slots}) == 8      # 8 x 16 bytes, all banks once


@pytest.mark.parametrize("tokens", profiler.SCALES)
def test_scheme_tile_names_k11s_body_at_the_profilers_shapes(tokens):
    k, n, e = 2048, 2816, 60
    m = workloads.synthetic_workload(e, tokens, 4, k, n).m_total
    assert repr(registry.scheme_tile("w16a16_g-1_sym", m, k, n, e)) == \
        "gmm_bf16.wgmma-bm128-bn256"
    assert repr(registry.scheme_tile("w16a16_g-1_sym", 16, k, n, e)) == \
        "gmm_bf16.wgmma-bm128-bn256"
