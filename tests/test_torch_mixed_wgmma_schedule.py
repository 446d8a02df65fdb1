"""K4 / K4f (``gmm_mixed_packed``) and K9 (``gmm_w8a8_asym``) above the decode
rows on the Hopper wgmma bodies: K4 on K2's body (``csrc/gmm_ws_body.cuh``)
over its ragged storage, K4f on K8's body B (``csrc/gmm_wq_body.cuh``) over
the same storage, K9 on body B with one group and zero points. No kernel
runs on the CPU, so this file holds what surrounds them and their reading
of the storage written out:

- the schedules (``int8_gmm_schedule`` with ``ragged``,
  ``grouped_gmm_schedule`` with ``mixed``, ``asym_gmm_schedule``) keep the
  m16 decode bodies up to DECODE_M and take the wgmma bodies from DECODE_M
  + 1 inside their domains (packed K % 64 for K4, % 128 for K4f, N % 16,
  16-byte alignment), the old tiles outside them; the wrappers hand the
  kernels that schedule and the rows of the ragged buffer;
- the producers' boxes, written out as the kernels load them (K4: four
  quarter boxes of 32 byte rows a 128-code k-tile, K4f: two half boxes of
  64), cover every code of every expert once, from the expert's own block,
  with the nibble the transform takes, for every expert flag at K 1408 and
  2048 (and at K 1344, where K4's last k-tile reaches past K): a box that
  touches a neighbour's bytes meets only activation columns past K, which
  the activations' TMA map fills with zeros. High nibbles read below K/2,
  or a box started one unit off ``blk_offsets``, are seen;
- K4f's order of work over the storage (128-code k-tiles, a group's k-tiles
  summed in int32 before its fold, folds ascending, the zp row sums) is
  bitwise ``grouped_rows_plain`` on the int8 codes, and K9's reading of body
  B (one group, zp: the first term added to zero) bitwise
  ``gmm_w8a8_asym_plain``; both within the tolerance of
  ``test_torch_gmm_mixed_packed_flex.py`` / ``test_torch_gmm_grouped.py`` of
  the JAX ``gmm_mixed_packed`` and ``gmm_w8a8_asym`` in interpret mode (f32
  outputs within 2^-21 x max|ref|: XLA contracts the JAX epilogue into
  FMAs).
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.ops import pallas_gmm
from mxmoe_tpu_torch.ops import gmm_mixed_packed as gmp, gmm_w8a8_asym as gas, kernels
from mxmoe_tpu_torch.ops.gmm_w8a8 import DECODE_M, WGMMA_BK, int8_gmm_schedule
from mxmoe_tpu_torch.ops.gmm_w8a8_grouped import (GROUPED_WGMMA_BK, grouped_gmm_schedule,
                                                  grouped_rows_plain)
from mxmoe_tpu_torch.quant.packing import build_ragged_mixed

T = torch.from_numpy
QUARTER, HALF = 32, 64      # byte rows of K4's quarter boxes, K4f's half boxes


def _cdiv(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------

ROWS = [1, 16, DECODE_M, DECODE_M + 1, 68, 512, 1024, 8192, 32762, 65536]


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,n", [(2048, 2816), (1408, 2048)], ids=["gate_up", "down"])
def test_schedules_by_rows(m, k, n):
    """Up to DECODE_M each kernel keeps its decode schedule; from DECODE_M + 1
    K4 takes K2's wgmma walk (128 x 256 items, 128-code k-tiles), K4f and K9
    body B's (128 x 128 items; K9 with one group)."""
    e = 60
    k4 = int8_gmm_schedule(m, k, n, e, wgmma=True, ragged=True)
    k4f = grouped_gmm_schedule(m, k, n, e, 128, wgmma=True, mixed=True)
    k9 = gas.asym_gmm_schedule(m, k, n, e)
    if m <= DECODE_M:
        assert k4.bm == k4f.bm == k9.bm == 16
        assert k4 == k9 == int8_gmm_schedule(m, k, n, e)
        assert k4f == grouped_gmm_schedule(m, k, n, e, 128)
        return
    assert (k4.bm, k4.bn, k4.grid_m, k4.splits, k4.k_tiles_per_split) == (
        128, 256, _cdiv(m, 128) + e, 1, _cdiv(k, WGMMA_BK))
    assert (k4f.bm, k4f.bn, k4f.grid_m, k4f.splits, k4f.k_tiles_per_split) == (
        128, 128, _cdiv(m, 128) + e, 1, k // GROUPED_WGMMA_BK)
    assert k9 == grouped_gmm_schedule(m, k, n, e, k, wgmma=True)
    assert (k9.bm, k9.bn) == (128, 128)


@pytest.mark.parametrize("k,n,gsize,aligned,k4,k4f,k9", [
    (2048, 2816, 0, True, 128, 128, 128),
    (1408, 2048, 0, True, 128, 128, 128),
    (1344, 2048, 0, True, 128, 32, 128),     # K % 128 != 0: K4f's halves straddle K/2
    (1056, 2048, 0, True, 64, 32, 128),      # K % 64 != 0: K4's quarters straddle K/2
    (2048, 2816, 64, True, 128, 32, 128),    # K4f's groups smaller than a k-tile
    (2048, 2040, 0, True, 64, 32, 64),       # N % 16 != 0 (TMA)
    (2048, 2816, 0, False, 64, 32, 64),      # weights not 16-byte aligned
], ids=["gate_up", "down", "k_mod_128", "k_mod_64", "g64", "n_mod_16", "unaligned"])
def test_domain_edges(k, n, gsize, aligned, k4, k4f, k9):
    """Outside a body's domain the old tile stays: K4 and K9 the 64 x 128
    tile, K4f the 32 x 128 body (``gsize`` 0: one group)."""
    m, e = 1024, 8
    g = gsize or k
    assert int8_gmm_schedule(m, k, n, e, aligned=aligned, wgmma=True, ragged=True).bm == k4
    assert grouped_gmm_schedule(m, k, n, e, g, aligned=aligned, wgmma=True,
                                mixed=True).bm == k4f
    assert gas.asym_gmm_schedule(m, k, n, e, aligned=aligned).bm == k9


class _Recorder:
    """Stands in for the kernel library: records each entry point's arguments."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def call(*args):
            self.calls[name] = args
            return 0
        return call


@pytest.mark.parametrize("m,k,n,e", [(16, 2048, 2816, 60), (65, 1408, 2048, 60),
                                     (1024, 2048, 2816, 60), (4, 1408, 2048, 1)])
def test_wrappers_launch_the_schedule(monkeypatch, m, k, n, e):
    """K4, K4f and K9 on tensors of the meta device (no data, not the CPU, so
    each takes its kernel path) with the library recorded: each hands its
    kernel its schedule's bm, grid_m, splits and k-tiles a split, K4 and K4f
    also the rows of the ragged buffer, and counts one launch."""
    rec = _Recorder()
    monkeypatch.setattr(kernels, "lib", lambda: rec)
    monkeypatch.setattr(kernels, "require", lambda cond, msg: None)
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(kernels, "tickets", lambda device, count: torch.empty(0))
    monkeypatch.setattr(kernels, "launches", dict(kernels.launches))
    meta = torch.device("meta")
    rows = 3 * e * k // 2                    # a third of the experts packed, say
    aq = torch.empty((m, k), dtype=torch.int8, device=meta)
    cat = torch.empty((rows, n), dtype=torch.int8, device=meta)
    wq = torch.empty((e, k, n), dtype=torch.int8, device=meta)
    ints = torch.empty((e,), dtype=torch.int32, device=meta)
    a1, b1 = torch.empty((m, 1), device=meta), torch.empty((e, 1, n), device=meta)
    g = k // 128
    ag, bg = torch.empty((m, g), device=meta), torch.empty((e, g, n), device=meta)
    gmp.gmm_mixed_packed(aq, a1, cat, b1, ints, ints, ints)
    gmp.gmm_mixed_packed(aq, ag, cat, bg, ints, ints, ints, rhs_zp=bg)
    gas.gmm_w8a8_asym(aq, a1, wq, b1, b1, ints)

    def sched(s):
        return (s.bm, s.grid_m, s.splits, s.k_tiles_per_split)
    for name, at, s in (
            ("mxmoe_gmm_mixed_packed", 13,
             int8_gmm_schedule(m, k, n, e, wgmma=True, ragged=True)),
            ("mxmoe_gmm_mixed_packed_flex", 14,
             grouped_gmm_schedule(m, k, n, e, 128, wgmma=True, mixed=True)),
            ("mxmoe_gmm_w8a8_asym", 12, gas.asym_gmm_schedule(m, k, n, e))):
        args = rec.calls[name]
        assert tuple(args[at - 4:at]) == (m, k, n, e), name
        if name != "mxmoe_gmm_w8a8_asym":
            assert args[at] == rows, name
            at += 1
        if name == "mxmoe_gmm_mixed_packed_flex":
            assert args[at] == 128
            at += 1
        assert tuple(args[at:at + 4]) == sched(s), name
        assert (args[at + 4] is None) == (s.splits == 1), name
    assert kernels.launches["gmm_mixed_packed"] == kernels.launches[
        "gmm_mixed_packed_flex"] == kernels.launches["gmm_w8a8_asym"] == 1


# ---------------------------------------------------------------------------
# the producers' boxes over the ragged storage
# ---------------------------------------------------------------------------

def _boxes(k, packed, base, depth, bk, mutation=None):
    """The weight boxes of one expert's k-tiles as the producer loads them:
    (k-tile, first code, first byte row, high nibbles) for each box of
    ``depth`` byte rows, ``bk`` codes a k-tile (K4: 128 / 32, the quarter
    boxes of gmm_ws_body.cuh's load lambda; K4f: 128 / 64, the half boxes of
    gmm_wq_kernel's producer). Box j of k-tile t holds codes c = bk t +
    depth j; an int8 expert's byte rows c, a packed one's c (low nibbles)
    below K/2 and c - K/2 (high) above, from the expert's first byte row
    ``base`` = blk_offsets[e] * K/2. ``mutation``: "hi_below_half" reads
    high nibbles below K/2 too, "blk_off_by_one" starts one K/2 unit late."""
    half = k // 2
    if mutation == "blk_off_by_one":
        base += half
    for t in range(_cdiv(k, bk)):
        for j in range(bk // depth):
            c = bk * t + depth * j
            row = c - half if packed and c >= half else c
            hi = packed and (c >= half or mutation == "hi_below_half")
            yield t, c, base + row, hi


def _nibbles(rows, hi):
    """Byte rows -> the sign-extended nibbles the transform takes (int64)."""
    b = rows.astype(np.int64) & 0xFF
    v = (b >> 4) & 0xF if hi else b & 0xF
    return (v ^ 8) - 8


def _storage(seed, k, n, pflags):
    rng = np.random.default_rng(seed)
    e = len(pflags)
    codes = rng.integers(-127, 128, (e, k, n), dtype=np.int8)
    for i, f in enumerate(pflags):
        if f:
            codes[i] = rng.integers(-8, 8, (k, n), dtype=np.int8)
    cat, blk = build_ragged_mixed(T(codes), pflags)
    return codes, cat.numpy(), blk


def _read_expert(cat, k, packed, blk, depth, bk, mutation=None):
    """One expert's codes as the boxes deliver them, over the padded k-tiles:
    [cdiv(K, bk) * bk, N] (rows past R read zeros, as TMA fills them), and
    for each padded code the byte row it came from."""
    r_total, n = cat.shape
    kpad = _cdiv(k, bk) * bk
    w = np.zeros((kpad, n), np.int64)
    src = np.full((kpad,), -1, np.int64)
    for _t, c, row, hi in _boxes(k, packed, blk * (k // 2), depth, bk, mutation):
        take = np.zeros((depth, n), np.int8)
        lo, hi_row = min(row, r_total), min(row + depth, r_total)
        take[: hi_row - lo] = cat[lo:hi_row]
        w[c:c + depth] = _nibbles(take, hi) if packed else take.astype(np.int64)
        src[c:c + depth] = np.arange(row, row + depth)
    return w, src


BOX_SHAPES = {"k4": (QUARTER, WGMMA_BK), "k4f": (HALF, GROUPED_WGMMA_BK)}
FLAGS = [1, 0, 1, 1, 0, 0, 1]       # every neighbour pair of flags, packed last
# (body, K): each body at the down and gate_up widths, K4 also at K 1344
# (K % 128 != 0, inside K4's domain only)
BOX_CASES = [("k4", 1344), ("k4", 1408), ("k4", 2048), ("k4f", 1408), ("k4f", 2048)]


@pytest.mark.parametrize("body,k", BOX_CASES)
def test_boxes_cover_every_code_once_from_its_own_block(body, k):
    """For every expert flag (and every flag of its neighbour): each code
    below K comes from one box, from the expert's own block, with its own
    nibble; a box that reaches a neighbour's bytes (or past R) does so only
    for codes past K, which meet the zero activation columns TMA gives past
    K. K4f's domain (K % 128) has no such box; K4's K 1344 does."""
    depth, bk = BOX_SHAPES[body]
    n = 16
    codes, cat, blk = _storage(k, k, n, FLAGS)
    half = k // 2
    neighbour_codes = 0
    for e, packed in enumerate(FLAGS):
        base = blk[e] * half
        end = base + (half if packed else k)
        seen = np.zeros((k,), np.int64)
        for _t, c, row, hi in _boxes(k, packed, base, depth, bk):
            for i in range(depth):
                code, byte_row = c + i, row + i
                if code >= k:
                    neighbour_codes += not base <= byte_row < end
                    continue
                seen[code] += 1
                assert base <= byte_row < end, (e, code, byte_row)
                want_row = (code - half if code >= half else code) if packed else code
                assert byte_row - base == want_row and hi == (packed and code >= half)
        assert (seen == 1).all(), e
        w, _ = _read_expert(cat, k, packed, blk[e], depth, bk)
        np.testing.assert_array_equal(w[:k], codes[e].astype(np.int64))
    assert (neighbour_codes > 0) == (k % bk != 0)


@pytest.mark.parametrize("body,k", BOX_CASES)
def test_boxes_product_is_the_plain_product(body, k):
    """The int32 sums over the padded k-tiles of the zero-padded activations
    against the codes as the boxes deliver them equal the exact product of
    each expert's codes; the two mutations change it."""
    depth, bk = BOX_SHAPES[body]
    n = 16
    codes, cat, blk = _storage(k + 1, k, n, FLAGS)
    rng = np.random.default_rng(k)
    a = rng.integers(-127, 128, (3, k)).astype(np.int64)
    kpad = _cdiv(k, bk) * bk
    a_pad = np.pad(a, ((0, 0), (0, kpad - k)))        # the A map's zeros past K
    for e, packed in enumerate(FLAGS):
        want = a @ codes[e].astype(np.int64)
        w, _ = _read_expert(cat, k, packed, blk[e], depth, bk)
        np.testing.assert_array_equal(a_pad @ w, want)
        for mutation in ("hi_below_half", "blk_off_by_one"):
            if mutation == "hi_below_half" and not packed:
                continue
            bad, _ = _read_expert(cat, k, packed, blk[e], depth, bk, mutation)
            assert not np.array_equal(a_pad @ bad, want), (e, mutation)


# ---------------------------------------------------------------------------
# K4f and K9 on body B: the order of work
# ---------------------------------------------------------------------------

def _body_b(a_q, w, sa, sc, zp, gsize):
    """One expert's rows in body B's order from the k-tiles' codes ``w``
    [cdiv(K, 128) * 128, N] (as the boxes deliver them): int32 sums of
    128-code k-tiles, a group's k-tiles summed before its fold, the quads'
    row sums, folds ascending, every f32 step on its own, from zero."""
    r, k = a_q.shape
    kt_n = _cdiv(k, GROUPED_WGMMA_BK)
    kpg = kt_n if gsize >= k else gsize // GROUPED_WGMMA_BK
    a = np.pad(a_q.astype(np.int64), ((0, 0), (0, kt_n * GROUPED_WGMMA_BK - k)))
    acc = np.zeros((r, w.shape[1]), np.float32)
    for grp, g0 in enumerate(range(0, kt_n, kpg)):
        isum = np.zeros((r, w.shape[1]), np.int64)
        rs = np.zeros((r,), np.int64)
        for t in range(g0, min(g0 + kpg, kt_n)):
            ks = slice(t * GROUPED_WGMMA_BK, (t + 1) * GROUPED_WGMMA_BK)
            isum += a[:, ks] @ w[ks]
            rs += a[:, ks].sum(-1)
        assert np.abs(isum).max() < 2 ** 31
        s = sa[:, grp:grp + 1]
        acc = acc + (isum.astype(np.float32) * s) * sc[grp]
        if zp is not None:
            acc = acc + (rs.astype(np.float32)[:, None] * s) * zp[grp]
    return acc


def _flex_operands(seed, sizes, k, n, groups):
    rng = np.random.default_rng(seed)
    m = int(sum(sizes))
    aq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    asc = (rng.random((m, groups)) * 0.05 + 1e-3).astype(np.float32)
    wsc = (rng.random((len(sizes), groups, n)) * 0.01 + 1e-4).astype(np.float32)
    wzp = (rng.standard_normal((len(sizes), groups, n)) * 0.02).astype(np.float32)
    return aq, asc, wsc, wzp


def _k4f_rows(aq, asc, wsc, zp, cat, blk, pflags, sizes, k, gsize):
    out = np.zeros((aq.shape[0], wsc.shape[-1]), np.float32)
    start = 0
    for e, size in enumerate(sizes):
        if size:
            rows = slice(start, start + size)
            w, _ = _read_expert(cat, k, pflags[e], blk[e], HALF, GROUPED_WGMMA_BK)
            out[rows] = _body_b(aq[rows], w, asc[rows], wsc[e],
                                None if zp is None else zp[e], gsize)
        start += size
    return out


@pytest.mark.parametrize("k,gsize", [(1408, 128), (2048, 256), (1408, -1)],
                         ids=["down_g128", "gate_up_g256", "down_one_group"])
@pytest.mark.parametrize("asym", [False, True], ids=["sym", "zp"])
def test_k4f_order_is_grouped_rows_plain(k, gsize, asym):
    """K4f on body B over the mixed storage, stage by stage, bitwise
    ``grouped_rows_plain`` on the int8 codes (K 1408, g128: group 5 spans
    the packed halves)."""
    g = k if gsize == -1 else gsize
    sizes, n = [3, 0, 5, 2, 4, 1, 2], 16
    codes, cat, blk = _storage(k + g, k, n, FLAGS)
    aq, asc, wsc, wzp = _flex_operands(k + g + 1, sizes, k, n, k // g)
    zp = wzp if asym else None
    got = _k4f_rows(aq, asc, wsc, zp, cat, blk, FLAGS, sizes, k, g)
    start = 0
    for e, size in enumerate(sizes):
        rows = slice(start, start + size)
        if size:
            want = grouped_rows_plain(T(aq[rows]), T(codes[e]), T(asc[rows]), T(wsc[e]),
                                      None if zp is None else T(zp[e]), g)
            np.testing.assert_array_equal(got[rows], want.numpy())
        start += size


def test_k9_body_b_is_its_plain_version():
    """K9 on body B: one group (gsize = K) with zero points, the first term
    added to zero, bitwise ``gmm_w8a8_asym_plain`` (f32 output)."""
    k, n, sizes = 1408, 32, [4, 0, 7, 1]
    rng = np.random.default_rng(9)
    wq = rng.integers(-127, 128, (len(sizes), k, n), dtype=np.int8)
    aq, asc, wsc, wzp = _flex_operands(10, sizes, k, n, 1)
    got = np.zeros((aq.shape[0], n), np.float32)
    start = 0
    for e, size in enumerate(sizes):
        rows = slice(start, start + size)
        if size:
            w = np.pad(wq[e].astype(np.int64), ((0, _cdiv(k, 128) * 128 - k), (0, 0)))
            got[rows] = _body_b(aq[rows], w, asc[rows], wsc[e], wzp[e], k)
        start += size
    want = gas.gmm_w8a8_asym_plain(T(aq), T(asc), T(wq), T(wsc), T(wzp),
                                   torch.tensor(sizes, dtype=torch.int32),
                                   out_dtype=torch.float32)
    np.testing.assert_array_equal(got, want.numpy())


def test_k4f_and_k9_against_jax():
    """Against the JAX kernels in interpret mode, f32 outputs within 2^-21 x
    max|ref|: K4f's stage-by-stage rows over the mixed storage (K 384, g128,
    zp: group 1 spans the packed halves) against ``gmm_mixed_packed``, and
    K9's body-B rows against ``gmm_w8a8_asym``."""
    k, n, sizes, pflags = 384, 128, [9, 30, 0, 2], [1, 1, 0, 0]
    codes, cat, blk = _storage(5, k, n, pflags)
    aq, asc, wsc, wzp = _flex_operands(6, sizes, k, n, k // 128)
    gs = np.asarray(sizes, np.int32)
    ref = np.asarray(pallas_gmm.gmm_mixed_packed(
        jnp.asarray(aq), jnp.asarray(asc), jnp.asarray(cat), jnp.asarray(wsc),
        jnp.asarray(gs), jnp.asarray(pflags, jnp.int32), jnp.asarray(blk, jnp.int32),
        bm=16, bn=128, rhs_zp=jnp.asarray(wzp), out_dtype=jnp.float32, interpret=True))
    got = _k4f_rows(aq, asc, wsc, wzp, cat, blk, pflags, sizes, k, 128)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -21 * np.abs(ref).max())

    wq = codes.copy()
    a1, s1, z1 = asc[:, :1].copy(), wsc[:, :1].copy(), wzp[:, :1].copy()
    ref = np.asarray(pallas_gmm.gmm_w8a8_asym(
        jnp.asarray(aq), jnp.asarray(a1), jnp.asarray(wq), jnp.asarray(s1),
        jnp.asarray(z1), jnp.asarray(gs), bm=16, bn=32, out_dtype=jnp.float32,
        interpret=True))
    got = np.zeros_like(ref)
    start = 0
    for e, size in enumerate(sizes):
        rows = slice(start, start + size)
        if size:
            got[rows] = _body_b(aq[rows], wq[e].astype(np.int64), a1[rows], s1[e], z1[e], k)
        start += size
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -21 * np.abs(ref).max())


def test_touched_modules_import_no_jax():
    """The port's modules this slice touches import neither JAX nor the JAX
    package, and the bodies' sources are where the wrappers say."""
    root = pathlib.Path(__file__).resolve().parents[1] / "mxmoe_tpu_torch"
    bad = re.compile(r"^\s*(import jax|from jax|import mxmoe_tpu\b(?!_torch)|"
                     r"from mxmoe_tpu\b(?!_torch))", re.M)
    for rel in ("ops/gmm_mixed_packed.py", "ops/gmm_w8a8_asym.py", "ops/gmm_w8a8.py",
                "ops/gmm_w8a8_grouped.py", "ops/kernels.py", "bench/redesign_ab.py",
                "bench/kernels.py"):
        assert not bad.search((root / rel).read_text()), rel
    for src in ("gmm_mixed_packed.cu", "gmm_w8a8_asym.cu"):
        text = (root / "csrc" / src).read_text()
        assert '#include "gmm_wq_body.cuh"' in text, src
    assert "gmm_wsr_launch" in (root / "csrc" / "gmm_mixed_packed.cu").read_text()
