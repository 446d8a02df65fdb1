"""The weight-quantized GEMMs' persistent wgmma bodies above the decode rows
(``csrc/gmm_wq_body.cuh``): body A, the weight-only product of K6 / K7 and
of K10's weight-only experts, and body B, the grouped-scale int8 product of
K8 and of K10's w x a experts. No kernel runs on the CPU, so this file holds
what surrounds them and their arithmetic written out:

- the schedules (``weight_only_gmm_schedule``, ``grouped_gmm_schedule``)
  pick the wgmma bodies from their thresholds on and inside their domains,
  the 32 x 128 bodies elsewhere above the decode rows (K4f's choice over
  its ragged storage is test_torch_mixed_wgmma_schedule.py's);
- the walk (``wq_device_work_items`` / ``wq_cta_items``, and the kernel's
  cursor ``WqWalk`` written out here) covers every row and column of every
  group once, at each body's width, stores only the group's own rows, and
  deals the items so that the CTAs hold the same k-tiles (body A's items
  count twice body B's);
- body A's dequantization, written out in numpy as the consumer warps do it
  (warp cw the rows cw + 8 i, lane l the columns 8 l .. 8 l + 7, the biased
  byte in the mantissa of 2^23, separate f32 multiply and add, one bf16
  rounding), puts every weight at the byte where TMA puts K11's bf16 weights,
  with ``dequantize_expert``'s bits, for all 256 int8 codes and all 16
  nibbles; the packed storage's stages equal the int8 storage's;
- body B's order of work, written out stage by stage (int32 sums of
  128-code k-tiles, a group's k-tiles summed before its fold, folds in
  ascending group order, the zp term's row sums), is bitwise
  ``grouped_rows_plain``, and so within the tolerance of
  ``test_torch_gmm_grouped.py`` of the JAX ``gmm_w8a8_grouped`` in interpret
  mode (XLA contracts the JAX epilogue into FMAs); folds swapped or the zp
  term dropped are seen.
"""

import itertools
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.ops import pallas_gmm
from mxmoe_tpu_torch.models import configs
from mxmoe_tpu_torch.ops.gmm_w8a8 import DECODE_M
from mxmoe_tpu_torch.ops.gmm_w8a8_grouped import (
    GROUPED_BM, GROUPED_WGMMA_BK, GROUPED_WGMMA_BN, GROUPED_WGMMA_MIN_M, WO_WGMMA_BK,
    WO_WGMMA_BN, WO_WGMMA_MIN_M, WQ_BM, grouped_gmm_schedule, grouped_rows_plain,
    grouped_wgmma_domain, weight_only_gmm_schedule, wo_wgmma_domain, wq_cta_items,
    wq_device_work_items)
from mxmoe_tpu_torch.ops.gmm_weight_only import dequantize_expert
from mxmoe_tpu_torch.quant.packing import pack_int4_halves

T = torch.from_numpy


def _cdiv(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------

def _model_shapes(model):
    cfg = configs.config_for(model)
    h, n = cfg.hidden_size, cfg.moe_intermediate_size
    shapes = [(h, 2 * n), (n, h)]
    sn = getattr(cfg, "shared_expert_intermediate_size", 0) or 0
    if sn:
        shapes += [(h, 2 * sn), (sn, h)]
    return shapes


@pytest.mark.parametrize("model", ["qwen2_moe", "ds2", "mixtral", "qwen2_moe_57b"])
def test_main_path_shapes_lie_in_both_domains(model):
    """Every expert GEMM of the models the port serves, at g128 and with one
    group, is inside both bodies' domains (K % 128 == 0, N % 16 == 0)."""
    for k, n in _model_shapes(model):
        for gsize in (128, k):
            assert wo_wgmma_domain(4096, k, n, gsize, True), (model, k, n, gsize)
            assert grouped_wgmma_domain(4096, k, n, gsize, True), (model, k, n, gsize)


ROWS = sorted({1, 16, DECODE_M, DECODE_M + 1, 256, 1024, 8192, 65536,
               WO_WGMMA_MIN_M - 1, WO_WGMMA_MIN_M, GROUPED_WGMMA_MIN_M - 1,
               GROUPED_WGMMA_MIN_M} - {0})


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,n", [(2048, 2816), (1408, 2048)], ids=["gate_up", "down"])
def test_weight_only_schedule_by_rows(m, k, n):
    """K6 / K7 / K10: the m16 decode body up to DECODE_M, the 32 x 128 bodies
    below WO_WGMMA_MIN_M, the wgmma walk (128 x 256 items, 64-code
    k-tiles) from it on."""
    s = weight_only_gmm_schedule(m, k, n, 60, 128)
    if m <= DECODE_M:
        assert s.bm == 16
    elif m < WO_WGMMA_MIN_M:
        assert (s.bm, s.bn) == (GROUPED_BM, 128)
    else:
        assert (s.bm, s.bn, s.grid_n, s.grid_m, s.splits, s.k_tiles_per_split) == (
            WQ_BM, WO_WGMMA_BN, _cdiv(n, 256), _cdiv(m, 128) + 60, 1, k // WO_WGMMA_BK)
        assert (s.ws_ints, s.tickets) == (0, 0)


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("gsize", [128, -1], ids=["g128", "one_group"])
def test_grouped_schedule_by_rows(m, gsize):
    """K8 (``wgmma=True``): the wgmma walk (128 x 128 items, 128-code
    k-tiles) from GROUPED_WGMMA_MIN_M on; without ``wgmma`` the schedule
    keeps the mma.sync bodies at every row count (K4f's outside its domain;
    K4f's own schedule, ``mixed``, is test_torch_mixed_wgmma_schedule.py's)."""
    k, n = 2048, 2816
    g = k if gsize == -1 else gsize
    s = grouped_gmm_schedule(m, k, n, 60, g, wgmma=True)
    flex = grouped_gmm_schedule(m, k, n, 60, g)
    assert flex.bm in (16, GROUPED_BM)
    if m < GROUPED_WGMMA_MIN_M:
        assert s == flex
    else:
        assert (s.bm, s.bn, s.grid_n, s.grid_m, s.splits, s.k_tiles_per_split) == (
            WQ_BM, GROUPED_WGMMA_BN, _cdiv(n, 128), _cdiv(m, 128) + 60, 1,
            k // GROUPED_WGMMA_BK)


@pytest.mark.parametrize("k,n,gsize,aligned,wo,grouped", [
    (2048, 2816, 128, True, True, True),
    (2048, 2816, 2048, True, True, True),      # one group
    (2048, 2816, 256, True, True, True),       # groups of two k-tiles
    (2048, 2816, 64, True, False, False),      # groups smaller than body B's k-tile
    (2048, 40, 128, True, False, False),       # N % 16 != 0 (TMA)
    (2048, 2816, 128, False, False, False),    # weights not 16-byte aligned
    (1472, 2048, 1472, True, False, True),     # K % 128 != 0: body A only
    (96, 64, 96, True, False, True),
])
def test_domains(k, n, gsize, aligned, wo, grouped):
    m = max(WO_WGMMA_MIN_M, GROUPED_WGMMA_MIN_M, 1024)
    assert wo_wgmma_domain(m, k, n, gsize, aligned) == wo
    assert grouped_wgmma_domain(m, k, n, gsize, aligned) == grouped
    s = weight_only_gmm_schedule(m, k, n, 8, gsize, aligned=aligned)
    assert (s.bm == WQ_BM) == wo and s.bm in (WQ_BM, GROUPED_BM)
    s = grouped_gmm_schedule(m, k, n, 8, gsize, aligned=aligned, wgmma=True)
    assert (s.bm == WQ_BM) == grouped and s.bm in (WQ_BM, GROUPED_BM)


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------

def _kernel_walk(sizes, n, m, flags, grid):
    """``WqWalk`` as written in gmm_wq_body.cuh: each CTA's cursor over the
    groups with its next item of each body (body A's from c by grid; body
    B's first deal of two a CTA to CTAs rA .., then from J1 + c by grid)
    -> [the CTA's items]."""
    def geometry(g, row0):
        mt = _cdiv(max(min(sizes[g], m - row0), 0), WQ_BM)
        wo = flags is None or bool(flags[g])
        bn = 256 if wo else 128
        return mt, _cdiv(n, bn), bn, wo

    n_a, r0 = 0, 0
    if flags is not None:                     # K10's pre-scan of body A's items
        for g in range(len(sizes)):
            if flags[g]:
                n_a += geometry(g, r0)[0] * _cdiv(n, 256)
            r0 += sizes[g]
    out = []
    for c in range(grid):
        r_a = n_a % grid
        j1, step1 = (2 * (grid - r_a), grid - r_a) if r_a else (0, 0)
        nxt = [c, (c - r_a if c >= r_a else j1 + c) if r_a else c]
        base = [0, 0]
        g = row0 = 0
        mt, nt, bn, wo = geometry(0, 0)
        mine = []
        while True:
            r = nxt[0 if wo else 1] - base[0 if wo else 1]
            done = False
            while r >= mt * nt:
                base[0 if wo else 1] += mt * nt
                row0 += sizes[g]
                g += 1
                if g >= len(sizes):
                    done = True
                    break
                mt, nt, bn, wo = geometry(g, row0)
                r = nxt[0 if wo else 1] - base[0 if wo else 1]
            if done:
                break
            mine.append((g, r // mt, r % mt, row0 + (r % mt) * WQ_BM,
                         min(row0 + sizes[g], m), bn))
            b = 0 if wo else 1
            if b == 1 and nxt[1] < j1:
                nxt[1] += step1
                if nxt[1] >= j1:
                    nxt[1] = j1 + c
            else:
                nxt[b] += grid
        out.append(mine)
    return out


WALK_CASES = [
    ([300, 0, 17, 129, 0, 256, 1], 2816, None),
    ([300, 0, 17, 129, 0, 256, 1], 2048, [1, 0, 0, 1, 1, 0, 1]),
    ([5, 0, 19, 8, 0, 12, 200], 400, [0, 0, 0, 0, 0, 0, 0]),
    ([1024], 11264, None),
    ([40, 0, 0, 90], 272, [1, 1, 0, 0]),
    ([17] * 60, 2816, [i % 2 for i in range(60)]),    # a chunk's gate_up in K10
]


@pytest.mark.parametrize("sizes,n,flags", WALK_CASES)
@pytest.mark.parametrize("short", [0, 37], ids=["all_rows", "rows_past_m"])
def test_walk_covers_every_row_and_column_once(sizes, n, flags, short):
    """Every (row, column) of every group below M stored once, by an item of
    its own group at its body's width; nothing past M or the groups; the
    kernel's cursor finds the same items for any grid."""
    m = sum(sizes) - short
    items = wq_device_work_items(sizes, n, m, flags)
    cover = np.zeros((max(m, 0) + WQ_BM, n), np.int32)
    starts = list(itertools.accumulate(sizes, initial=0))
    for g, j, i, r0, r_end, bn in items:
        assert bn == (WO_WGMMA_BN if flags is None or flags[g] else GROUPED_WGMMA_BN)
        assert starts[g] <= r0 < r_end == min(starts[g + 1], m)
        assert r0 == starts[g] + i * WQ_BM and j * bn < n
        cover[r0:min(r0 + WQ_BM, r_end), j * bn:min(j * bn + bn, n)] += 1
    assert (cover[:m] == 1).all() and (cover[m:] == 0).all()
    for grid in (1, 7, 132):
        dealt = wq_cta_items(items, grid)
        assert _kernel_walk(sizes, n, m, flags, grid) == dealt
        assert sorted(x for cta in dealt for x in cta) == sorted(items)
        # the k-tiles a CTA holds (a body A item two units, body B one)
        # differ by at most two units, one when one body holds every item
        units = [sum(2 if x[5] == WO_WGMMA_BN else 1 for x in cta) for cta in dealt]
        mixed = len({x[5] for x in items}) > 1
        assert max(units) - min(units) <= (2 if mixed else
                                           2 if items and items[0][5] == 256 else 1)


# ---------------------------------------------------------------------------
# body A: the consumer warps' dequantization into the bf16 B stage
# ---------------------------------------------------------------------------

def _bf16_bits(x):
    """float32 -> bf16 bits, round to nearest even (finite values)."""
    b = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint16)


def _tma_stage_offsets():
    """Byte offset of weight (k row r, column c) in the stage TMA writes for
    K11's bf16 weights: four [64 k x 64 columns] boxes 8192 bytes apart,
    128-byte rows, 16-byte chunk (c % 64) / 8 of row r at chunk ^ (r % 8)."""
    r, c = np.meshgrid(np.arange(64), np.arange(256), indexing="ij")
    return (c // 64) * 8192 + r * 128 + ((((c % 64) // 8) ^ (r % 8)) << 4) + (c % 8) * 2


def _dequant_stage(raw, s, z, packed, hi):
    """``wq_dequant_rows`` of all eight consumer warps over one raw k-tile
    ([64 byte rows, 256] uint8) with the k-tile's scale / zp rows [256] ->
    the 32768-byte B stage."""
    stage = np.zeros(32768, np.uint8)
    bias = 8 if packed else 128
    lane = np.arange(32)
    for cw in range(8):
        for i in range(8):
            row = cw + 8 * i
            u = raw[row].reshape(32, 8).astype(np.uint32)
            if packed:
                u = ((u >> (4 if hi else 0)) & 0xF) ^ 0x8
            else:
                u = u ^ 0x80
            f = (np.uint32(0x4B000000) | u).view(np.float32)
            code = f - np.float32(8388608.0 + bias)
            w = code * s.reshape(32, 8) + z.reshape(32, 8)       # two f32 roundings
            bits = _bf16_bits(w).view(np.uint8).reshape(32, 16)
            off = (lane >> 3) * 8192 + row * 128 + (((lane & 7) ^ cw) << 4)
            for lo in range(32):
                stage[off[lo]:off[lo] + 16] = bits[lo]
    return stage


@pytest.mark.parametrize("k", [1408, 2048])
@pytest.mark.parametrize("storage", ["int8", "packed"])
def test_body_a_stage_is_k11s_layout_of_dequantize_expert(k, storage):
    """At K 1408 (K/2 = 704 = 11 x 64) and 2048, g128 with zero points: each
    64-code k-tile's stage holds dequantize_expert's bf16 bits at the bytes
    of K11's TMA layout; the packed storage reads byte rows 64 t (low
    nibbles) below K/2 and 64 t - K/2 (high nibbles) above, and its stages
    equal the int8 storage's on the same codes."""
    rng = np.random.default_rng(k)
    n, gsize = 256, 128
    lo, hi_ = (-8, 8) if storage == "packed" else (-128, 128)
    codes = rng.permutation(np.resize(np.arange(lo, hi_, dtype=np.int8), k * n)).reshape(k, n)
    scale = (rng.random((k // gsize, n)) * 0.02 + 1e-3).astype(np.float32)
    zp = (rng.standard_normal((k // gsize, n)) * 0.05).astype(np.float32)
    want = dequantize_expert(T(codes), T(scale), T(zp), gsize, torch.bfloat16)
    want = want.view(torch.int16).numpy().view(np.uint16)
    off = _tma_stage_offsets()
    stored = pack_int4_halves(T(codes)).numpy().view(np.uint8) if storage == "packed" \
        else codes.view(np.uint8)
    for t in range(k // WO_WGMMA_BK):
        k0 = t * WO_WGMMA_BK
        hi = storage == "packed" and k0 >= k // 2
        r0 = k0 - k // 2 if hi else k0
        grp = k0 // gsize
        stage = _dequant_stage(stored[r0:r0 + 64], scale[grp], zp[grp],
                               storage == "packed", hi)
        expect = np.zeros(32768, np.uint8)
        expect.view(np.uint16)[off // 2] = want[k0:k0 + 64]
        np.testing.assert_array_equal(stage, expect, err_msg=f"k-tile {t}")
        if storage == "packed":    # the same stage as K6's on the same codes
            np.testing.assert_array_equal(
                stage, _dequant_stage(codes.view(np.uint8)[k0:k0 + 64], scale[grp],
                                      zp[grp], False, False))


def test_body_a_covers_every_code():
    """All 256 int8 codes and all 16 nibbles (low and high) become their
    exact f32 values through the biased-mantissa conversion."""
    u = np.arange(256, dtype=np.uint32)
    f = (np.uint32(0x4B000000) | (u ^ 0x80)).view(np.float32) - np.float32(8388608.0 + 128)
    np.testing.assert_array_equal(f, u.astype(np.uint8).view(np.int8).astype(np.float32))
    for shift in (0, 4):
        nib = ((u >> shift) & 0xF) ^ 0x8
        f = (np.uint32(0x4B000000) | nib).view(np.float32) - np.float32(8388608.0 + 8)
        want = (((u >> shift) & 0xF).astype(np.int32) ^ 8) - 8
        np.testing.assert_array_equal(f, want.astype(np.float32))


# ---------------------------------------------------------------------------
# body B: the grouped-scale product stage by stage
# ---------------------------------------------------------------------------

def _body_b_rows(a_q, w_q, sa, sc, zp, gsize, order=1, drop_zp=False,
                 fold_each_tile=False):
    """One expert's rows in body B's order: the int32 sums of 128-code
    k-tiles (zero past K) over a group's k-tiles, the quads' dp4a row sums,
    then the fold, every f32 step on its own, groups ascending (``order``
    -1, ``drop_zp`` and ``fold_each_tile`` are the mutations)."""
    r, k = a_q.shape
    n = w_q.shape[1]
    kt_n = _cdiv(k, GROUPED_WGMMA_BK)
    kpg = kt_n if gsize >= k else gsize // GROUPED_WGMMA_BK
    pad = kt_n * GROUPED_WGMMA_BK - k
    a = np.pad(a_q.astype(np.int64), ((0, 0), (0, pad)))
    w = np.pad(w_q.astype(np.int64), ((0, pad), (0, 0)))
    groups = []
    for g0 in range(0, kt_n, kpg):
        isum = np.zeros((r, n), np.int64)
        rs = np.zeros((r,), np.int64)
        for t in range(g0, min(g0 + kpg, kt_n)):
            ks = slice(t * GROUPED_WGMMA_BK, (t + 1) * GROUPED_WGMMA_BK)
            t_sum = a[:, ks] @ w[ks]
            isum += t_sum
            rs += a[:, ks].reshape(r, 4, 32).sum(-1).sum(-1)   # a lane's 32 codes, the quad
        assert np.abs(isum).max() < 2 ** 31
        groups.append((isum, rs))
        if fold_each_tile:      # a fold per k-tile with the group's scales
            groups[-1] = [(isum - t_sum, rs), (t_sum, np.zeros_like(rs))]
        else:
            groups[-1] = [groups[-1]]
    acc = np.zeros((r, n), np.float32)
    for grp in range(len(groups))[::order]:
        s = sa[:, grp:grp + 1]
        for isum, rs in groups[grp]:
            acc = acc + (isum.astype(np.float32) * s) * sc[grp]
            if zp is not None and not drop_zp:
                acc = acc + (rs.astype(np.float32)[:, None] * s) * zp[grp]
    return acc


def _b_operands(seed, sizes, k, n, groups):
    rng = np.random.default_rng(seed)
    m, e = int(sum(sizes)), len(sizes)
    aq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    asc = (rng.random((m, groups)) * 0.05 + 1e-3).astype(np.float32)
    wq = rng.integers(-127, 128, (e, k, n), dtype=np.int8)
    wsc = (rng.random((e, groups, n)) * 0.01 + 1e-4).astype(np.float32)
    wzp = (rng.standard_normal((e, groups, n)) * 0.02).astype(np.float32)
    return aq, asc, wq, wsc, wzp, np.asarray(sizes, np.int32)


B_CASES = [([9, 0, 23, 4], 512, 64, 128), ([9, 0, 23, 4], 512, 64, 256),
           ([7, 12], 384, 48, -1), ([30], 1408, 32, 128)]


@pytest.mark.parametrize("sizes,k,n,gsize", B_CASES)
@pytest.mark.parametrize("asym", [False, True], ids=["sym", "zp"])
def test_body_b_order_is_grouped_rows_plain(sizes, k, n, gsize, asym):
    g = k if gsize == -1 else gsize
    aq, asc, wq, wsc, wzp, gs = _b_operands(k + n, sizes, k, n, k // g)
    zp = wzp if asym else None
    start = 0
    for e, size in enumerate(sizes):
        if size:
            rows = slice(start, start + size)
            got = _body_b_rows(aq[rows], wq[e], asc[rows], wsc[e],
                               None if zp is None else zp[e], g)
            want = grouped_rows_plain(T(aq[rows]), T(wq[e]), T(asc[rows]), T(wsc[e]),
                                      None if zp is None else T(zp[e]), g)
            np.testing.assert_array_equal(got, want.numpy())
            # the mutations are seen: folds in descending order (three
            # groups or more: two f32 terms add in either order alike), a
            # fold per k-tile of a two-tile group, zp dropped
            zpe = None if zp is None else zp[e]
            if k // g > 2:
                assert not np.array_equal(
                    _body_b_rows(aq[rows], wq[e], asc[rows], wsc[e], zpe, g, order=-1),
                    got)
            if g == 2 * GROUPED_WGMMA_BK:
                assert not np.array_equal(
                    _body_b_rows(aq[rows], wq[e], asc[rows], wsc[e], zpe, g,
                                 fold_each_tile=True), got)
            if asym:
                assert not np.array_equal(
                    _body_b_rows(aq[rows], wq[e], asc[rows], wsc[e], zp[e], g,
                                 drop_zp=True), got)
        start += size


@pytest.mark.parametrize("sizes,k,n,gsize", B_CASES[:3])
@pytest.mark.parametrize("asym", [False, True], ids=["sym", "zp"])
def test_body_b_order_against_jax(sizes, k, n, gsize, asym):
    """Against the JAX kernel in interpret mode: f32 outputs within 2^-21 x
    max|ref| (the JAX epilogue's FMAs; test_torch_gmm_grouped.py)."""
    g = k if gsize == -1 else gsize
    aq, asc, wq, wsc, wzp, gs = _b_operands(k * 2 + n, sizes, k, n, k // g)
    zp = wzp if asym else None
    ref = np.asarray(pallas_gmm.gmm_w8a8_grouped(
        jnp.asarray(aq), jnp.asarray(asc), jnp.asarray(wq), jnp.asarray(wsc),
        jnp.asarray(gs), gsize=g, bm=16, bn=32,
        rhs_zp=None if zp is None else jnp.asarray(zp),
        out_dtype=jnp.float32, interpret=True))
    got = np.zeros_like(ref)
    start = 0
    for e, size in enumerate(sizes):
        rows = slice(start, start + size)
        if size:
            got[rows] = _body_b_rows(aq[rows], wq[e], asc[rows], wsc[e],
                                     None if zp is None else zp[e], g)
        start += size
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -21 * np.abs(ref).max())


def test_new_modules_import_no_jax():
    """The port's modules this slice touches import neither JAX nor the JAX
    package."""
    root = pathlib.Path(__file__).resolve().parents[1] / "mxmoe_tpu_torch"
    bad = re.compile(r"^\s*(import jax|from jax|import mxmoe_tpu\b(?!_torch)|"
                     r"from mxmoe_tpu\b(?!_torch))", re.M)
    for rel in ("ops/gmm_w8a8_grouped.py", "ops/gmm_weight_only.py",
                "ops/gmm_weight_only_packed.py", "ops/gmm_mixed_wo_wxa.py",
                "bench/redesign_ab.py", "bench/kernels.py"):
        assert not bad.search((root / rel).read_text()), rel
    assert (root / "csrc" / "gmm_wq_body.cuh").exists()
