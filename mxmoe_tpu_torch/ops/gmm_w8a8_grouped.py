"""Grouped-scale (g128-class) int8 x int8 grouped GEMM (port of
``mxmoe_tpu/ops/pallas_gmm.py:gmm_w8a8_grouped``) — kernel K8,
``csrc/gmm_w8a8_grouped.cu``.

Scales come per k-group of ``gsize`` codes (G = K / gsize): ``lhs_scale``
[M, G], ``rhs_scale`` and the optional ``rhs_zp`` [E, G, N]. Per row r of
expert e, groups ascending, every f32 step rounded on its own:

  acc  = 0
  acc += (float(a[r, g] @ q[e, g]) * s_a[r, g]) * s_b[e, g]
  acc += (float(sum(a[r, g])) * s_a[r, g]) * zp[e, g]        (with rhs_zp)
  out[r] = acc -> out dtype

The per-group integer sums are exact, so kernel and plain version agree
bitwise. ``rhs_zp`` carries asymmetric weights (re-centred storage, ``w = q
* s + zp``). Per-channel experts of a flex layer ride the same launch with
their scales replicated over G; E = 1 is the dense product of a grouped or
asymmetric shared expert. The TPU kernel's k-blocking (``bk``, a sum of
per-block partial sums for K above 4096) is not carried over: the kernel
walks K in group order, in one block or, where the grid is short, split at
whole groups with the groups' int32 sums added by the tile's last block
(``grouped_gmm_schedule``, shared with the flex form of
``gmm_mixed_packed``).
"""

from __future__ import annotations

import torch

from . import kernels
from .gmm_w8a8 import (DECODE_M, K_TILE, SPLIT_BLOCKS, _PART_INTS, Int8GemmSchedule,
                       _cdiv, check_int8_gmm_operands, exact_int8_matmul,
                       schedule_args)

GROUPED_BM = 32    # rows of the prefill body's tile (gmm_grouped_tile.cuh GBM)
MAX_SPLITS = 16


def grouped_gmm_schedule(m: int, k: int, n: int, e: int, gsize: int,
                         aligned: bool = True) -> Int8GemmSchedule:
    """The schedule of the grouped-scale GEMMs (K8, and K4f over any mix of
    int8-stored and nibble-packed experts), from the shapes the host knows.

    Decode (``int8_gmm_schedule``'s thresholds: ``m <= DECODE_M``, N a
    multiple of 16, 16-byte aligned weights): one m16 row block x 64 columns
    a block, m-tiles bounded by M, K walked in logical k-tiles of 64 codes
    whatever the storage. Where fewer than ``SPLIT_BLOCKS`` blocks would run,
    K is split at whole groups (with one group, at whole k-tiles), as few
    groups a split as it takes to reach that many blocks, at most 16 splits;
    each split holds ``gmax`` = k_tiles_per_split / (gsize / 64) groups and
    the workspace one m16 x 64 int32 sum (+ 16 row sums) per tile, split and
    group held. Otherwise the 32 x 128 prefill body over cdiv(M, 32) + E - 1
    logical m-tiles."""
    kt = max(_cdiv(k, K_TILE), 1)
    if m <= DECODE_M and n % 16 == 0 and aligned:
        grid_n, grid_m = _cdiv(n, 64), min(_cdiv(m, 16) + e - 1, m)
        blocks = grid_n * grid_m
        # a split holds whole units: groups of gsize / 64 k-tiles (G > 1) or
        # k-tiles (one group)
        unit = 1 if gsize == k else gsize // K_TILE
        units = _cdiv(kt, unit)
        per = units
        if 0 < blocks < SPLIT_BLOCKS:
            want = min(_cdiv(SPLIT_BLOCKS, blocks), units, MAX_SPLITS)
            per = max(units // want, _cdiv(units, MAX_SPLITS))
        splits = _cdiv(units, per)
        if splits == 1:
            return Int8GemmSchedule(16, 64, grid_n, grid_m, 1, kt, 0, 0)
        gmax = 1 if gsize == k else per
        return Int8GemmSchedule(16, 64, grid_n, grid_m, splits, per * unit,
                                blocks * splits * gmax * _PART_INTS, blocks)
    return Int8GemmSchedule(GROUPED_BM, 128, _cdiv(n, 128),
                            _cdiv(m, GROUPED_BM) + e - 1, 1, kt, 0, 0)


def weight_only_gmm_schedule(m: int, k: int, n: int, e: int, gsize: int,
                             aligned: bool = True) -> Int8GemmSchedule:
    """The one schedule of K6 (``gmm_weight_only``), K7
    (``gmm_weight_only_packed``) and K10 (``gmm_mixed_wo_wxa``, both of its
    bodies on one grid), from the shapes the host knows. An f32 sum depends on
    its order, so K6, K7 and K10's weight-only rows agree bitwise only where
    they take their grid and split count from here.

    Decode: ``grouped_gmm_schedule``'s m16 x 64 grid and split count, where
    its decode domain holds and the weight-only decode body's does too: one
    scale group (``gsize == k``), or groups of whole 64-code tiles with
    K/2 % 64 == 0, so every half-tile of a byte-tile pair lies in one group.
    What a split covers is each body's own. The weight-only body walks
    byte-tile pairs (code rows [r0, r0 + 64) and [K/2 + r0, ..), P =
    cdiv(K/2, 64) of them) and cuts them evenly: split z takes the pairs from
    z * cdiv(P, splits), writes one f32 m16 x 64 partial (its low and high
    halves' sums added), and the tile's last block adds the partials in
    ascending split order (a split past the last pair writes none). The
    w x a body (K8's, in K10) takes ``k_tiles_per_split`` logical k-tiles at
    whole groups. The workspace (``ws_ints``) is the w x a body's [tiles,
    splits, gmax, 16 x 64 + 16] int32 group parts, the larger per split; the
    weight-only body writes split z's f32 partial at slot (tile, z, 0), so in
    K10 every tile keeps to its own region whatever its body.

    Otherwise the 32 x 128 prefill bodies over cdiv(M, 32) + E - 1 logical
    m-tiles, unsplit."""
    whole_tiles = gsize == k or (gsize % K_TILE == 0 and (k // 2) % K_TILE == 0)
    return grouped_gmm_schedule(m, k, n, e, gsize, aligned=aligned and whole_tiles)


def grouped_launch_schedule(lhs_q, rhs, n: int, e: int, gsize: int):
    """``grouped_gmm_schedule`` for these operands -> ``schedule_args``."""
    m, k = lhs_q.shape
    sched = grouped_gmm_schedule(m, k, n, e, gsize,
                                 aligned=rhs.data_ptr() % 16 == 0)
    return schedule_args(sched, lhs_q.device)


def weight_only_launch_schedule(lhs, rhs, n: int, e: int, gsize: int):
    """``weight_only_gmm_schedule`` for these operands -> ``schedule_args``."""
    m, k = lhs.shape
    sched = weight_only_gmm_schedule(m, k, n, e, gsize,
                                     aligned=rhs.data_ptr() % 16 == 0)
    return schedule_args(sched, lhs.device)


def grouped_rows_plain(a_q, w_q, sa, sc, zp, gsize: int) -> torch.Tensor:
    """One expert's rows through K8's arithmetic -> f32 [r, N]: ``a_q`` [r, K]
    and ``w_q`` [K, N] int8 codes, ``sa`` [r, G], ``sc`` and the optional
    ``zp`` [G, N] f32. Exact per-group sums (``exact_int8_matmul``), then
    the f32 steps in ascending group order."""
    r, k = a_q.shape
    n = w_q.shape[-1]
    g = k // gsize
    a = a_q.reshape(r, g, gsize)
    part = exact_int8_matmul(a.permute(1, 0, 2),
                             w_q.reshape(g, gsize, n)).float()    # [G, r, N]
    rsum = a.to(torch.int32).sum(-1).float()                      # [r, G]
    acc = torch.zeros((r, n), dtype=torch.float32, device=a_q.device)
    for j in range(g):
        acc = acc + part[j] * sa[:, j:j + 1] * sc[j]
        if zp is not None:
            acc = acc + (rsum[:, j:j + 1] * sa[:, j:j + 1]) * zp[j]
    return acc


def grouped_scale_plain(lhs_q, lhs_scale, weight_of, rhs_scale, group_sizes,
                        gsize, rhs_zp, out_dtype) -> torch.Tensor:
    """The plain grouped-scale product shared by K8's plain version and the
    flex form of ``gmm_mixed_packed``'s: ``weight_of(e)`` gives expert e's
    [K, N] int8 codes. Reads ``group_sizes`` on the host."""
    m, k = lhs_q.shape
    n = rhs_scale.shape[-1]
    out = torch.zeros((m, n), dtype=out_dtype, device=lhs_q.device)
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = min(start + size, m)
        if end > start:
            acc = grouped_rows_plain(
                lhs_q[start:end], weight_of(e), lhs_scale[start:end],
                rhs_scale[e], None if rhs_zp is None else rhs_zp[e], gsize)
            out[start:end] = acc.to(out_dtype)
        start += size
    return out


def gmm_w8a8_grouped_plain(lhs_q, lhs_scale, rhs_q, rhs_scale, group_sizes,
                           gsize=128, rhs_zp=None,
                           out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K8 (exact per-group sums: int32 on the CPU,
    float64 on a card; reads ``group_sizes`` on the host)."""
    gsize = kernels.group_size(lhs_q.shape[1], gsize, "gmm_w8a8_grouped")
    return grouped_scale_plain(lhs_q, lhs_scale, lambda e: rhs_q[e], rhs_scale,
                               group_sizes, gsize, rhs_zp, out_dtype)


def gmm_w8a8_grouped(
    lhs_q: torch.Tensor,        # [M, K] int8 codes
    lhs_scale: torch.Tensor,    # [M, K/gsize] f32 per-token-per-group scales
    rhs_q: torch.Tensor,        # [E, K, N] int8 codes
    rhs_scale: torch.Tensor,    # [E, K/gsize, N] f32
    group_sizes: torch.Tensor,  # [E] int32, on the tensors' device
    gsize: int = 128,           # -1: one group, all of K
    rhs_zp: torch.Tensor | None = None,   # [E, K/gsize, N] f32
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Grouped-scale w x a int8 grouped matmul -> [M, N]."""
    if lhs_q.device.type == "cpu":
        return gmm_w8a8_grouped_plain(lhs_q, lhs_scale, rhs_q, rhs_scale,
                                      group_sizes, gsize, rhs_zp, out_dtype)
    req = kernels.require
    m, k = lhs_q.shape
    e, _, n = rhs_q.shape
    gsize = kernels.group_size(k, gsize, "gmm_w8a8_grouped")
    req(gsize == k or gsize % 64 == 0,
        f"gmm_w8a8_grouped: gsize={gsize} must be K or a multiple of the "
        "64-code k-tile (128 for the g128 schemes)")
    check_int8_gmm_operands(
        "gmm_w8a8_grouped", lhs_q, lhs_scale, rhs_q, rhs_scale, group_sizes,
        out_dtype, extra=() if rhs_zp is None else (rhs_zp,), groups=k // gsize)
    req(rhs_q.shape == (e, k, n) and rhs_scale.shape[0] == e,
        f"gmm_w8a8_grouped: rhs {tuple(rhs_q.shape)} for K={k}")
    req(rhs_zp is None or (rhs_zp.shape == rhs_scale.shape
                           and rhs_zp.dtype == torch.float32),
        "gmm_w8a8_grouped: rhs_zp must be float32 of rhs_scale's shape")
    out = torch.empty((m, n), dtype=out_dtype, device=lhs_q.device)
    sched, _ws = grouped_launch_schedule(lhs_q, rhs_q, n, e, gsize)
    err = kernels.lib().mxmoe_gmm_w8a8_grouped(
        lhs_q.data_ptr(), lhs_scale.data_ptr(), rhs_q.data_ptr(),
        rhs_scale.data_ptr(), None if rhs_zp is None else rhs_zp.data_ptr(),
        group_sizes.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16), m, k, n, e, gsize, *sched,
        kernels.stream_ptr(lhs_q.device))
    kernels.check(err, "gmm_w8a8_grouped")
    kernels.launches["gmm_w8a8_grouped"] += 1
    return out
