"""Weight-stationary int8 grouped GEMMs (port of
``mxmoe_tpu/ops/pallas_gmm.py:gmm_w8a8_ws`` and ``gmm_w4a8_packed_ws``,
both through ``_gmm_ws_launch``) — kernel K15, ``csrc/gmm_ws.cu``.

The function is ``gmm_w8a8``'s (``gmm_w4a8_packed``'s for nibble-packed
weights) and the output is bitwise theirs on the same layout: the int32 sum
is exact and the epilogue is the same ``(acc * s_a) * s_b``, rounded once.
The kernel is a persistent wgmma body: one CTA an SM walks the work items
of ``ws_work_items`` (group, 256-column n-tile, 128-row m-tile; CTA c takes
items c, c + grid, ...), so the m-tiles of one n-column run side by side and
the group's weight tile comes from L2 after its first read, which is the
reference's weight-stationary intent. Each 128-deep k-tile of codes is
loaded as four quarter boxes of 32 byte rows (``ws_k_tile_quarters``: for
packed weights the low nibbles of rows c below K/2, the high nibbles of rows
c - K/2 above), transposed into wgmma's K-major B layout in shared memory.

``static_sizes`` are concrete Python ints, as in the reference: every size
a ``bm`` multiple (the aligned layout) and their sum M. They reach the
kernel by value in its launch parameters, so no host-to-device copy and no
read-back happens; the reference's host schedule (slots, waits, loads of
its double-buffered DMA) has no counterpart. ``bm`` is the alignment the
layout promises (the reference's row tile); the kernel's own tile needs
none. ``bn`` (the reference's column block) is the kernel's business.
Domain of the kernel (TMA): K a multiple of 64, N of 16, operands 16-byte
aligned, at most 512 groups; K has no upper cap below the int32 sum's.
"""

from __future__ import annotations

import ctypes
import itertools

import torch

from . import kernels
from .gmm_w4a8_packed import gmm_w4a8_packed_plain
from .gmm_w8a8 import WGMMA_BK, WGMMA_BM, WGMMA_BN, WGMMA_MAX_K, gmm_w8a8_plain

MAX_GROUPS = 512
# the kernel's tiles: rows and columns of a work item, codes of a k-tile and
# of one quarter box of raw weight rows (csrc/gmm_ws_body.cuh)
WS_BM, WS_BN, WS_BK, WS_QK = WGMMA_BM, WGMMA_BN, WGMMA_BK, 32
# K x 127 x 128 must stay below 2^31 for the int32 sum to be exact
MAX_K = WGMMA_MAX_K


def ws_work_items(sizes, n: int) -> list[tuple[int, int, int]]:
    """K15's work items (group, n-tile, m-tile) in the order its persistent
    CTAs walk them; CTA c of a grid of P takes items[c::P]."""
    return [(g, j, i) for g, s in enumerate(sizes) for j in range(-(-n // WS_BN))
            for i in range(-(-int(s) // WS_BM))]


def ws_device_work_items(sizes, n: int, m: int) -> list[tuple[int, int, int, int, int]]:
    """The walk of the wgmma body over group sizes read on the device (K2 /
    K5 above the decode rows, K14's second phase): items (group, n-tile,
    m-tile, first row, row end) in the order CTA c of a grid of P takes
    items[c::P]. Group g's m-tiles start at its own first row start_g and
    store rows [start_g, min(start_g + size_g, M)); a tile's rows past that
    end are multiplied (rows past M read as zeros) and not stored."""
    return [(g, j, i, s0 + i * WS_BM, min(s0 + s, m))
            for g, (s0, s) in enumerate(zip(itertools.accumulate(sizes, initial=0), sizes))
            for j in range(-(-n // WS_BN))
            for i in range(-(-max(min(s, m - s0), 0) // WS_BM))]


def ws_k_tile_quarters(k: int, packed: bool) -> list[list[tuple[int, bool]]]:
    """For each 128-deep k-tile of codes, its four quarter boxes as (first
    byte row of the weights, high nibble): codes c = 128 t + 32 q come from
    rows c, or for packed weights from the low nibbles of rows c below K/2
    and the high nibbles of rows c - K/2 above it. Rows past the weights
    read as zeros."""
    half = k // 2
    return [[(c - half, True) if packed and c >= half else (c, False)
             for c in range(t, t + WS_BK, WS_QK)] for t in range(0, k, WS_BK)]


def _sizes(static_sizes, m: int, bm: int, name: str) -> list[int]:
    sizes = [int(s) for s in static_sizes]
    kernels.require(sum(sizes) == m, f"{name}: sum(static_sizes)={sum(sizes)} != M={m}")
    kernels.require(all(s >= 0 and s % bm == 0 for s in sizes),
                    f"{name}: static_sizes must be non-negative multiples of bm={bm}")
    return sizes


def gmm_w8a8_ws_plain(lhs_q, lhs_scale, rhs_q, rhs_scale, static_sizes,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K15 for int8 weights: K2's plain product."""
    gs = torch.tensor([int(s) for s in static_sizes], dtype=torch.int32)
    return gmm_w8a8_plain(lhs_q, lhs_scale, rhs_q, rhs_scale, gs, out_dtype)


def gmm_w4a8_packed_ws_plain(lhs_q, lhs_scale, rhs_packed, rhs_scale, static_sizes,
                             out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K15 for packed weights: K5's plain product."""
    gs = torch.tensor([int(s) for s in static_sizes], dtype=torch.int32)
    return gmm_w4a8_packed_plain(lhs_q, lhs_scale, rhs_packed, rhs_scale, gs,
                                 out_dtype)


def _launch(name, lhs_q, lhs_scale, rhs, rhs_scale, sizes, packed, out_dtype):
    req = kernels.require
    m, k = lhs_q.shape
    e, kdim, n = rhs.shape
    req(all(t.is_cuda and t.device == lhs_q.device and t.is_contiguous()
            for t in (lhs_q, lhs_scale, rhs, rhs_scale)),
        f"{name}: operands must be contiguous tensors on one CUDA device")
    req(lhs_q.dtype == torch.int8 and rhs.dtype == torch.int8,
        f"{name}: codes must be int8")
    req(lhs_scale.dtype == torch.float32 and lhs_scale.shape == (m, 1)
        and rhs_scale.dtype == torch.float32 and rhs_scale.shape == (e, 1, n),
        f"{name}: scales must be float32 [M, 1] / [E, 1, N]")
    req(n % 16 == 0 and lhs_q.data_ptr() % 16 == 0 and rhs.data_ptr() % 16 == 0,
        f"{name}: N={n} not a multiple of 16, or an operand not 16-byte aligned")
    req(out_dtype in (torch.bfloat16, torch.float32), f"{name}: out dtype {out_dtype}")
    req(len(sizes) == e and e <= MAX_GROUPS,
        f"{name}: {len(sizes)} sizes for {e} experts (at most {MAX_GROUPS})")
    req(kdim == (k // 2 if packed else k) and k % 64 == 0 and 0 < k <= MAX_K,
        f"{name}: rhs {tuple(rhs.shape)} for K={k} (K a multiple of 64, at most "
        f"{MAX_K})")
    out = torch.empty((m, n), dtype=out_dtype, device=lhs_q.device)
    host_sizes = (ctypes.c_int * e)(*sizes)
    err = kernels.lib().mxmoe_gmm_ws(
        lhs_q.data_ptr(), lhs_scale.data_ptr(), rhs.data_ptr(), rhs_scale.data_ptr(),
        host_sizes, out.data_ptr(), int(packed), int(out_dtype == torch.bfloat16),
        m, k, n, e, kernels.stream_ptr(lhs_q.device))
    kernels.check(err, name)
    kernels.launches["gmm_ws"] += 1
    return out


def gmm_w8a8_ws(
    lhs_q: torch.Tensor,        # [M, K] int8 codes
    lhs_scale: torch.Tensor,    # [M, 1] f32 per-token scale
    rhs_q: torch.Tensor,        # [E, K, N] int8 codes
    rhs_scale: torch.Tensor,    # [E, 1, N] f32 per-channel scale
    static_sizes,               # concrete, group-aligned (bm multiples)
    bm: int = 128,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Weight-stationary symmetric int8 grouped matmul -> [M, N]."""
    sizes = _sizes(static_sizes, lhs_q.shape[0], bm, "gmm_w8a8_ws")
    if lhs_q.device.type == "cpu":
        return gmm_w8a8_ws_plain(lhs_q, lhs_scale, rhs_q, rhs_scale, sizes, out_dtype)
    return _launch("gmm_w8a8_ws", lhs_q, lhs_scale, rhs_q, rhs_scale, sizes, False,
                   out_dtype)


def gmm_w4a8_packed_ws(
    lhs_q: torch.Tensor,        # [M, K] int8 codes (a4 or a8 range)
    lhs_scale: torch.Tensor,    # [M, 1] f32
    rhs_packed: torch.Tensor,   # [E, K/2, N] int8 nibble-packed (halves)
    rhs_scale: torch.Tensor,    # [E, 1, N] f32
    static_sizes,
    bm: int = 128,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Weight-stationary nibble-packed grouped matmul -> [M, N]."""
    sizes = _sizes(static_sizes, lhs_q.shape[0], bm, "gmm_w4a8_packed_ws")
    if lhs_q.device.type == "cpu":
        return gmm_w4a8_packed_ws_plain(lhs_q, lhs_scale, rhs_packed, rhs_scale,
                                        sizes, out_dtype)
    return _launch("gmm_w4a8_packed_ws", lhs_q, lhs_scale, rhs_packed, rhs_scale,
                   sizes, True, out_dtype)
