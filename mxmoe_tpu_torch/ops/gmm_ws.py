"""Weight-stationary int8 grouped GEMMs (port of
``mxmoe_tpu/ops/pallas_gmm.py:gmm_w8a8_ws`` and ``gmm_w4a8_packed_ws``,
both through ``_gmm_ws_launch``) — kernel K15, ``csrc/gmm_ws.cu``.

The function is ``gmm_w8a8``'s (``gmm_w4a8_packed``'s for nibble-packed
weights) and the output is bitwise theirs on the same layout: the int32 sum
is exact and the epilogue is the same ``(acc * s_a) * s_b``, rounded once.
What differs is the schedule: a block holds one expert's full-K weight
slice in shared memory and walks every m-tile of the expert's rows, so each
weight byte leaves device memory once per launch.

``static_sizes`` are concrete Python ints, as in the reference: every size
a ``bm`` multiple (the aligned layout) and their sum M. They reach the
kernel by value in its launch parameters, so no host-to-device copy and no
read-back happens; the reference's host schedule (slots, waits, loads of
its double-buffered DMA) has no counterpart. ``bm`` is the alignment the
layout promises (the reference's row tile); the kernel's own tile needs
none. ``bn`` (the reference's column block) is the kernel's business.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels
from .gmm_w4a8_packed import gmm_w4a8_packed_plain
from .gmm_w8a8 import gmm_w8a8_plain

MAX_GROUPS = 512


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
    req(n % 4 == 0 and lhs_q.data_ptr() % 16 == 0 and rhs.data_ptr() % 4 == 0,
        f"{name}: N={n} % 4, or a misaligned operand")
    req(out_dtype in (torch.bfloat16, torch.float32), f"{name}: out dtype {out_dtype}")
    req(len(sizes) == e and e <= MAX_GROUPS,
        f"{name}: {len(sizes)} sizes for {e} experts (at most {MAX_GROUPS})")
    req(kdim == (k // 2 if packed else k) and k % 64 == 0,
        f"{name}: rhs {tuple(rhs.shape)} for K={k} (K a multiple of 64)")
    req(kernels.lib().mxmoe_gmm_ws_smem_bytes(k) <= 227 * 1024,
        f"{name}: K={k}: a full-K weight slice does not fit shared memory")
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
