"""Weight-only (a16) grouped GEMM over nibble-packed 4-bit weights (port of
``mxmoe_tpu/ops/pallas_gmm.py:gmm_weight_only_packed``) — kernel K7,
``csrc/gmm_weight_only_packed.cu``.

``rhs_packed`` [E, K/2, N] int8: every expert's signed 4-bit codes in the
halves layout of ``quant.packing.pack_int4_halves``; ``rhs_scale`` /
``rhs_zp`` [E, K/gsize, N] index the codes' own k (the high nibble of byte
row r belongs to group ``(K/2 + r) // gsize``). Same contract as
``gmm_weight_only`` and, on the card, bitwise its output on the unpacked
codes: both kernels walk K in one order.
"""

from __future__ import annotations

import torch

from . import kernels
from ..quant.packing import unpack_int4_halves
from .gmm_weight_only import (check_weight_only_operands, dequantize_expert,
                              grouped_weight_only_plain)


def gmm_weight_only_packed_plain(lhs, rhs_packed, rhs_scale, rhs_zp, group_sizes,
                                 gsize, out_dtype=torch.bfloat16,
                                 acc_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of K7: unpack, dequantize, then the grouped
    product."""
    gsize = kernels.group_size(lhs.shape[1], gsize, "gmm_weight_only_packed")
    return grouped_weight_only_plain(
        lhs, lambda e: dequantize_expert(unpack_int4_halves(rhs_packed[e]),
                                         rhs_scale[e], rhs_zp[e], gsize, lhs.dtype),
        rhs_packed.shape[-1], group_sizes, out_dtype, acc_dtype)


def gmm_weight_only_packed(
    lhs: torch.Tensor,          # [M, K] bf16 (any float dtype on the CPU)
    rhs_packed: torch.Tensor,   # [E, K/2, N] int8 nibble-packed
    rhs_scale: torch.Tensor,    # [E, K/gsize, N] f32
    rhs_zp: torch.Tensor,       # [E, K/gsize, N] f32 (zeros when symmetric)
    group_sizes: torch.Tensor,  # [E] int32
    gsize: int,                 # -1: one group, all of K
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """w4a16 grouped matmul on packed weights -> [M, N]."""
    if lhs.device.type == "cpu":
        return gmm_weight_only_packed_plain(lhs, rhs_packed, rhs_scale, rhs_zp,
                                            group_sizes, gsize, out_dtype)
    m, k = lhs.shape
    e, n = rhs_scale.shape[0], rhs_scale.shape[-1]
    gsize = kernels.group_size(k, gsize, "gmm_weight_only_packed")
    check_weight_only_operands("gmm_weight_only_packed", lhs, rhs_packed,
                               rhs_scale, rhs_zp, group_sizes, gsize, out_dtype)
    kernels.require(rhs_packed.shape == (e, k // 2, n),
                    f"gmm_weight_only_packed: rhs_packed {tuple(rhs_packed.shape)} "
                    f"for K={k}, N={n}")
    out = torch.empty((m, n), dtype=out_dtype, device=lhs.device)
    err = kernels.lib().mxmoe_gmm_weight_only_packed(
        lhs.data_ptr(), rhs_packed.data_ptr(), rhs_scale.data_ptr(),
        rhs_zp.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16), m, k, n, e, gsize,
        kernels.stream_ptr(lhs.device))
    kernels.check(err, "gmm_weight_only_packed")
    kernels.launches["gmm_weight_only_packed"] += 1
    return out
