"""int8 activations x nibble-packed 4-bit weights, grouped over
expert-sorted rows (port of ``mxmoe_tpu/ops/pallas_gmm.py:gmm_w4a8_packed``)
— kernel K5, ``csrc/gmm_w4a8_packed.cu``.

``rhs_packed`` [E, K/2, N] int8: every expert's signed 4-bit codes in the
halves layout of ``quant.packing.pack_int4_halves``. Same contract and
epilogue as ``gmm_w8a8``; the output is bitwise that of ``gmm_w8a8`` on the
unpacked codes and of ``gmm_mixed_packed`` on an all-packed ragged buffer.
The TPU grid's ``static_sizes`` / ``aligned`` / ``group_base`` have no
counterpart here.
"""

from __future__ import annotations

import torch

from . import kernels
from ..quant.packing import unpack_int4_halves
from .gmm_w8a8 import (check_int8_gmm_operands, grouped_int8_plain,
                       int8_launch_schedule)


def gmm_w4a8_packed_plain(lhs_q, lhs_scale, rhs_packed, rhs_scale, group_sizes,
                          out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K5: unpack, then the exact grouped product."""
    return grouped_int8_plain(lhs_q, lhs_scale,
                              lambda e: unpack_int4_halves(rhs_packed[e]),
                              rhs_scale, group_sizes, out_dtype)


def gmm_w4a8_packed(
    lhs_q: torch.Tensor,        # [M, K] int8 codes (a4 or a8 range)
    lhs_scale: torch.Tensor,    # [M, 1] f32
    rhs_packed: torch.Tensor,   # [E, K/2, N] int8 nibble-packed
    rhs_scale: torch.Tensor,    # [E, 1, N] f32
    group_sizes: torch.Tensor,  # [E] int32
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """4-bit-packed-weight grouped matmul -> [M, N]."""
    if lhs_q.device.type == "cpu":
        return gmm_w4a8_packed_plain(lhs_q, lhs_scale, rhs_packed, rhs_scale,
                                     group_sizes, out_dtype)
    m, k = lhs_q.shape
    e, n = rhs_scale.shape[0], rhs_scale.shape[-1]
    check_int8_gmm_operands("gmm_w4a8_packed", lhs_q, lhs_scale, rhs_packed,
                            rhs_scale, group_sizes, out_dtype)
    kernels.require(k % 32 == 0 and rhs_packed.shape == (e, k // 2, n),
                    f"gmm_w4a8_packed: rhs_packed {tuple(rhs_packed.shape)} for "
                    f"K={k} (a multiple of 32), N={n}")
    out = torch.empty((m, n), dtype=out_dtype, device=lhs_q.device)
    sched, _ws = int8_launch_schedule(lhs_q, rhs_packed, n, e, packed=True,
                                      wgmma=True)
    err = kernels.lib().mxmoe_gmm_w4a8_packed(
        lhs_q.data_ptr(), lhs_scale.data_ptr(), rhs_packed.data_ptr(),
        rhs_scale.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16), m, k, n, e, *sched,
        kernels.stream_ptr(lhs_q.device))
    kernels.check(err, "gmm_w4a8_packed")
    kernels.launches["gmm_w4a8_packed"] += 1
    return out
