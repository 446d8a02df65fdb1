"""One-launch mixed-precision grouped GEMM over ragged per-expert storage
(port of ``mxmoe_tpu/ops/pallas_gmm.py:gmm_mixed_packed``) — kernels K4
(per-channel form) and K4f (flex form), ``csrc/gmm_mixed_packed.cu``.

``rhs_cat`` [R, N] int8 holds, per expert and in K/2-row units, ONE
nibble-packed unit (``pflags[e]`` = 1: signed 4-bit codes in the halves
layout of ``quant.packing.pack_int4_halves``) or TWO int8 units (a plain
[K, N] block); ``blk_offsets[e]`` is the expert's first unit.

Per-channel form (``lhs_scale`` [M, 1], ``rhs_scale`` [E, 1, N], no
``rhs_zp``): everything else is ``gmm_w8a8``'s contract, and the output is
bitwise that of ``gmm_w8a8`` on the int8-stored codes: the int32 sum is
exact and the epilogue is the same ``(acc * s_a) * s_b``, rounded once.
Its schedule is K2's (``int8_gmm_schedule`` with ``ragged``): above the
decode rows K2's wgmma body, whose producer reads each expert's flag and
first byte row, for K a multiple of 64.

Flex form (``lhs_scale`` [M, G], ``rhs_scale`` and the optional ``rhs_zp``
[E, G, N] with G > 1, or ``rhs_zp`` given): ``gmm_w8a8_grouped``'s contract,
arithmetic and schedule (``grouped_gmm_schedule``), groups of K / G codes in
ascending order, so the output is bitwise that of ``gmm_w8a8_grouped`` on
the int8-stored codes; above the decode rows, for K a multiple of 128,
K8's wgmma body B over the ragged storage. A group is a
range of k, wherever its codes lie: with K/2 no multiple of the group size
(K 1408, g 128) the middle group takes the end of the low nibbles and the
start of the high nibbles of a packed expert, or the end of the first and
the start of the second int8 unit.

The TPU grid's ``static_sizes`` / ``static_pflags`` / ``aligned`` /
``group_base`` have no counterpart (a layer's buffer is the view
``qcat[layer]``).
"""

from __future__ import annotations

import torch

from . import kernels
from ..quant.packing import unpack_int4_halves
from .gmm_w8a8 import (check_int8_gmm_operands, grouped_int8_plain,
                       int8_launch_schedule)
from .gmm_w8a8_grouped import grouped_launch_schedule, grouped_scale_plain


def _is_flex(lhs_scale, rhs_scale, rhs_zp) -> bool:
    return (rhs_zp is not None or lhs_scale.shape[-1] != 1
            or rhs_scale.shape[-2] != 1)


def gmm_mixed_packed_plain(lhs_q, lhs_scale, rhs_cat, rhs_scale, group_sizes,
                           pflags, blk_offsets, rhs_zp=None,
                           out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K4 and K4f: unpacks each routed expert's block
    and takes the exact grouped product, per channel or per k-group (reads the
    metadata on the host)."""
    k = lhs_q.shape[1]
    k2 = k // 2
    pf, blk = pflags.tolist(), blk_offsets.tolist()

    def weight_of(e):
        r0 = blk[e] * k2
        if pf[e]:
            return unpack_int4_halves(rhs_cat[r0: r0 + k2])
        return rhs_cat[r0: r0 + 2 * k2]

    if _is_flex(lhs_scale, rhs_scale, rhs_zp):
        return grouped_scale_plain(lhs_q, lhs_scale, weight_of, rhs_scale,
                                   group_sizes, k // rhs_scale.shape[-2], rhs_zp,
                                   out_dtype)
    return grouped_int8_plain(lhs_q, lhs_scale, weight_of, rhs_scale,
                              group_sizes, out_dtype)


def gmm_mixed_packed(
    lhs_q: torch.Tensor,        # [M, K] int8 codes
    lhs_scale: torch.Tensor,    # [M, G] f32 (G = 1: per token)
    rhs_cat: torch.Tensor,      # [R, N] int8 ragged storage
    rhs_scale: torch.Tensor,    # [E, G, N] f32
    group_sizes: torch.Tensor,  # [E] int32
    pflags: torch.Tensor,       # [E] int32: 1 = nibble-packed expert
    blk_offsets: torch.Tensor,  # [E] int32 K/2-unit starts
    rhs_zp: torch.Tensor | None = None,   # [E, G, N] f32 (flex form)
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Mixed int8-stored / nibble-packed grouped matmul -> [M, N]."""
    if lhs_q.device.type == "cpu":
        return gmm_mixed_packed_plain(lhs_q, lhs_scale, rhs_cat, rhs_scale,
                                      group_sizes, pflags, blk_offsets, rhs_zp,
                                      out_dtype)
    req = kernels.require
    m, k = lhs_q.shape
    e, g, n = rhs_scale.shape
    flex = _is_flex(lhs_scale, rhs_scale, rhs_zp)
    name = "gmm_mixed_packed_flex" if flex else "gmm_mixed_packed"
    extra = (pflags, blk_offsets) + (() if rhs_zp is None else (rhs_zp,))
    check_int8_gmm_operands(name, lhs_q, lhs_scale, rhs_cat, rhs_scale,
                            group_sizes, out_dtype, extra=extra, groups=g)
    req(k % 32 == 0, f"{name}: K={k} must be a multiple of 32")
    req(rhs_cat.dim() == 2 and rhs_cat.shape[1] == n
        and rhs_cat.shape[0] % (k // 2) == 0,
        f"{name}: rhs_cat {tuple(rhs_cat.shape)} for K={k}, N={n}")
    req(pflags.dtype == torch.int32 and blk_offsets.dtype == torch.int32
        and pflags.shape == (e,) and blk_offsets.shape == (e,),
        f"{name}: pflags / blk_offsets must be int32 [E]")
    out = torch.empty((m, n), dtype=out_dtype, device=lhs_q.device)
    if flex:
        gsize = kernels.group_size(k, k // g, name)
        req(gsize == k or gsize % 64 == 0,
            f"{name}: the group size {gsize} must be K or a multiple of the "
            "64-code k-tile (128 for the g128 schemes)")
        req(rhs_zp is None or (rhs_zp.shape == rhs_scale.shape
                               and rhs_zp.dtype == torch.float32),
            f"{name}: rhs_zp must be float32 of rhs_scale's shape")
        sched, _ws = grouped_launch_schedule(lhs_q, rhs_cat, n, e, gsize, wgmma=True,
                                             mixed=True)
        err = kernels.lib().mxmoe_gmm_mixed_packed_flex(
            lhs_q.data_ptr(), lhs_scale.data_ptr(), rhs_cat.data_ptr(),
            rhs_scale.data_ptr(), None if rhs_zp is None else rhs_zp.data_ptr(),
            group_sizes.data_ptr(), pflags.data_ptr(), blk_offsets.data_ptr(),
            out.data_ptr(), int(out_dtype == torch.bfloat16), m, k, n, e,
            rhs_cat.shape[0], gsize, *sched, kernels.stream_ptr(lhs_q.device))
    else:
        sched, _ws = int8_launch_schedule(lhs_q, rhs_cat, n, e, wgmma=True,
                                          ragged=True)
        err = kernels.lib().mxmoe_gmm_mixed_packed(
            lhs_q.data_ptr(), lhs_scale.data_ptr(), rhs_cat.data_ptr(),
            rhs_scale.data_ptr(), group_sizes.data_ptr(), pflags.data_ptr(),
            blk_offsets.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.bfloat16), m, k, n, e, rhs_cat.shape[0], *sched,
            kernels.stream_ptr(lhs_q.device))
    kernels.check(err, name)
    kernels.launches[name] += 1
    return out
