"""One-launch mixed-precision grouped GEMM over ragged per-expert storage
(port of ``mxmoe_tpu/ops/pallas_gmm.py:gmm_mixed_packed``, per-channel
form) — kernel K4, ``csrc/gmm_mixed_packed.cu``.

``rhs_cat`` [R, N] int8 holds, per expert and in K/2-row units, ONE
nibble-packed unit (``pflags[e]`` = 1: signed 4-bit codes in the halves
layout of ``quant.packing.pack_int4_halves``) or TWO int8 units (a plain
[K, N] block); ``blk_offsets[e]`` is the expert's first unit. Everything
else is ``gmm_w8a8``'s contract, and the output is bitwise that of
``gmm_w8a8`` on the int8-stored codes: the int32 sum is exact and the
epilogue is the same ``(acc * s_a) * s_b``, rounded once.

Not ported: the flex form (``[M, G]`` / ``[E, G, N]`` scales with G > 1,
``rhs_zp``) raises; the TPU grid's ``static_sizes`` / ``static_pflags`` /
``aligned`` / ``group_base`` have no counterpart (a layer's buffer is the
view ``qcat[layer]``).
"""

from __future__ import annotations

import torch

from . import kernels
from ..quant.packing import unpack_int4_halves
from .gmm_w8a8 import check_int8_gmm_operands, grouped_int8_plain


def _reject_flex(lhs_scale, rhs_scale, rhs_zp) -> None:
    if rhs_zp is not None or lhs_scale.shape[-1] != 1 or rhs_scale.shape[-2] != 1:
        raise NotImplementedError(
            "gmm_mixed_packed: grouped scales / rhs_zp need the flex form of "
            "the kernel (ROADMAP queue B 3: gmm_mixed_packed flex form)")


def gmm_mixed_packed_plain(lhs_q, lhs_scale, rhs_cat, rhs_scale, group_sizes,
                           pflags, blk_offsets, rhs_zp=None,
                           out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K4: unpacks each routed expert's block and
    takes the exact grouped product (reads the metadata on the host)."""
    _reject_flex(lhs_scale, rhs_scale, rhs_zp)
    k2 = lhs_q.shape[1] // 2
    pf, blk = pflags.tolist(), blk_offsets.tolist()

    def weight_of(e):
        r0 = blk[e] * k2
        if pf[e]:
            return unpack_int4_halves(rhs_cat[r0: r0 + k2])
        return rhs_cat[r0: r0 + 2 * k2]

    return grouped_int8_plain(lhs_q, lhs_scale, weight_of, rhs_scale,
                              group_sizes, out_dtype)


def gmm_mixed_packed(
    lhs_q: torch.Tensor,        # [M, K] int8 codes
    lhs_scale: torch.Tensor,    # [M, 1] f32 per-token scale
    rhs_cat: torch.Tensor,      # [R, N] int8 ragged storage
    rhs_scale: torch.Tensor,    # [E, 1, N] f32 per-channel scale
    group_sizes: torch.Tensor,  # [E] int32
    pflags: torch.Tensor,       # [E] int32: 1 = nibble-packed expert
    blk_offsets: torch.Tensor,  # [E] int32 K/2-unit starts
    rhs_zp: torch.Tensor | None = None,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Mixed int8-stored / nibble-packed grouped matmul -> [M, N]."""
    _reject_flex(lhs_scale, rhs_scale, rhs_zp)
    if lhs_q.device.type == "cpu":
        return gmm_mixed_packed_plain(lhs_q, lhs_scale, rhs_cat, rhs_scale,
                                      group_sizes, pflags, blk_offsets,
                                      out_dtype=out_dtype)
    req = kernels.require
    m, k = lhs_q.shape
    e, n = rhs_scale.shape[0], rhs_scale.shape[-1]
    check_int8_gmm_operands("gmm_mixed_packed", lhs_q, lhs_scale, rhs_cat,
                            rhs_scale, group_sizes, out_dtype,
                            extra=(pflags, blk_offsets))
    req(k % 32 == 0, f"gmm_mixed_packed: K={k} must be a multiple of 32")
    req(rhs_cat.dim() == 2 and rhs_cat.shape[1] == n
        and rhs_cat.shape[0] % (k // 2) == 0,
        f"gmm_mixed_packed: rhs_cat {tuple(rhs_cat.shape)} for K={k}, N={n}")
    req(pflags.dtype == torch.int32 and blk_offsets.dtype == torch.int32
        and pflags.shape == (e,) and blk_offsets.shape == (e,),
        "gmm_mixed_packed: pflags / blk_offsets must be int32 [E]")
    out = torch.empty((m, n), dtype=out_dtype, device=lhs_q.device)
    err = kernels.lib().mxmoe_gmm_mixed_packed(
        lhs_q.data_ptr(), lhs_scale.data_ptr(), rhs_cat.data_ptr(),
        rhs_scale.data_ptr(), group_sizes.data_ptr(), pflags.data_ptr(),
        blk_offsets.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16), m, k, n, e,
        kernels.stream_ptr(lhs_q.device))
    kernels.check(err, "gmm_mixed_packed")
    kernels.launches["gmm_mixed_packed"] += 1
    return out
