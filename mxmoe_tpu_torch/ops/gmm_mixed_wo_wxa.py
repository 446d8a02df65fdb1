"""One launch mixing weight-only (a16) and w x a experts (port of
``mxmoe_tpu/ops/pallas_gmm.py:gmm_mixed_wo_wxa``, both bodies) — kernel K10,
``csrc/gmm_mixed_wo_wxa.cu``.

``scheme_flags`` [E] says per expert which product its rows take, on the
same int8-stored codes ``rhs_q`` [E, K, N] with ``rhs_scale`` and the optional
``rhs_zp`` [E, G, N] f32 (G = 1: per channel; G > 1: per k-group of K / G):

  flag 1 (weight-only): ``gmm_weight_only``'s product of the float rows
    ``lhs`` with ``(float(q) * scale + zp) -> lhs dtype``, f32 accumulation;
  flag 0 (w x a): ``gmm_w8a8_grouped``'s product of the int8 rows ``lhs_q``
    with scales ``lhs_scale`` [M, G], groups ascending, the zero-point
    row-sum term with ``rhs_zp``. With G = 1 and no ``rhs_zp`` that is
    ``gmm_w8a8``'s ``(acc * s_a) * s_b``.

Both activation operands are passed for every row; a flag-1 row's int8 codes
and a flag-0 row's float values are never read (the reference computes and
ignores them too). On a card flag-0 rows agree bitwise with K8 (K2 when per
channel) and flag-1 rows bitwise with K6 on the same operands: the kernel
runs those kernels' bodies, both on the grid and split count of
``gmm_w8a8_grouped.weight_only_gmm_schedule`` (K6's and K7's too): above
the decode rows, inside the wgmma domain, one persistent launch whose items
are K6's wgmma body A (flag 1) or K8's body B (flag 0); elsewhere the
32 x 128 tiles above the decode rows, m16 x 64 tiles at decode M. Against
the plain version flag-1 rows agree within K6's accumulation bound
(``gmm_weight_only.accumulation_bound``).

The TPU grid's ``bm`` / ``bn`` / ``static_sizes`` / ``group_base`` have no
counterpart.
"""

from __future__ import annotations

import torch

from . import kernels
from .gmm_w8a8 import check_int8_gmm_operands
from .gmm_w8a8_grouped import grouped_rows_plain, weight_only_launch_schedule
from .gmm_weight_only import dequantize_expert


def gmm_mixed_wo_wxa_plain(lhs, lhs_q, lhs_scale, rhs_q, rhs_scale, scheme_flags,
                           group_sizes, rhs_zp=None, out_dtype=torch.bfloat16,
                           acc_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of K10 (reads ``group_sizes`` and the flags on
    the host). ``acc_dtype=torch.float64`` gives the reference that the
    weight-only rows' accumulation bound is stated against."""
    m, k = lhs.shape
    e, g, n = rhs_scale.shape
    gsize = k // g
    out = torch.zeros((m, n), dtype=out_dtype, device=lhs.device)
    flags = scheme_flags.tolist()
    start = 0
    for ei, size in enumerate(group_sizes.tolist()):
        end = min(start + size, m)
        if end > start:
            zp = None if rhs_zp is None else rhs_zp[ei]
            if flags[ei]:
                w = dequantize_expert(
                    rhs_q[ei], rhs_scale[ei],
                    torch.zeros_like(rhs_scale[ei]) if zp is None else zp,
                    gsize, lhs.dtype)
                res = lhs[start:end].to(acc_dtype) @ w.to(acc_dtype)
            else:
                res = grouped_rows_plain(lhs_q[start:end], rhs_q[ei],
                                         lhs_scale[start:end], rhs_scale[ei], zp,
                                         gsize)
            out[start:end] = res.to(out_dtype)
        start += size
    return out


def gmm_mixed_wo_wxa(
    lhs: torch.Tensor,          # [M, K] bf16 rows (any float dtype on the CPU)
    lhs_q: torch.Tensor,        # [M, K] int8 codes of the same rows
    lhs_scale: torch.Tensor,    # [M, G] f32
    rhs_q: torch.Tensor,        # [E, K, N] int8 codes (signed storage)
    rhs_scale: torch.Tensor,    # [E, G, N] f32
    scheme_flags: torch.Tensor,  # [E] int32: 1 = weight-only, 0 = w x a
    group_sizes: torch.Tensor,  # [E] int32, on the tensors' device
    rhs_zp: torch.Tensor | None = None,   # [E, G, N] f32
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Weight-only and w x a experts in one grouped matmul -> [M, N]."""
    if lhs.device.type == "cpu":
        return gmm_mixed_wo_wxa_plain(lhs, lhs_q, lhs_scale, rhs_q, rhs_scale,
                                      scheme_flags, group_sizes, rhs_zp,
                                      out_dtype)
    req = kernels.require
    name = "gmm_mixed_wo_wxa"
    m, k = lhs_q.shape
    e, g, n = rhs_scale.shape
    extra = (lhs, scheme_flags) + (() if rhs_zp is None else (rhs_zp,))
    check_int8_gmm_operands(name, lhs_q, lhs_scale, rhs_q, rhs_scale, group_sizes,
                            out_dtype, extra=extra, groups=g)
    gsize = kernels.group_size(k, k // g, name)
    req(lhs.shape == (m, k) and lhs.dtype == torch.bfloat16,
        f"{name}: lhs must be bf16 {(m, k)}, got {lhs.dtype} {tuple(lhs.shape)}")
    req(rhs_q.shape == (e, k, n), f"{name}: rhs {tuple(rhs_q.shape)} for K={k}")
    req(gsize == k or gsize % 64 == 0,
        f"{name}: the group size {gsize} must be K or a multiple of the 64-code "
        "k-tile (128 for the g128 schemes)")
    req(scheme_flags.dtype == torch.int32 and scheme_flags.shape == (e,),
        f"{name}: scheme_flags must be int32 [E]")
    req(rhs_zp is None or (rhs_zp.shape == rhs_scale.shape
                           and rhs_zp.dtype == torch.float32),
        f"{name}: rhs_zp must be float32 of rhs_scale's shape")
    out = torch.empty((m, n), dtype=out_dtype, device=lhs.device)
    sched, _ws = weight_only_launch_schedule(lhs, rhs_q, n, e, gsize)
    err = kernels.lib().mxmoe_gmm_mixed_wo_wxa(
        lhs.data_ptr(), lhs_q.data_ptr(), lhs_scale.data_ptr(), rhs_q.data_ptr(),
        rhs_scale.data_ptr(), None if rhs_zp is None else rhs_zp.data_ptr(),
        scheme_flags.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16), m, k, n, e, gsize, *sched,
        kernels.stream_ptr(lhs.device))
    kernels.check(err, name)
    kernels.launches[name] += 1
    return out
