"""int8 x int8 grouped GEMM with per-channel asymmetric weights (port of
``mxmoe_tpu/ops/pallas_gmm.py:gmm_w8a8_asym``) — kernel K9,
``csrc/gmm_w8a8_asym.cu``.

Asymmetric codes are stored re-centred (``quant.packing``: ``w = q * s_w +
zp`` with signed ``q``), so per row r of expert e

  out[r] = (float(a[r] @ q[e]) * s_a[r]) * s_w[e]
         + (float(sum_k a[r, k]) * s_a[r]) * zp[e]        -> out dtype

Both integer sums are exact and every f32 product and the sum round on
their own in kernel and plain version alike, so the two agree bitwise.
Everything else is ``gmm_w8a8``'s contract. The schedule is
``asym_gmm_schedule``'s: above the decode rows K8's wgmma body B with one
group and the zero points, whose fold is this one.
"""

from __future__ import annotations

import torch

from . import kernels
from .gmm_w8a8 import (check_int8_gmm_operands, exact_int8_matmul, int8_gmm_schedule,
                       schedule_args)
from .gmm_w8a8_grouped import grouped_gmm_schedule, grouped_wgmma_domain


def asym_gmm_schedule(m: int, k: int, n: int, e: int, aligned: bool = True):
    """K9's schedule: K8's wgmma body B with one group (``gsize = K``)
    inside ``grouped_wgmma_domain``, from ``GROUPED_WGMMA_MIN_M`` rows on;
    ``int8_gmm_schedule``'s m16 decode tile (row sums in registers) and
    64 x 128 tile elsewhere."""
    if grouped_wgmma_domain(m, k, n, k, aligned):
        return grouped_gmm_schedule(m, k, n, e, k, aligned, wgmma=True)
    return int8_gmm_schedule(m, k, n, e, aligned=aligned)


def gmm_w8a8_asym_plain(lhs_q, lhs_scale, rhs_q, rhs_scale, rhs_zp, group_sizes,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K9 (exact sums, ``exact_int8_matmul``;
    reads ``group_sizes`` on the host)."""
    m, n = lhs_q.shape[0], rhs_scale.shape[-1]
    out = torch.zeros((m, n), dtype=out_dtype, device=lhs_q.device)
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = min(start + size, m)
        if end > start:
            a = lhs_q[start:end]
            acc = exact_int8_matmul(a, rhs_q[e]).float()
            rsum = a.to(torch.int32).sum(-1, keepdim=True).float()
            sa = lhs_scale[start:end]
            res = acc * sa * rhs_scale[e] + rsum * sa * rhs_zp[e]
            out[start:end] = res.to(out_dtype)
        start += size
    return out


def gmm_w8a8_asym(
    lhs_q: torch.Tensor,        # [M, K] int8 codes (symmetric activations)
    lhs_scale: torch.Tensor,    # [M, 1] f32 per-token scale
    rhs_q: torch.Tensor,        # [E, K, N] int8 re-centred asymmetric codes
    rhs_scale: torch.Tensor,    # [E, 1, N] f32 per-channel scale
    rhs_zp: torch.Tensor,       # [E, 1, N] f32 re-centred zero points
    group_sizes: torch.Tensor,  # [E] int32, on the tensors' device
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Per-channel asymmetric-weight int8 grouped matmul -> [M, N]."""
    if lhs_q.device.type == "cpu":
        return gmm_w8a8_asym_plain(lhs_q, lhs_scale, rhs_q, rhs_scale, rhs_zp,
                                   group_sizes, out_dtype)
    m, k = lhs_q.shape
    e, _, n = rhs_q.shape
    check_int8_gmm_operands("gmm_w8a8_asym", lhs_q, lhs_scale, rhs_q, rhs_scale,
                            group_sizes, out_dtype, extra=(rhs_zp,))
    kernels.require(rhs_q.shape == (e, k, n) and rhs_scale.shape[0] == e,
                    f"gmm_w8a8_asym: rhs {tuple(rhs_q.shape)} for K={k}")
    kernels.require(rhs_zp.shape == (e, 1, n) and rhs_zp.dtype == torch.float32,
                    f"gmm_w8a8_asym: rhs_zp {tuple(rhs_zp.shape)} {rhs_zp.dtype} "
                    f"must be float32 [E, 1, N]")
    out = torch.empty((m, n), dtype=out_dtype, device=lhs_q.device)
    sched, _ws = schedule_args(
        asym_gmm_schedule(m, k, n, e, aligned=rhs_q.data_ptr() % 16 == 0), lhs_q.device)
    err = kernels.lib().mxmoe_gmm_w8a8_asym(
        lhs_q.data_ptr(), lhs_scale.data_ptr(), rhs_q.data_ptr(),
        rhs_scale.data_ptr(), rhs_zp.data_ptr(), group_sizes.data_ptr(),
        out.data_ptr(), int(out_dtype == torch.bfloat16), m, k, n, e, *sched,
        kernels.stream_ptr(lhs_q.device))
    kernels.check(err, "gmm_w8a8_asym")
    kernels.launches["gmm_w8a8_asym"] += 1
    return out
