"""Weight-only (a16) grouped GEMM: float activations x integer-coded weights
dequantized on the fly (port of ``mxmoe_tpu/ops/pallas_gmm.py:
gmm_weight_only``) — kernel K6, ``csrc/gmm_weight_only.cu``.

``rhs_q`` [E, K, N] int8 holds w1..w8 codes in signed storage, ``rhs_scale``
and ``rhs_zp`` [E, K/gsize, N] f32 (zp zeros when symmetric). Per row r of
expert e:

  w[e]   = (float(q[e]) * scale[e, k // gsize] + zp[e, k // gsize]) -> lhs dtype
  out[r] = (lhs[r] @ w[e], accumulated in f32) -> out dtype

The dequantization's multiply and add round separately; the weights round
once to the activations' dtype (bf16 on the serving path) before the
product. The kernel sums K in another order than the plain version, so the
two agree within f32 accumulation error plus one ulp of the output dtype,
not bitwise (``accumulation_bound``). E = 1 is the dense product of a
weight-only shared expert.
"""

from __future__ import annotations

import torch

from . import kernels


def dequantize_expert(q_kn, scale_gn, zp_gn, gsize: int, dtype) -> torch.Tensor:
    """One expert's codes [K, N] + [K/gsize, N] scale and zp -> [K, N] weights
    of ``dtype``: ``q * scale + zp`` in f32 (two roundings), then one cast."""
    k, n = q_kn.shape
    w = (q_kn.float().reshape(k // gsize, gsize, n) * scale_gn[:, None, :]
         + zp_gn[:, None, :])
    return w.reshape(k, n).to(dtype)


def grouped_weight_only_plain(lhs, weight_of, n, group_sizes, out_dtype,
                              acc_dtype) -> torch.Tensor:
    """The plain grouped product shared by K6's and K7's plain versions:
    ``weight_of(e)`` gives expert e's dequantized [K, N] weights in the
    activations' dtype; the product accumulates in ``acc_dtype``. Reads
    ``group_sizes`` on the host: a reference, not the serving path."""
    m = lhs.shape[0]
    out = torch.zeros((m, n), dtype=out_dtype, device=lhs.device)
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = min(start + size, m)
        if end > start:
            res = lhs[start:end].to(acc_dtype) @ weight_of(e).to(acc_dtype)
            out[start:end] = res.to(out_dtype)
        start += size
    return out


def gmm_weight_only_plain(lhs, rhs_q, rhs_scale, rhs_zp, group_sizes, gsize,
                          out_dtype=torch.bfloat16,
                          acc_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of K6. ``acc_dtype=torch.float64`` gives the
    reference the kernel's accumulation bound is stated against."""
    gsize = kernels.group_size(lhs.shape[1], gsize, "gmm_weight_only")
    return grouped_weight_only_plain(
        lhs, lambda e: dequantize_expert(rhs_q[e], rhs_scale[e], rhs_zp[e], gsize,
                                         lhs.dtype),
        rhs_q.shape[-1], group_sizes, out_dtype, acc_dtype)


def accumulation_bound(lhs, weight_of, n, group_sizes) -> torch.Tensor:
    """Per-element bound [M, N] on |f32-accumulated product - exact product|
    for a K-term sum in any order: ``K * 2^-24 * sum_k |lhs[r,k]| |w[k,n]|``
    (each of the K - 1 additions rounds to within 2^-24 of a partial sum that
    the absolute sum bounds; bf16 x bf16 products are exact in f32)."""
    k = lhs.shape[1]
    mag = grouped_weight_only_plain(lhs.abs(), lambda e: weight_of(e).abs(), n,
                                    group_sizes, torch.float64, torch.float64)
    return mag * (k * 2.0 ** -24)


def error_over_bound(got, lhs, rhs_q, rhs_scale, rhs_zp, group_sizes, gsize):
    """How a K6 / K7 output stands against its gate -> (max |got - exact|,
    max of |got - exact| / tolerance); the gate holds when the second is at
    most 1. ``exact`` is the float64 product of the weights dequantized to
    the activations' dtype with the given scale and zp; the tolerance is
    ``accumulation_bound`` plus, for a bf16 output, one bf16 ulp of the exact
    element (the output rounds once)."""
    gsz = kernels.group_size(lhs.shape[1], gsize, "gmm_weight_only")
    n = rhs_q.shape[-1]

    def weight_of(e):
        return dequantize_expert(rhs_q[e], rhs_scale[e], rhs_zp[e], gsz, lhs.dtype)

    exact = grouped_weight_only_plain(lhs, weight_of, n, group_sizes,
                                      torch.float64, torch.float64)
    tol = accumulation_bound(lhs, weight_of, n, group_sizes)
    if got.dtype == torch.bfloat16:
        tol = tol + torch.exp2(torch.floor(torch.log2(
            exact.abs().clamp_min(2.0 ** -126))) - 7)
    err = (got.double() - exact).abs()
    rows = int(group_sizes.sum())
    ratio = (err / tol.clamp_min(1e-300))[:rows]
    return err[:rows].max().item(), ratio.max().item()


def check_weight_only_operands(name, lhs, rhs, rhs_scale, rhs_zp, group_sizes,
                               gsize, out_dtype) -> None:
    """Argument checks shared by K6 and K7; ``rhs`` is the code storage,
    whose shape each wrapper checks itself."""
    req = kernels.require
    m, k = lhs.shape
    e, g, n = rhs_scale.shape
    dev = lhs.device
    req(all(t.is_cuda and t.device == dev and t.is_contiguous()
            for t in (lhs, rhs, rhs_scale, rhs_zp, group_sizes)),
        f"{name}: operands must be contiguous tensors on one CUDA device")
    req(lhs.dtype == torch.bfloat16, f"{name}: lhs dtype {lhs.dtype} (bf16 only)")
    req(rhs.dtype == torch.int8, f"{name}: codes must be int8")
    req(rhs_scale.dtype == torch.float32 and rhs_zp.dtype == torch.float32
        and rhs_zp.shape == rhs_scale.shape,
        f"{name}: scale and zp must be float32 of one shape")
    req(group_sizes.dtype == torch.int32 and group_sizes.shape == (e,),
        f"{name}: group_sizes must be int32 [E]")
    req(k % 16 == 0 and n % 4 == 0, f"{name}: K={k} % 16, N={n} % 4")
    req(gsize % 4 == 0 and g == k // gsize,
        f"{name}: scale {tuple(rhs_scale.shape)} for K={k}, gsize={gsize} "
        "(a multiple of 4)")
    req(lhs.data_ptr() % 16 == 0 and rhs.data_ptr() % 4 == 0
        and rhs_scale.data_ptr() % 16 == 0 and rhs_zp.data_ptr() % 16 == 0,
        f"{name}: misaligned operand")
    req(e <= 1024, f"{name}: at most 1024 experts")
    req(out_dtype in (torch.bfloat16, torch.float32),
        f"{name}: out dtype {out_dtype}")


def gmm_weight_only(
    lhs: torch.Tensor,          # [M, K] bf16 (any float dtype on the CPU)
    rhs_q: torch.Tensor,        # [E, K, N] int8 codes (signed storage)
    rhs_scale: torch.Tensor,    # [E, K/gsize, N] f32
    rhs_zp: torch.Tensor,       # [E, K/gsize, N] f32 (zeros when symmetric)
    group_sizes: torch.Tensor,  # [E] int32, on the tensors' device
    gsize: int,                 # -1: one group, all of K
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Weight-only quantized grouped matmul (sym or asym, any gsize) -> [M, N]."""
    if lhs.device.type == "cpu":
        return gmm_weight_only_plain(lhs, rhs_q, rhs_scale, rhs_zp, group_sizes,
                                     gsize, out_dtype)
    m, k = lhs.shape
    e, _, n = rhs_q.shape
    gsize = kernels.group_size(k, gsize, "gmm_weight_only")
    check_weight_only_operands("gmm_weight_only", lhs, rhs_q, rhs_scale, rhs_zp,
                               group_sizes, gsize, out_dtype)
    kernels.require(rhs_q.shape == (e, k, n) and rhs_scale.shape[0] == e
                    and rhs_scale.shape[-1] == n,
                    f"gmm_weight_only: rhs {tuple(rhs_q.shape)} for K={k}")
    out = torch.empty((m, n), dtype=out_dtype, device=lhs.device)
    err = kernels.lib().mxmoe_gmm_weight_only(
        lhs.data_ptr(), rhs_q.data_ptr(), rhs_scale.data_ptr(), rhs_zp.data_ptr(),
        group_sizes.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16),
        m, k, n, e, gsize, kernels.stream_ptr(lhs.device))
    kernels.check(err, "gmm_weight_only")
    kernels.launches["gmm_weight_only"] += 1
    return out
