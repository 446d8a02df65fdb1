"""Grouped (ragged) matmul front end for float operands (port of
``mxmoe_tpu/ops/gmm.py`` and of ``mxmoe_tpu/ops/pallas_gmm.py:gmm``, alias
``gmm_bf16``) — kernel K11, ``csrc/gmm_bf16.cu``.

``gmm(lhs, rhs, group_sizes)`` computes, for each expert g,
``out[rows_g] = lhs[rows_g] @ rhs[g]`` over contiguous, expert-sorted rows.
Backends, under the reference's names:

  'ragged_dot'  the stock grouped product. The reference takes XLA's
                ``ragged_dot``; here it is ``torch._grouped_mm`` on a card
                where the installed torch has it (torch 2.11 does, for bf16
                and f32 operands), else a masked product per expert (no
                host read of the sizes), and a loop over the experts on the
                CPU
  'dense'       the mask-and-sum oracle ``gmm_dense_reference``
  'pallas'      the hand-written kernel: K11 on a card (``gmm_bf16``), its
                plain version on the CPU. The name is kept so that a reader
                finds the counterpart; nothing of Pallas is involved

K11 (``gmm_bf16``): f32 accumulation over all of K and one rounding to
the output dtype. ``bf16_gmm_schedule`` names the body, which the operands'
type picks: bf16 operands go through the persistent ``wgmma`` body at every
row count (128 x 256 work items walked as ``gmm_ws.ws_device_work_items``
walks them, the weights read MN-major as they are stored); f32 operands are
multiplied and added in full f32 (an FMA loop outside the tensor cores),
which is what the reference computes in interpret mode; the tensor cores'
TF32 would drop 13 mantissa bits of each operand and is a different
function. Rows past ``sum(group_sizes)`` are left unwritten by the kernel
and zero in the plain version.
"""

from __future__ import annotations

import dataclasses

import torch

from . import kernels

# the tiles of K11's bodies: the wgmma body's work item (rows and columns,
# the walk of csrc/gmm_ws_body.cuh) and the f32 loop's block
WGMMA_BM, WGMMA_BN = 128, 256
F32_BM, F32_BN = 32, 128


@dataclasses.dataclass(frozen=True)
class Bf16GemmSchedule:
    """The body one K11 launch takes: ``"wgmma"`` (bf16 operands) or
    ``"f32"`` (the FMA loop), with its output tile ``bm`` x ``bn``."""
    body: str
    bm: int
    bn: int


def bf16_gmm_schedule(dtype=torch.bfloat16) -> Bf16GemmSchedule:
    """K11's body for operands of ``dtype``, at any shape."""
    if dtype == torch.float32:
        return Bf16GemmSchedule("f32", F32_BM, F32_BN)
    return Bf16GemmSchedule("wgmma", WGMMA_BM, WGMMA_BN)


def gmm_dense_reference(lhs: torch.Tensor, rhs: torch.Tensor,
                        group_sizes: torch.Tensor) -> torch.Tensor:
    """O(E)-compute oracle: mask-and-sum over experts, exact for any sizes.
    Reads nothing on the host."""
    m = lhs.shape[0]
    ends = torch.cumsum(group_sizes.long(), 0)
    starts = ends - group_sizes.long()
    row = torch.arange(m, device=lhs.device)[:, None]
    out = torch.zeros((m, rhs.shape[-1]),
                      dtype=torch.promote_types(lhs.dtype, rhs.dtype),
                      device=lhs.device)
    for g in range(rhs.shape[0]):
        mask = (row >= starts[g]) & (row < ends[g])
        out = out + (mask.to(lhs.dtype) * lhs) @ rhs[g]
    return out


def gmm_bf16_plain(lhs, rhs, group_sizes, out_dtype=None,
                   acc_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of K11: a loop over the experts with rows,
    accumulating in ``acc_dtype`` (``torch.float64`` gives the reference the
    kernel's bound is stated against). Reads ``group_sizes`` on the host."""
    m = lhs.shape[0]
    out_dtype = out_dtype or lhs.dtype
    out = torch.zeros((m, rhs.shape[-1]), dtype=out_dtype, device=lhs.device)
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = min(start + size, m)
        if end > start:
            res = lhs[start:end].to(acc_dtype) @ rhs[e].to(acc_dtype)
            out[start:end] = res.to(out_dtype)
        start += size
    return out


def error_over_bound(got, lhs, rhs, group_sizes):
    """How a K11 output stands against its gate -> (max |got - exact|, max of
    |got - exact| / tolerance); the gate holds when the second is at most 1.
    ``exact`` is the float64 product; the tolerance is ``K * 2^-24 *
    sum_k |lhs[r,k]| |rhs[e,k,n]|`` (f32 accumulation of K terms in any
    order; bf16 x bf16 products are exact in f32, f32 x f32 products round
    once more, within the same 2^-24 of the term) plus, for a bf16 output, one
    bf16 ulp of the exact element (the output rounds once)."""
    k = lhs.shape[1]
    exact = gmm_bf16_plain(lhs, rhs, group_sizes, torch.float64, torch.float64)
    mag = gmm_bf16_plain(lhs.abs(), rhs.abs(), group_sizes, torch.float64,
                         torch.float64)
    tol = mag * ((k + 1) * 2.0 ** -24)
    if got.dtype == torch.bfloat16:
        tol = tol + torch.exp2(torch.floor(torch.log2(
            exact.abs().clamp_min(2.0 ** -126))) - 7)
    err = (got.double() - exact).abs()
    rows = int(group_sizes.sum())
    ratio = (err / tol.clamp_min(1e-300))[:rows]
    return err[:rows].max().item(), ratio.max().item()


def gmm_bf16(
    lhs: torch.Tensor,          # [M, K] bf16 or f32, expert-sorted rows
    rhs: torch.Tensor,          # [E, K, N] of lhs's dtype
    group_sizes: torch.Tensor,  # [E] int32, on the tensors' device
    out_dtype=None,             # default: lhs's dtype
) -> torch.Tensor:
    """Grouped matmul of float operands -> [M, N] (K11 on a card)."""
    if lhs.device.type == "cpu":
        return gmm_bf16_plain(lhs, rhs, group_sizes, out_dtype)
    req = kernels.require
    m, k = lhs.shape
    e, _, n = rhs.shape
    out_dtype = out_dtype or lhs.dtype
    req(all(t.is_cuda and t.device == lhs.device and t.is_contiguous()
            for t in (lhs, rhs, group_sizes)),
        "gmm_bf16: operands must be contiguous tensors on one CUDA device")
    req(lhs.dtype in (torch.bfloat16, torch.float32) and rhs.dtype == lhs.dtype,
        f"gmm_bf16: operands {lhs.dtype} x {rhs.dtype} (both bf16 or both f32)")
    req(rhs.shape == (e, k, n), f"gmm_bf16: rhs {tuple(rhs.shape)} for K={k}")
    req(group_sizes.dtype == torch.int32 and group_sizes.shape == (e,),
        "gmm_bf16: group_sizes must be int32 [E]")
    req(k % 8 == 0 and n % 8 == 0, f"gmm_bf16: K={k} % 8, N={n} % 8")
    req(lhs.data_ptr() % 16 == 0 and rhs.data_ptr() % 16 == 0,
        "gmm_bf16: misaligned operand")
    req(e <= 1024, "gmm_bf16: at most 1024 experts")
    req(out_dtype in (torch.bfloat16, torch.float32),
        f"gmm_bf16: out dtype {out_dtype}")
    out = torch.empty((m, n), dtype=out_dtype, device=lhs.device)
    err = kernels.lib().mxmoe_gmm_bf16(
        lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
        int(lhs.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        m, k, n, e, kernels.stream_ptr(lhs.device))
    kernels.check(err, "gmm_bf16")
    kernels.launches["gmm_bf16"] += 1
    return out


def has_grouped_mm() -> bool:
    """Whether the installed torch carries the stock grouped product."""
    return hasattr(torch, "_grouped_mm")


def _ragged_dot(lhs, rhs, group_sizes, out_dtype) -> torch.Tensor:
    """The stock arm (no hand-written kernel)."""
    if lhs.device.type == "cpu":
        return gmm_bf16_plain(lhs, rhs, group_sizes, out_dtype)
    if (has_grouped_mm() and lhs.dtype == rhs.dtype
            and lhs.shape[1] % 8 == 0 and rhs.shape[-1] % 8 == 0):
        offs = torch.cumsum(group_sizes, 0).to(torch.int32)
        out = torch._grouped_mm(lhs, rhs, offs=offs)
        return out.to(out_dtype)
    return gmm_dense_reference(lhs, rhs, group_sizes).to(out_dtype)


def gmm(
    lhs: torch.Tensor,          # [M, K] expert-sorted rows
    rhs: torch.Tensor,          # [E, K, N]
    group_sizes: torch.Tensor,  # [E] int32
    backend: str = "ragged_dot",
    preferred_element_type=None,
) -> torch.Tensor:
    if backend == "ragged_dot":
        return _ragged_dot(lhs, rhs, group_sizes,
                           preferred_element_type or lhs.dtype)
    if backend == "dense":
        return gmm_dense_reference(lhs, rhs, group_sizes)
    if backend == "pallas":
        return gmm_bf16(lhs, rhs, group_sizes)
    raise ValueError(f"unknown gmm backend {backend!r}")
