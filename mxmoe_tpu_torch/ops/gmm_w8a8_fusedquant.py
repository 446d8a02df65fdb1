"""int8 grouped GEMM with the per-token activation quant inside the launch
(port of ``mxmoe_tpu/ops/pallas_gmm.py:gmm_w8a8_fusedquant``) — kernel K14,
``csrc/gmm_w8a8_fusedquant.cu``.

Per row r of expert e (``lhs`` bf16 / f32, unquantized):

  scale[r] = max(amax(|lhs[r]|), 1e-8) / upper      upper = 2^(a_bits-1) - 1
  q[r]     = round(lhs[r] / scale[r])               (int8, half to even)
  out[r]   = ((float(q[r] @ rhs_q[e]) * scale[r]) * rhs_scale[e]) -> out dtype

which is ``act_quant.quantize_rows_uniform`` (K1) followed by ``gmm_w8a8``
(K2), bit for bit: the scale is a true division by ``upper``, as K1's. The
JAX kernel divides by the Python constant ``a_upper`` inside its traced
body, and in interpret mode on the CPU XLA turns that into a multiply by
``f32(1 / upper)``: its scales sit one ulp from K1's on some rows (its own
test holds it to ``quantize_act_per_token + gmm_w8a8`` within 1e-5 only;
``tests/test_torch_gmm_ws.py`` pins that reading bitwise). The port keeps
K1's.

Two bodies, chosen by ``fusedquant_schedule`` from the shapes (no sync):
at decode rows K2's m16 ring body and schedule, whose blocks take their
rows' amax first and quantize each k-tile into its A stage; above them one
cooperative launch that quantizes every row once into a workspace, meets at
a grid barrier and runs the wgmma body of K2's large M over the codes
(``csrc/gmm_w8a8_fusedquant.cu``). Outside the bodies' domain (N no
multiple of 16, weights not 16-byte aligned) the wrapper runs K1 + K2, the
same function in two launches.

Rows past ``sum(group_sizes)`` stay unwritten by the kernel and zero in the
plain version. Only tests call this in both packages (no serving branch
reaches it).
"""

from __future__ import annotations

import torch

from . import kernels
from ..quant.qparams import quantize_act_per_row_bits
from .act_quant import quantize_rows_uniform
from .gmm_w8a8 import (DECODE_M, Int8GemmSchedule, gmm_w8a8, grouped_int8_plain,
                       int8_gmm_schedule, schedule_args, wgmma_domain)


def fusedquant_schedule(m: int, k: int, n: int, e: int,
                        aligned: bool = True) -> Int8GemmSchedule | None:
    """K14's body for these shapes, or None for K1 + K2: K2's decode
    schedule at decode rows (M <= ``DECODE_M``), the wgmma body (bm 128)
    above them where ``wgmma_domain`` takes the shapes. ``aligned``: the
    weights are 16-byte aligned."""
    if m <= DECODE_M:
        return int8_gmm_schedule(m, k, n, e) if n % 16 == 0 and aligned else None
    return int8_gmm_schedule(m, k, n, e, wgmma=True) \
        if wgmma_domain(m, k, n, False, aligned) else None


def gmm_w8a8_fusedquant_plain(lhs, rhs_q, rhs_scale, group_sizes, a_bits=8,
                              out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K14: K1's quant, then K2's exact product."""
    bits = torch.full((lhs.shape[0],), float(a_bits), device=lhs.device)
    q, scale = quantize_act_per_row_bits(lhs, bits)
    return grouped_int8_plain(q, scale, lambda e: rhs_q[e], rhs_scale,
                              group_sizes, out_dtype)


def gmm_w8a8_fusedquant(
    lhs: torch.Tensor,          # [M, K] bf16 / f32 activations (unquantized)
    rhs_q: torch.Tensor,        # [E, K, N] int8 codes (sym per-channel)
    rhs_scale: torch.Tensor,    # [E, 1, N] f32
    group_sizes: torch.Tensor,  # [E] int32
    a_bits: int = 8,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """int8 grouped matmul with in-kernel per-token activation quant."""
    if lhs.device.type == "cpu":
        return gmm_w8a8_fusedquant_plain(lhs, rhs_q, rhs_scale, group_sizes,
                                         a_bits, out_dtype)
    req = kernels.require
    m, k = lhs.shape
    e, _, n = rhs_q.shape
    req(all(t.is_cuda and t.device == lhs.device and t.is_contiguous()
            for t in (lhs, rhs_q, rhs_scale, group_sizes)),
        "gmm_w8a8_fusedquant: operands must be contiguous tensors on one CUDA device")
    req(lhs.dtype in (torch.bfloat16, torch.float32),
        f"gmm_w8a8_fusedquant: lhs dtype {lhs.dtype} (bf16 / f32)")
    req(rhs_q.dtype == torch.int8 and rhs_q.shape == (e, k, n),
        f"gmm_w8a8_fusedquant: rhs {tuple(rhs_q.shape)} {rhs_q.dtype} for K={k}")
    req(rhs_scale.dtype == torch.float32 and rhs_scale.shape == (e, 1, n),
        "gmm_w8a8_fusedquant: rhs_scale must be float32 [E, 1, N]")
    req(group_sizes.dtype == torch.int32 and group_sizes.shape == (e,),
        "gmm_w8a8_fusedquant: group_sizes must be int32 [E]")
    req(2 <= a_bits <= 8, f"gmm_w8a8_fusedquant: a_bits={a_bits}")
    req(k % 16 == 0 and n % 4 == 0, f"gmm_w8a8_fusedquant: K={k} % 16, N={n} % 4")
    req(lhs.data_ptr() % 16 == 0 and rhs_q.data_ptr() % 4 == 0,
        "gmm_w8a8_fusedquant: misaligned operand")
    req(e <= 1024, "gmm_w8a8_fusedquant: at most 1024 experts")
    req(out_dtype in (torch.bfloat16, torch.float32),
        f"gmm_w8a8_fusedquant: out dtype {out_dtype}")
    dev = lhs.device
    sched = fusedquant_schedule(m, k, n, e, aligned=rhs_q.data_ptr() % 16 == 0)
    if sched is None:
        aq, asc = quantize_rows_uniform(lhs, a_bits)
        return gmm_w8a8(aq, asc, rhs_q, rhs_scale, group_sizes, out_dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    args, _ws = schedule_args(sched, dev)
    q_ws = s_ws = bar = None
    if sched.bm != 16:
        q_ws = torch.empty((m, k), dtype=torch.int8, device=dev)
        s_ws = torch.empty((m,), dtype=torch.float32, device=dev)
        bar = kernels.grid_barrier(dev)
    err = kernels.lib().mxmoe_gmm_w8a8_fusedquant(
        lhs.data_ptr(), int(lhs.dtype == torch.bfloat16), rhs_q.data_ptr(),
        rhs_scale.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16), float((1 << (a_bits - 1)) - 1),
        m, k, n, e, *args,
        *(None if t is None else t.data_ptr() for t in (q_ws, s_ws, bar)),
        kernels.stream_ptr(dev))
    kernels.check(err, "gmm_w8a8_fusedquant")
    kernels.launches["gmm_w8a8_fusedquant"] += 1
    return out
