"""Single-pass activation row quantization (port of
``mxmoe_tpu/ops/act_quant.py``) — kernel K1, ``csrc/act_quant.cu``.

Semantics are bitwise those of ``quant.qparams.quantize_act_per_row_bits``:
  upper = 2^(min(bits,8)-1) - 1;  scale = max(amax(|x*gain|), 1e-8)/upper
  q     = round(x*gain/scale)  (int8, round-half-even)

CPU tensors take the plain version; CUDA tensors launch K1 or raise. K1
takes any K (``csrc/act_quant.cu``): many rows of at most 8 KB take a warp
each, fewer or wider rows a block each, both with the row in registers; a K
that is no multiple of 8 (or above 32768) goes through single-element loads.
"""

from __future__ import annotations

import torch

from . import kernels
from ..quant.qparams import quantize_act_per_row_bits


def quantize_rows_plain(x: torch.Tensor, bits_per_row: torch.Tensor,
                        gain: float = 1.0):
    """Plain PyTorch version of K1 -> (int8 [M,K], f32 [M,1])."""
    return quantize_act_per_row_bits(x.float() * gain, bits_per_row)


def quantize_rows(x: torch.Tensor, bits_per_row: torch.Tensor,
                  gain: float = 1.0):
    """Per-row symmetric quant -> (int8 codes [M,K], f32 scales [M,1]).

    ``x`` [M, K] bf16/f32, ``bits_per_row`` [M] float (>=16 clips to 8),
    ``gain`` a scalar multiplied into x before quantization."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x, bits_per_row, gain)
    req = kernels.require
    req(x.is_cuda and x.dim() == 2 and x.is_contiguous(),
        "quantize_rows: x must be a contiguous 2-D CUDA tensor")
    req(x.dtype in (torch.bfloat16, torch.float32),
        f"quantize_rows: x dtype {x.dtype} (bf16/f32 only)")
    m, k = x.shape
    bits = bits_per_row.to(device=x.device, dtype=torch.float32).contiguous()
    req(bits.shape == (m,), "quantize_rows: bits_per_row must be [M]")
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    err = kernels.lib().mxmoe_quantize_rows(
        x.data_ptr(), int(x.dtype == torch.bfloat16), bits.data_ptr(),
        float(gain), q.data_ptr(), scale.data_ptr(), m, k,
        kernels.stream_ptr(x.device))
    kernels.check(err, "quantize_rows")
    kernels.launches["quantize_rows"] += 1
    return q, scale


def quantize_rows_uniform(x: torch.Tensor, bits: int = 8, gain: float = 1.0):
    """Uniform-bitwidth wrapper (per-token dynamic quant)."""
    bits_row = torch.full((x.shape[0],), float(bits), dtype=torch.float32,
                          device=x.device)
    return quantize_rows(x, bits_row, gain=gain)
