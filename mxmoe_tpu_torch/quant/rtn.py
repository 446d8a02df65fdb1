"""Round-to-nearest (RTN) min-max quantization (port of
``mxmoe_tpu/quant/rtn.py``: ``quantize`` / ``dequantize``).

Grouped along the last axis (gsize=-1 -> one group = whole row),
symmetric (signed codes, zero zp) or asymmetric (unsigned codes, zp =
group min), plus the 1.5-bit (ternary) and 1-bit widths. The MSE clip
search (``w_clip="mse"``) comes with the calibration port (ROADMAP
queue A); it raises here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuantResult(NamedTuple):
    codes: torch.Tensor   # input shape, float32 integer code values
    scale: torch.Tensor   # (..., n_groups) float32
    zp: torch.Tensor      # (..., n_groups) float32 (0 for symmetric)


def _group_reshape(t: torch.Tensor, gsize: int) -> torch.Tensor:
    k = t.shape[-1]
    g = k if gsize == -1 else gsize
    if k % g != 0:
        raise ValueError(f"last dim {k} not divisible by gsize {g}")
    return t.reshape(*t.shape[:-1], k // g, g)


def quant_ranges(bits: float, sym: bool) -> tuple[float, float, bool]:
    """(upper, lower, effective_sym) for a bitwidth, incl. 1.5/1-bit."""
    if bits == 1.5:  # ternary
        return 1.0, -1.0, True
    if bits == 1:  # binary
        return 1.0, 0.0, False
    b = int(bits)
    if sym:
        upper = float((1 << (b - 1)) - 1)
        return upper, -upper, True
    return float((1 << b) - 1), 0.0, False


def quantize(t: torch.Tensor, bits: float, gsize: int, sym: bool,
             clip: "tuple[float, float] | str" = (1.0, 1.0),
             scale_by_reciprocal: bool = True) -> QuantResult:
    """Grouped min-max quantization along the last axis; returns integer
    codes (as float32) with ``dequant = codes * scale + zp`` per group.

    ``scale_by_reciprocal``: the scale is ``range * f32(1 / upper)`` (true)
    or the true division ``range / upper`` (false); the two differ by one
    ulp on about half the scales. The reference's uniform quantizer runs
    compiled, where the division by a constant becomes the multiply; its
    per-expert mixed quantizer runs op by op and divides."""
    if bits >= 16:
        g = t.shape[-1] if gsize == -1 else gsize
        ones = torch.ones((*t.shape[:-1], t.shape[-1] // g),
                          dtype=torch.float32, device=t.device)
        return QuantResult(t.float(), ones, torch.zeros_like(ones))
    if isinstance(clip, str):
        raise NotImplementedError(
            "MSE clip search is not ported yet (ROADMAP queue A: calibrate)")
    upper, lower, eff_sym = quant_ranges(bits, sym)
    # the scales must stay bitwise equal to the JAX pipeline's
    inv_upper = torch.tensor(1.0 / upper, dtype=torch.float32, device=t.device)

    def over_upper(x):
        return x * inv_upper if scale_by_reciprocal else x / upper

    tg = _group_reshape(t.float(), gsize)
    if eff_sym:
        scale = over_upper(tg.abs().amax(-1))
        zp = torch.zeros_like(scale)
    else:
        gmin = tg.amin(-1) * clip[0]
        gmax = tg.amax(-1) * clip[1]
        scale = over_upper(gmax - gmin)
        zp = gmin
    # all-zero groups dequantize to exactly zero
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = torch.round(torch.clamp((tg - zp[..., None]) / safe[..., None],
                                    lower, upper))
    return QuantResult(codes.reshape(t.shape), scale, zp)


def dequantize(codes: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor,
               gsize: int) -> torch.Tensor:
    """Inverse of :func:`quantize`: ``codes * scale + zp`` per group."""
    cg = _group_reshape(codes.float(), gsize)
    return (cg * scale[..., None] + zp[..., None]).reshape(codes.shape)
