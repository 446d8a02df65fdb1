"""Round-to-nearest (RTN) min-max quantization (port of
``mxmoe_tpu/quant/rtn.py``: ``quantize`` / ``dequantize``, the MSE clip
search and ``fake_quant*``).

Grouped along the last axis (gsize=-1 -> one group = whole row),
symmetric (signed codes, zero zp) or asymmetric (unsigned codes, zp =
group min), plus the 1.5-bit (ternary) and 1-bit widths. ``clip="mse"``
grid-searches the clip shrink per group (``_mse_search``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .schemes import QLinearConfig


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
    upper, lower, eff_sym = quant_ranges(bits, sym)
    # the scales must stay bitwise equal to the JAX pipeline's
    inv_upper = torch.tensor(1.0 / upper, dtype=torch.float32, device=t.device)

    def over_upper(x):
        # a tensor divisor: on a card, torch divides by a Python number as a
        # multiply by its reciprocal
        return x * inv_upper if scale_by_reciprocal else x / upper_t

    upper_t = torch.tensor(upper, dtype=torch.float32, device=t.device)

    tg = _group_reshape(t.float(), gsize)
    if isinstance(clip, str):
        if clip != "mse":
            raise ValueError(f"clip {clip!r}: a (lo, hi) pair or 'mse'")
        scale, zp = _mse_search(tg, upper, lower, eff_sym)
    elif eff_sym:
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


# MSE clip-search grid (the reference's ``Quantizer.find_params`` defaults:
# shrink p = 1 - i/100 for i < 80, error norm 2.4)
MSE_MAXSHRINK = 0.8
MSE_GRID = 100
MSE_NORM = 2.4


def _mse_search(tg: torch.Tensor, upper: float, lower: float, eff_sym: bool):
    """Per group of ``tg`` [..., G, g], the (scale, zp) of the clip shrink
    p = 1 - i/100, i < 80, that minimizes sum |W - Q(W)|^2.4 (the first
    minimum on ties) -> scale, zp [..., G].

    The reference runs the grid in one compiled loop, where XLA contracts
    ``1 - i * f32(0.01)`` and the asymmetric range ``p * max - p * min`` into
    fused multiply-adds and multiplies by ``f32(1 / upper)``; the two
    contractions are done here in float64 and rounded once, so the scales
    are the reference's bit for bit."""
    if eff_sym:
        gmax0 = tg.abs().amax(-1)
    else:
        gmin0, gmax0 = tg.amin(-1), tg.amax(-1)
    inv_upper = torch.tensor(1.0 / upper, dtype=torch.float32, device=tg.device)
    step = float(np.float32(1.0 / MSE_GRID))
    best = torch.full_like(gmax0, float("inf"))
    best_s = torch.zeros_like(gmax0)
    best_z = torch.zeros_like(gmax0)
    for i in range(int(MSE_MAXSHRINK * MSE_GRID)):
        p = torch.tensor(1.0 - i * step, dtype=torch.float32)
        if eff_sym:
            s = (p * gmax0) * inv_upper
            z = torch.zeros_like(s)
        else:
            z = p * gmin0
            s = (gmax0.double() * float(p) - z.double()).float() * inv_upper
        safe = torch.where(s == 0, torch.ones_like(s), s)
        codes = torch.round(torch.clamp((tg - z[..., None]) / safe[..., None],
                                        lower, upper))
        deq = (codes.double() * safe.double()[..., None]
               + z.double()[..., None]).float()
        err = ((deq - tg).abs() ** MSE_NORM).sum(-1)
        take = err < best
        best = torch.where(take, err, best)
        best_s = torch.where(take, s, best_s)
        best_z = torch.where(take, z, best_z)
    return best_s, best_z


def dequantize(codes: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor,
               gsize: int) -> torch.Tensor:
    """Inverse of :func:`quantize`: ``codes * scale + zp`` per group."""
    cg = _group_reshape(codes.float(), gsize)
    return (cg * scale[..., None] + zp[..., None]).reshape(codes.shape)


def fake_quant(t: torch.Tensor, bits: float, gsize: int, sym: bool,
               clip: "tuple[float, float] | str" = (1.0, 1.0),
               scale_by_reciprocal: bool = False) -> torch.Tensor:
    """Quantize-dequantize in one shot; the output keeps ``t``'s dtype. The
    reference runs it op by op (a true division: ``scale_by_reciprocal``
    off)."""
    if bits >= 16:
        return t
    q = quantize(t, bits, gsize, sym, clip, scale_by_reciprocal)
    return dequantize(q.codes, q.scale, q.zp, gsize).to(t.dtype)


def fake_quant_weight(t: torch.Tensor, cfg: QLinearConfig) -> torch.Tensor:
    return fake_quant(t, cfg.w_bits, cfg.w_gsize, cfg.w_sym, cfg.w_clip)


def fake_quant_act(t: torch.Tensor, cfg: QLinearConfig) -> torch.Tensor:
    """Per-token activation fake-quant (the reference's act-quant hook)."""
    return fake_quant(t, cfg.a_bits, cfg.a_gsize, cfg.a_sym, cfg.a_clip)
