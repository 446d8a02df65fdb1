"""Integer storage for quantized weights (port of
``mxmoe_tpu/quant/packing.py``: signed int8 storage, the nibble-packed
halves layout and the ragged mixed buffer).

Weights are stored [.., K, N] with scales/zp [.., K//g, N]. Asymmetric
codes are re-centred to signed storage, q' = q - 2^(b-1) with
zp' = zp + 2^(b-1) * scale, so ``dequant = q' * scale + zp'`` holds
exactly. ``shard_ragged_mixed`` (per-shard buffers for expert parallelism)
comes with the EP port (ROADMAP queue A).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .rtn import quantize
from .schemes import QLinearConfig


class PackedTensor(NamedTuple):
    values: torch.Tensor  # int8 codes
    scale: torch.Tensor   # float32
    zp: torch.Tensor      # float32 (zeros when symmetric)
    bits: int
    gsize: int
    sym: bool


def pack_int4_halves(codes_i8: torch.Tensor) -> torch.Tensor:
    """Pack signed 4-bit codes [..., K, N] -> int8 [..., K//2, N] with the
    *halves* layout: low nibble = k, high nibble = k + K/2 (the layout the
    packed kernels consume: unpacking is a contiguous concat along K)."""
    k = codes_i8.shape[-2]
    lo = codes_i8[..., : k // 2, :].to(torch.int32) & 0xF
    hi = codes_i8[..., k // 2:, :].to(torch.int32) & 0xF
    # the byte pattern lo | hi << 4, stored as its two's-complement int8
    return (((lo | (hi << 4)) ^ 0x80) - 0x80).to(torch.int8)


def unpack_int4_halves(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4_halves`."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    return torch.cat([lo, hi], dim=-2).to(torch.int8)


def build_ragged_mixed(codes_i8: torch.Tensor, pflags):
    """Stacked int8 codes [E, K, N] + per-expert packed flags -> the ragged
    mixed weight buffer consumed by ``ops.gmm_mixed_packed``.

    Experts with ``pflags[e]`` true must hold int4-range codes; they are
    nibble-packed (halves layout) into ONE K/2-row unit. int8 experts span
    TWO K/2-row units (their upper/lower K halves). Returns
    (rhs_cat [R, N] int8, blk_offsets: list of K/2-unit starts) with
    R = sum over experts of (K/2 if packed else K)."""
    e, k, _ = codes_i8.shape
    if k % 2:
        raise ValueError(f"build_ragged_mixed: K={k} must be even")
    pieces, blk_offsets, off = [], [], 0
    for ei in range(e):
        blk_offsets.append(off)
        if bool(pflags[ei]):
            pieces.append(pack_int4_halves(codes_i8[ei]))
            off += 1
        else:
            pieces.append(codes_i8[ei])
            off += 2
    return torch.cat(pieces, dim=0), blk_offsets


def pack_ragged_stack(q_layers, pf_all):
    """Per-layer int8 code stacks -> the stacked ragged mixed layout.

    ``q_layers``: iterable of [E, K, N] int8 tensors (consumed one at a
    time, so a generator keeps one layer's codes alive), ``pf_all``: [L][E]
    packed flags. Returns (qcat [L, R_max, N] int8, blk [L, E] int32,
    pf [L, E] int32): layers with fewer rows are zero-padded to R_max."""
    qcat, blks = None, []
    for l, (q_l, pf_l) in enumerate(zip(q_layers, pf_all)):
        cat, blk = build_ragged_mixed(q_l, pf_l)
        if qcat is None:
            k2 = q_l.shape[1] // 2
            r_max = max(sum(1 if f else 2 for f in pf) for pf in pf_all) * k2
            qcat = torch.zeros((len(pf_all), r_max, q_l.shape[2]),
                               dtype=torch.int8, device=q_l.device)
        qcat[l, : cat.shape[0]] = cat
        blks.append(blk)
    dev = qcat.device
    return (qcat, torch.tensor(blks, dtype=torch.int32, device=dev),
            torch.tensor([[int(bool(f)) for f in pf] for pf in pf_all],
                         dtype=torch.int32, device=dev))


def _to_signed_storage(codes, scale, zp, bits: float, sym: bool):
    if bits > 8:
        raise ValueError(f"no integer storage for {bits}-bit")
    if sym or bits == 1.5:
        return codes.to(torch.int8), scale, zp
    shift = float(1 << (int(bits) - 1)) if bits >= 2 else 1.0
    return (codes - shift).to(torch.int8), scale, zp + shift * scale


def _fused_zero_point(w_nk: torch.Tensor, zp: torch.Tensor, cfg: QLinearConfig):
    """The signed-storage zero point as the reference's compiled uniform
    quantizer rounds it: XLA folds ``zp + shift * (range * f32(1/upper))``
    into one multiply-add by the f32 constant ``shift / upper``, so the
    scale's own rounding never enters it (rounded once here, in float64)."""
    upper = float((1 << int(cfg.w_bits)) - 1)
    shift = float(1 << (int(cfg.w_bits) - 1))
    coef = float(np.float32(shift) * np.float32(1.0 / upper))
    k = w_nk.shape[-1]
    g = k if cfg.w_gsize == -1 else cfg.w_gsize
    wg = w_nk.float().reshape(*w_nk.shape[:-1], k // g, g)
    rng = wg.amax(-1) * cfg.w_clip[1] - wg.amin(-1) * cfg.w_clip[0]
    return (zp.double() + rng.double() * coef).float()


def quantize_weight_kn(w_kn: torch.Tensor, cfg: QLinearConfig,
                       scale_by_reciprocal: bool = True) -> PackedTensor:
    """Quantize a weight stored [.., K, N] with groups along K per column;
    scale/zp come out [.., K//g, N]. ``scale_by_reciprocal``: see
    ``rtn.quantize`` (on, the compiled reference is followed in the
    asymmetric zero point too: ``_fused_zero_point``)."""
    w_nk = w_kn.transpose(-1, -2)
    q = quantize(w_nk, cfg.w_bits, cfg.w_gsize, cfg.w_sym, cfg.w_clip,
                 scale_by_reciprocal)
    eff_sym = cfg.w_sym or cfg.w_bits == 1.5
    values, scale, zp = _to_signed_storage(q.codes, q.scale, q.zp,
                                           cfg.w_bits, eff_sym)
    if (scale_by_reciprocal and not eff_sym and cfg.w_bits >= 2
            and not isinstance(cfg.w_clip, str)):
        zp = _fused_zero_point(w_nk, q.zp, cfg)
    g = w_kn.shape[-2] if cfg.w_gsize == -1 else cfg.w_gsize
    return PackedTensor(values.transpose(-1, -2).contiguous(),
                        scale.transpose(-1, -2).contiguous(),
                        zp.transpose(-1, -2).contiguous(),
                        int(cfg.w_bits), g, cfg.w_sym)


def dequantize_weight_kn(p: PackedTensor) -> torch.Tensor:
    """[.., K, N] codes + [.., K//g, N] params -> float32 [.., K, N]."""
    v = p.values.float()
    k, n = v.shape[-2], v.shape[-1]
    vg = v.reshape(*v.shape[:-2], k // p.gsize, p.gsize, n)
    out = vg * p.scale[..., :, None, :] + p.zp[..., :, None, :]
    return out.reshape(*v.shape[:-2], k, n)
