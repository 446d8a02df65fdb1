"""Integer storage for quantized weights and activations (port of
``mxmoe_tpu/quant/packing.py``: signed int8 storage, the nibble-packed
halves and adjacent-rows layouts, the ragged mixed buffer and its per-shard
form for expert parallelism, ``shard_ragged_mixed``).

Weights are stored [.., K, N] with scales/zp [.., K//g, N]; activations
[M, K] with scales/zp [M, K//g]. Asymmetric codes are re-centred to signed
storage, q' = q - 2^(b-1) with zp' = zp + 2^(b-1) * scale, so
``dequant = q' * scale + zp'`` holds exactly.
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


def storage_dtype_for(bits: float) -> torch.dtype:
    """The integer dtype that holds ``bits``-bit codes: int8 up to 8 bits
    (sub-byte codes live in int8; the bandwidth-saving form is explicit
    nibble packing)."""
    if bits <= 8:
        return torch.int8
    raise ValueError(f"no integer storage for {bits}-bit")


def _nibbles_to_int8(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """lo | hi << 4 (each 0..15), stored as its two's-complement int8."""
    return (((lo | (hi << 4)) ^ 0x80) - 0x80).to(torch.int8)


def pack_int4_halves(codes_i8: torch.Tensor) -> torch.Tensor:
    """Pack signed 4-bit codes [..., K, N] -> int8 [..., K//2, N] with the
    *halves* layout: low nibble = k, high nibble = k + K/2 (the layout the
    packed kernels consume: unpacking is a contiguous concat along K)."""
    k = codes_i8.shape[-2]
    lo = codes_i8[..., : k // 2, :].to(torch.int32) & 0xF
    hi = codes_i8[..., k // 2:, :].to(torch.int32) & 0xF
    return _nibbles_to_int8(lo, hi)


def unpack_int4_halves(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4_halves`."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    return torch.cat([lo, hi], dim=-2).to(torch.int8)


def pack_int4_rows(codes_i8: torch.Tensor) -> torch.Tensor:
    """Pack signed 4-bit codes [..., K, N] -> int8 [..., K//2, N], two
    adjacent K values per byte (low nibble = even k). K must be even."""
    lo = codes_i8[..., 0::2, :].to(torch.int32) & 0xF
    hi = codes_i8[..., 1::2, :].to(torch.int32) & 0xF
    return _nibbles_to_int8(lo, hi)


def unpack_int4_rows(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4_rows`: int8 [..., K//2, N] -> [..., K, N]."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8          # sign-extend the low nibble
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    k2, n = packed.shape[-2], packed.shape[-1]
    out = torch.stack([lo, hi], dim=-2)            # [..., K//2, 2, N]
    return out.reshape(*packed.shape[:-2], 2 * k2, n).to(torch.int8)


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
    storage_dtype_for(bits)
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


def quantize_act(a: torch.Tensor, cfg: QLinearConfig) -> PackedTensor:
    """Per-token (grouped) activation quantization -> signed codes; ``a``
    [M, K] (or any leading dims + K), groups along K. The scale is the true
    division ``range / upper``, as the reference computes it op by op."""
    q = quantize(a, cfg.a_bits, cfg.a_gsize, cfg.a_sym, cfg.a_clip,
                 scale_by_reciprocal=False)
    values, scale, zp = _to_signed_storage(q.codes, q.scale, q.zp, cfg.a_bits,
                                           cfg.a_sym or cfg.a_bits == 1.5)
    g = a.shape[-1] if cfg.a_gsize == -1 else cfg.a_gsize
    return PackedTensor(values, scale, zp, int(cfg.a_bits), g, cfg.a_sym)


def dequantize_act(p: PackedTensor) -> torch.Tensor:
    """Codes [.., K] + scales / zp [.., K//g] -> float32 [.., K]."""
    shape = p.values.shape
    k = shape[-1]
    cg = p.values.float().reshape(*shape[:-1], k // p.gsize, p.gsize)
    return (cg * p.scale[..., None] + p.zp[..., None]).reshape(shape)


def dequantize_weight_kn(p: PackedTensor) -> torch.Tensor:
    """[.., K, N] codes + [.., K//g, N] params -> float32 [.., K, N]."""
    v = p.values.float()
    k, n = v.shape[-2], v.shape[-1]
    vg = v.reshape(*v.shape[:-2], k // p.gsize, p.gsize, n)
    out = vg * p.scale[..., :, None, :] + p.zp[..., :, None, :]
    return out.reshape(*v.shape[:-2], k, n)


def shard_ragged_mixed(qcat: torch.Tensor, blk, pf, k: int, ep: int):
    """Global ragged mixed buffer -> the per-expert-shard stacked layout.

    ``qcat`` [R, N] (one layer's buffer from :func:`build_ragged_mixed`),
    ``blk`` / ``pf`` [E]: each expert's K/2-unit block(s) are sliced out of
    the global buffer and concatenated per shard of ``ceil(E/ep)``
    contiguous experts, every shard zero-padded to the longest, so the
    result stacks to [ep, R_l, N]. When E does not divide ``ep`` the tail
    shard(s) get never-routed PHANTOM experts: one packed K/2-unit each,
    pointing into the shard's zero padding. Returns (qcat_sharded [ep, R_l,
    N], blk_local: list of E_pad offsets LOCAL to each shard's buffer);
    callers pad their ``pf`` to E_pad with 1 (packed) to match."""
    blk = np.asarray(blk, np.int64)
    pf = np.asarray(pf, np.int64)
    e = blk.shape[0]
    e_local = -(-e // ep)
    e_pad = e_local * ep
    k2 = k // 2
    units = np.concatenate([2 - pf, np.ones(e_pad - e, np.int64)])  # K/2-units
    r_l = int(units.reshape(ep, e_local).sum(1).max()) * k2
    out = torch.zeros((ep, r_l, qcat.shape[1]), dtype=qcat.dtype, device=qcat.device)
    blk_local = []
    for s in range(ep):
        off = 0
        for ei in range(s * e_local, (s + 1) * e_local):
            blk_local.append(off)
            if ei < e:
                rows = int(units[ei]) * k2
                src = int(blk[ei]) * k2
                out[s, off * k2: off * k2 + rows] = qcat[src: src + rows]
            off += int(units[ei])
    return out, blk_local
