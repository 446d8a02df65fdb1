"""The whole expert FFN in one launch (port of
``mxmoe_tpu/ops/pallas_gmm.py:gmm_ffn_w8a8`` and ``gmm_ffn_mixed_packed``)
— kernels K12 ``csrc/gmm_ffn_w8a8.cu`` and K13
``csrc/gmm_ffn_mixed_packed.cu``, over ``csrc/gmm_ffn_tile.cuh``.

Per row r of expert e (per-channel symmetric int8 weights, per-row
activation scales), in f32 throughout:

  gu    = (float(lhs_q[r] @ w_gu[e]) * lhs_scale[r]) * s_gu[e]     [2N]
  h     = gate * sigmoid(gate) * up          (gate = gu[:N], up = gu[N:])
  scale = max(amax(|h|), 1e-8) / upper,  upper = 2^(min(bits[e], 8) - 1) - 1
  hq    = round(h / scale)                   (int8, half to even)
  out   = ((float(hq @ w_d[e]) * scale) * s_d[e]) -> out dtype

``bits`` is ``act_bits_down`` [E] (8 when None). Against the two-launch
path (K2 -> bf16 -> SwiGLU -> K1 -> K2) the int8 dots and the scale algebra
are the same, but h is never rounded to bf16, so a requant code may flip by
one step on a knife edge (the reference's claim; its tests bound the drift).

K13 takes the weights in K4's ragged buffers (``gu_cat`` [R1, 2N],
``down_cat`` [R2, H] int8; expert e one nibble-packed unit of K/2 (N/2)
rows when ``pf[e]``, else two int8 units, from unit ``blk[e]``); its output
is bitwise K12's on the equivalent int8 codes.

The kernels' design (bound: the live experts' weight bytes): a thread block
cluster of C CTAs per 32-row m-tile, C = 8 where each CTA's share of N fits
12 16-column units (N <= 1536), else 16 (N <= 3072: qwen2_moe_57b's 2560;
``ffn_cluster`` in ``csrc/gmm_ffn_tile.cuh``, read by ``ffn_cluster_size``).
CTA r computes the h columns of its share of 16-column units from their
gate and up weight columns, the CTAs merge their partial row amax through
distributed shared memory, each quantizes its h slice into its own and the
others' copies of hq (stores to their shared memory) and computes its share
of the output columns. Weights
stream through a four-deep 16-byte ``cp.async`` ring; hq never leaves the
cluster (no device workspace). Any split of the columns gives the plain
versions' bits (int32 sums are exact, the f32 steps are per element and a
max does not depend on order); ``tests/test_torch_ffn_split.py`` writes the
split out in plain PyTorch.

The kernels need the sizes on the device only. Rows past
``sum(group_sizes)`` stay unwritten by the kernels and zero in the plain
versions. The TPU grid's ``bm`` / ``bn1`` / ``bn2`` / ``h_dtype`` (f32 here)
/ ``static_sizes`` / ``group_base`` have no counterpart (a layer's weights
are the view ``w[layer]``).
"""

from __future__ import annotations

import torch

from . import kernels
from ..quant.packing import unpack_int4_halves
from ..quant.qparams import quantize_act_per_row_bits
from .gmm_w8a8 import exact_int8_matmul

def ffn_plain(lhs_q, lhs_scale, gate_up_of, gu_scale, down_of, down_scale,
              group_sizes, act_bits_down, out_dtype) -> torch.Tensor:
    """The plain FFN shared by K12's and K13's plain versions:
    ``gate_up_of(e)`` / ``down_of(e)`` give expert e's [K, 2N] / [N, H]
    int8 codes. Reads ``group_sizes`` and the bits on the host."""
    m = lhs_q.shape[0]
    n = gu_scale.shape[-1] // 2
    out = torch.zeros((m, down_scale.shape[-1]), dtype=out_dtype,
                      device=lhs_q.device)
    bits = act_bits_down.tolist()
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = min(start + size, m)
        if end > start:
            gu = (exact_int8_matmul(lhs_q[start:end], gate_up_of(e)).float()
                  * lhs_scale[start:end] * gu_scale[e])
            gate, up = gu[:, :n], gu[:, n:]
            h = gate * torch.sigmoid(gate) * up
            hq, hsc = quantize_act_per_row_bits(
                h, torch.full((end - start,), float(bits[e]), device=h.device))
            res = exact_int8_matmul(hq, down_of(e)).float() * hsc * down_scale[e]
            out[start:end] = res.to(out_dtype)
        start += size
    return out


def _bits(act_bits_down, e, device):
    if act_bits_down is None:
        return torch.full((e,), 8, dtype=torch.int32, device=device)
    return act_bits_down


def gmm_ffn_w8a8_plain(lhs_q, lhs_scale, gateup_q, gateup_scale, down_q,
                       down_scale, group_sizes, act_bits_down=None,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K12."""
    bits = _bits(act_bits_down, gateup_q.shape[0], lhs_q.device)
    return ffn_plain(lhs_q, lhs_scale, lambda e: gateup_q[e], gateup_scale,
                     lambda e: down_q[e], down_scale, group_sizes, bits, out_dtype)


def _ragged_block(cat, pf, blk, kdim):
    """Expert e's [kdim, cols] int8 codes from a ragged buffer."""
    k2 = kdim // 2

    def codes(e):
        r0 = blk[e] * k2
        if pf[e]:
            return unpack_int4_halves(cat[r0: r0 + k2])
        return cat[r0: r0 + kdim]

    return codes


def gmm_ffn_mixed_packed_plain(lhs_q, lhs_scale, gu_cat, gu_scale, gu_pf, gu_blk,
                               down_cat, down_scale, down_pf, down_blk,
                               group_sizes, act_bits_down=None,
                               out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K13: unpack each routed expert's blocks, then
    K12's plain arithmetic."""
    k, n = lhs_q.shape[1], gu_scale.shape[-1] // 2
    bits = _bits(act_bits_down, group_sizes.numel(), lhs_q.device)
    return ffn_plain(lhs_q, lhs_scale,
                     _ragged_block(gu_cat, gu_pf.tolist(), gu_blk.tolist(), k),
                     gu_scale,
                     _ragged_block(down_cat, down_pf.tolist(), down_blk.tolist(), n),
                     down_scale, group_sizes, bits, out_dtype)


def _check(name, lhs_q, lhs_scale, gu_scale, down_scale, group_sizes, bits,
           out_dtype, weights, k, n, h, meta=()) -> None:
    req = kernels.require
    m = lhs_q.shape[0]
    e = group_sizes.numel()
    dev = lhs_q.device
    req(all(t.is_cuda and t.device == dev and t.is_contiguous()
            for t in (lhs_q, lhs_scale, gu_scale, down_scale, group_sizes, bits,
                      *weights, *meta)),
        f"{name}: operands must be contiguous tensors on one CUDA device")
    req(all(t.dtype == torch.int32 and t.shape == (e,) for t in meta),
        f"{name}: pf / blk must be int32 [E]")
    req(lhs_q.dtype == torch.int8 and all(w.dtype == torch.int8 for w in weights),
        f"{name}: codes must be int8")
    req(lhs_scale.dtype == torch.float32 and lhs_scale.shape == (m, 1),
        f"{name}: lhs_scale must be float32 [M, 1]")
    req(gu_scale.dtype == torch.float32 and gu_scale.shape == (e, 1, 2 * n)
        and down_scale.dtype == torch.float32 and down_scale.shape == (e, 1, h),
        f"{name}: per-channel scales [E, 1, 2N] / [E, 1, H] float32 only")
    req(group_sizes.dtype == torch.int32 and bits.dtype == torch.int32
        and bits.shape == (e,), f"{name}: group_sizes / act_bits_down int32 [E]")
    req(k % 32 == 0 and n % 64 == 0 and h % 4 == 0,
        f"{name}: K={k} % 32, N={n} % 64, H={h} % 4")
    req(kernels.lib().mxmoe_gmm_ffn_smem_bytes(n, h) > 0,
        f"{name}: N={n}: h [32, N] f32 over a cluster of at most 16 CTAs (at "
        f"most 192 columns each) does not fit their shared memory")
    req(e <= 1024, f"{name}: at most 1024 experts")
    req(out_dtype in (torch.bfloat16, torch.float32), f"{name}: out dtype {out_dtype}")


def gmm_ffn_w8a8(
    lhs_q: torch.Tensor,         # [M, K] int8 codes (per-row quantized x)
    lhs_scale: torch.Tensor,     # [M, 1] f32
    gateup_q: torch.Tensor,      # [E, K, 2N] int8 (sym per-channel)
    gateup_scale: torch.Tensor,  # [E, 1, 2N] f32
    down_q: torch.Tensor,        # [E, N, H] int8
    down_scale: torch.Tensor,    # [E, 1, H] f32
    group_sizes: torch.Tensor,   # [E] int32
    act_bits_down: torch.Tensor | None = None,   # [E] int32; None = 8
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Whole expert FFN (gate_up -> SwiGLU -> requant -> down) in one
    grouped launch -> [M, H]."""
    if lhs_q.device.type == "cpu":
        return gmm_ffn_w8a8_plain(lhs_q, lhs_scale, gateup_q, gateup_scale,
                                  down_q, down_scale, group_sizes, act_bits_down,
                                  out_dtype)
    m, k = lhs_q.shape
    e, _, n2 = gateup_q.shape
    n, h = n2 // 2, down_q.shape[-1]
    bits = _bits(act_bits_down, e, lhs_q.device)
    _check("gmm_ffn_w8a8", lhs_q, lhs_scale, gateup_scale, down_scale, group_sizes,
           bits, out_dtype, (gateup_q, down_q), k, n, h)
    kernels.require(gateup_q.shape == (e, k, 2 * n) and down_q.shape == (e, n, h),
                    f"gmm_ffn_w8a8: weights {tuple(gateup_q.shape)} "
                    f"{tuple(down_q.shape)} for K={k}")
    out = torch.empty((m, h), dtype=out_dtype, device=lhs_q.device)
    err = kernels.lib().mxmoe_gmm_ffn_w8a8(
        lhs_q.data_ptr(), lhs_scale.data_ptr(), gateup_q.data_ptr(),
        gateup_scale.data_ptr(), down_q.data_ptr(), down_scale.data_ptr(),
        group_sizes.data_ptr(), bits.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16), m, k, n, h, e,
        kernels.stream_ptr(lhs_q.device))
    kernels.check(err, "gmm_ffn_w8a8")
    kernels.launches["gmm_ffn_w8a8"] += 1
    return out


def gmm_ffn_mixed_packed(
    lhs_q: torch.Tensor,         # [M, K] int8 codes
    lhs_scale: torch.Tensor,     # [M, 1] f32
    gu_cat: torch.Tensor,        # [R1, 2N] int8 ragged buffer
    gu_scale: torch.Tensor,      # [E, 1, 2N] f32
    gu_pf: torch.Tensor,         # [E] int32: 1 = expert's gate_up packed
    gu_blk: torch.Tensor,        # [E] int32 K/2-unit starts
    down_cat: torch.Tensor,      # [R2, H] int8 ragged buffer
    down_scale: torch.Tensor,    # [E, 1, H] f32
    down_pf: torch.Tensor,       # [E] int32
    down_blk: torch.Tensor,      # [E] int32 N/2-unit starts
    group_sizes: torch.Tensor,   # [E] int32
    act_bits_down: torch.Tensor | None = None,   # [E] int32; None = 8
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Whole expert FFN in one launch over the packed ragged storage."""
    if lhs_q.device.type == "cpu":
        return gmm_ffn_mixed_packed_plain(lhs_q, lhs_scale, gu_cat, gu_scale, gu_pf,
                                          gu_blk, down_cat, down_scale, down_pf,
                                          down_blk, group_sizes, act_bits_down,
                                          out_dtype)
    m, k = lhs_q.shape
    e = group_sizes.numel()
    n, h = gu_cat.shape[1] // 2, down_cat.shape[1]
    bits = _bits(act_bits_down, e, lhs_q.device)
    meta = (gu_pf, gu_blk, down_pf, down_blk)
    _check("gmm_ffn_mixed_packed", lhs_q, lhs_scale, gu_scale, down_scale,
           group_sizes, bits, out_dtype, (gu_cat, down_cat), k, n, h, meta)
    kernels.require(gu_cat.dim() == 2 and gu_cat.shape[0] % (k // 2) == 0
                    and down_cat.dim() == 2 and down_cat.shape[0] % (n // 2) == 0,
                    f"gmm_ffn_mixed_packed: buffers {tuple(gu_cat.shape)} "
                    f"{tuple(down_cat.shape)} for K={k}, N={n}")
    out = torch.empty((m, h), dtype=out_dtype, device=lhs_q.device)
    err = kernels.lib().mxmoe_gmm_ffn_mixed_packed(
        lhs_q.data_ptr(), lhs_scale.data_ptr(), gu_cat.data_ptr(),
        gu_scale.data_ptr(), gu_pf.data_ptr(), gu_blk.data_ptr(),
        down_cat.data_ptr(), down_scale.data_ptr(), down_pf.data_ptr(),
        down_blk.data_ptr(), group_sizes.data_ptr(), bits.data_ptr(),
        out.data_ptr(), int(out_dtype == torch.bfloat16), m, k, n, h, e,
        kernels.stream_ptr(lhs_q.device))
    kernels.check(err, "gmm_ffn_mixed_packed")
    kernels.launches["gmm_ffn_mixed_packed"] += 1
    return out


def resident_clusters(n: int, h: int, ragged: bool = False) -> int:
    """How many clusters (of ``ffn_cluster_size(n)`` CTAs) the card runs at
    once for K12 (K13 with ``ragged``) at widths N, H, bf16 out: the
    persistent grid's size, so a launch with more live m-tiles than this
    runs them in rounds. Needs a card."""
    name = "mixed_packed" if ragged else "w8a8"
    got = getattr(kernels.lib(), f"mxmoe_gmm_ffn_{name}_clusters")(n, h)
    kernels.check(0 if got > 0 else -got, "gmm_ffn resident clusters")
    return got


def ffn_cluster_size(n: int) -> int:
    """The CTAs of the kernels' cluster at expert width N, as the built
    library computes it (``ffn_cluster``): 8 or 16, 0 where N is refused
    (mixtral's 14336, which the reference's VMEM check refuses too). Needs
    a card."""
    return kernels.lib().mxmoe_gmm_ffn_cluster_size(n)
