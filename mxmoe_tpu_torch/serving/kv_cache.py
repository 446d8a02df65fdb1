"""KV cache for decode (port of ``mxmoe_tpu/serving/kv_cache.py``: the bf16
``KVCache`` and the int8 ``QuantKVCache`` with per-vector f32 scales, GQA
and MLA).

Layout: K/V stacked [L, B, n_kv, S_max, hd] (head-major), as in the JAX
package; L counts every layer, dense first layers included. An MLA cache
keeps one K/V per head (n_kv = num_heads), K at ``mla_cache_k_dim`` lanes
(qk_head_dim padded with zeros to a multiple of 128: 192 -> 256) and V at
v_head_dim. The torch cache is updated IN PLACE (``scatter_layer_cache*``,
and kernel K3 / K3q in a decode step); the JAX package's donated-carry
protocol has no counterpart here.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.configs import MoEConfig


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor        # [L, B, n_kv, S_max, hd]
    v: torch.Tensor        # [L, B, n_kv, S_max, hd]
    lengths: torch.Tensor  # [B] int32 valid tokens per slot

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


def mla_cache_k_dim(cfg: MoEConfig) -> int:
    """MLA K-cache width: qk_head_dim padded up to a multiple of 128 (192 ->
    256). The tail lanes hold zeros, which add nothing to q.k, and the
    padded width is one that the decode kernels take (dk in 32/64/128/256)."""
    return -(-cfg.qk_head_dim // 128) * 128


def _cache_shapes(cfg: MoEConfig, batch: int, max_len: int):
    """The K and V shapes [L, B, n_kv, S_max, d] of the family."""
    if cfg.attention_type == "mla":
        n_kv, k_dim, v_dim = cfg.num_heads, mla_cache_k_dim(cfg), cfg.v_head_dim
    else:
        n_kv, k_dim, v_dim = cfg.num_kv_heads, cfg.head_dim, cfg.head_dim
    lead = (cfg.num_layers, batch, n_kv, max_len)
    return (*lead, k_dim), (*lead, v_dim)


def init_kv_cache(cfg: MoEConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cuda") -> KVCache:
    k_shape, v_shape = _cache_shapes(cfg, batch, max_len)
    return KVCache(
        k=torch.zeros(k_shape, dtype=dtype, device=device),
        v=torch.zeros(v_shape, dtype=dtype, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def clone_cache(cache, device=None):
    """A copy of ``cache`` (a ``KVCache`` or ``QuantKVCache``, ``lengths``
    included) on ``device``, or where it is."""
    return type(cache)(**{f.name: getattr(cache, f.name).to(device, copy=True)
                          for f in dataclasses.fields(cache)})


def _chunk_writes(s_new: int, s_max: int, lengths, valid):
    """The writes of a chunk of S_new <= S_max positions, read nowhere on
    the host: (slots [B, 1], positions [B, S_new], keep [B, S_new] bool).
    Slot b's position s lands at ``lengths[b] + s``. A write at or past
    S_max, or of a slot with ``valid`` False, is dropped, never clamped
    onto a neighbour's history: it is sent to position ``(lengths[b] + s) %
    S_max`` of its own slot and writes back what is there (``_write_chunk``).
    One slot's S_new positions are then distinct, and a dropped one past
    S_max lies below ``lengths[b]``, on no kept one, so no two writes of one
    ``index_put_`` meet (their order on a card is undefined); shapes stay
    static, so a CUDA graph can hold the write."""
    pos = lengths.long()[:, None] + torch.arange(s_new, device=lengths.device)
    keep = pos < s_max
    if valid is not None:
        keep &= valid.bool()[:, None]
    bi = torch.arange(lengths.shape[0], device=lengths.device)[:, None]
    return bi, pos % s_max, keep


def _write_chunk(full, layer: int, bi, pi, keep, new) -> None:
    """``full[layer, b, :, pi[b, s]] = new[b, s]`` where ``keep[b, s]``,
    else unchanged (``_chunk_writes``)."""
    shape = keep.shape + (1,) * (new.dim() - keep.dim())
    old = full[layer, bi, :, pi]
    full[layer, bi, :, pi] = torch.where(keep.view(shape), new.to(full.dtype), old)


def scatter_layer_cache(full_k, full_v, layer: int, new_k, new_v, lengths,
                        valid=None):
    """Write a chunk into ONE layer of the stacked cache, in place.
    ``new_k``/``new_v`` token-major [B, S_new, n_kv, hd]. Chunk positions
    past S_max never land (``pos >= s >= S_max``), so a longer chunk is cut
    there."""
    s_max = full_k.shape[3]
    new_k, new_v = new_k[:, :s_max], new_v[:, :s_max]
    bi, pi, keep = _chunk_writes(new_k.shape[1], s_max, lengths, valid)
    _write_chunk(full_k, layer, bi, pi, keep, new_k)
    _write_chunk(full_v, layer, bi, pi, keep, new_v)
    return full_k, full_v


def attention_with_cache(q, cache_k, cache_v, lengths, s_new: int,
                         scale: float | None = None) -> torch.Tensor:
    """GQA attention over the head-major cache of one layer
    ([B, n_kv, S_max, hd], already updated) with causal + validity
    masking: query position i attends cache slots [0, lengths + i]."""
    b, _, n_h, hd = q.shape
    n_kv, s_max = cache_k.shape[1], cache_k.shape[2]
    groups = n_h // n_kv
    # a float32 q promotes the bf16 cache, as jnp's einsum does
    cache_k, cache_v = cache_k.to(q.dtype), cache_v.to(q.dtype)
    qg = q.reshape(b, s_new, n_kv, groups, hd)
    scores = torch.einsum("bsngh,bnth->bngst", qg, cache_k).float()
    scores = scores * (scale if scale is not None else 1.0 / float(hd) ** 0.5)
    dev = q.device
    key_pos = torch.arange(s_max, device=dev)[None, None, :]
    q_end = lengths.long()[:, None, None] + torch.arange(s_new, device=dev)[None, :, None]
    mask = key_pos <= q_end                                   # [B, S_new, S_max]
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bngst,bnth->bsngh", probs, cache_v)
    return out.reshape(b, s_new, n_h, cache_v.shape[-1])


# ---------------------------------------------------------------------------
# int8-quantized KV cache: half the memory and read bandwidth, per-vector scales
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QuantKVCache:
    """KV cache with int8 storage and per-(slot, position, head) vector
    scales. The scales factor out of both attention contractions, so
    dequantizing costs one multiply on the scores and one on the probs."""

    k_q: torch.Tensor      # [L, B, n_kv, S_max, hd] int8 (head-major)
    k_sc: torch.Tensor     # [L, B, n_kv, S_max] f32
    v_q: torch.Tensor
    v_sc: torch.Tensor
    lengths: torch.Tensor  # [B] int32

    @property
    def max_len(self) -> int:
        return self.k_q.shape[3]


def init_quant_kv_cache(cfg: MoEConfig, batch: int, max_len: int,
                        device="cuda") -> QuantKVCache:
    k_shape, v_shape = _cache_shapes(cfg, batch, max_len)

    def codes(shape):
        return torch.zeros(shape, dtype=torch.int8, device=device)

    def scales():
        return torch.zeros(k_shape[:4], dtype=torch.float32, device=device)

    return QuantKVCache(
        k_q=codes(k_shape), k_sc=scales(), v_q=codes(v_shape), v_sc=scales(),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device))


_INV_127 = 1.0 / 127.0


def _quant_vec(x: torch.Tensor):
    """Per-vector symmetric int8 quant over the last axis -> (codes, scale).

    The reference writes ``max(amax, 1e-8) / 127``; compiled (every serving
    entry point jits its step) XLA turns that division by a constant into a
    multiply by the float32 reciprocal, so the scale is computed that way
    here and stays bitwise equal to the jitted reference's. (A Python float
    multiplies a float32 tensor as its float32 rounding: no constant tensor
    is copied to the device, which a captured decode step cannot hold.)"""
    xf = x.float()
    sc = torch.clamp(xf.abs().amax(-1), min=1e-8) * _INV_127
    return torch.round(xf / sc[..., None]).to(torch.int8), sc


def scatter_layer_cache_quant(ckq, cks, cvq, cvs, layer: int, new_k, new_v,
                              lengths, valid=None):
    """Quantized-cache variant of :func:`scatter_layer_cache`: per-vector
    int8 quant of the chunk, then the same in-place masked write of codes
    and scales."""
    s_max = ckq.shape[3]
    kq, ks = _quant_vec(new_k[:, :s_max])   # [B, S_new, n, hd], [B, S_new, n]
    vq, vs = _quant_vec(new_v[:, :s_max])
    bi, pi, keep = _chunk_writes(kq.shape[1], s_max, lengths, valid)
    for full, new in ((ckq, kq), (cks, ks), (cvq, vq), (cvs, vs)):
        _write_chunk(full, layer, bi, pi, keep, new)
    return ckq, cks, cvq, cvs


def attention_with_quant_cache(q, ckq, cks, cvq, cvs, lengths, s_new: int,
                               scale: float | None = None) -> torch.Tensor:
    """GQA attention over the int8 cache of one layer (codes
    [B, n_kv, S_max, hd], scales [B, n_kv, S_max], already updated); the
    scales fold into the scores and the probs."""
    b, _, n_h, hd = q.shape
    n_kv, s_max = ckq.shape[1], ckq.shape[2]
    groups = n_h // n_kv
    qg = q.float().reshape(b, s_new, n_kv, groups, hd)
    scores = torch.einsum("bsngh,bnth->bngst", qg, ckq.float())
    scores = scores * cks[:, :, None, None, :]
    scores = scores * (scale if scale is not None else 1.0 / float(hd) ** 0.5)
    dev = q.device
    key_pos = torch.arange(s_max, device=dev)[None, None, :]
    q_end = lengths.long()[:, None, None] + torch.arange(s_new, device=dev)[None, :, None]
    mask = key_pos <= q_end                                   # [B, S_new, S_max]
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1) * cvs[:, :, None, None, :]
    out = torch.einsum("bngst,bnth->bsngh", probs, cvq.float())
    return out.reshape(b, s_new, n_h, cvq.shape[-1]).to(q.dtype)
