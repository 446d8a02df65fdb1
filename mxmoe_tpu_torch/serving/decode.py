"""Cache-aware decoder forward: prefill and decode share one code path
(port of ``mxmoe_tpu/serving/decode.py``, GQA and MLA, over the bf16
``KVCache`` and the int8 ``QuantKVCache``).

Both are [B, S_new] chunks against a cache; prefill uses S_new = chunk
size with per-slot valid lengths, decode uses S_new = 1. A decode step
(S_new == 1) goes through ``decode_attention_update_stacked`` (kernel K3
or K3q on CUDA, their plain versions on the CPU) unless
``MoEImpl.decode_attn`` is ``"xla"``; prefill, and ``"xla"`` decode, take
the JAX package's plain path, ``scatter_layer_cache*`` +
``attention_with*_cache``. MLA pads q and k with zeros to the cache's K
width and scales by 1/sqrt(qk_head_dim), not by the padded width. The dense
first layers (ds2) run first; the cache's layer index counts them. The layer
loop is a Python loop over ``w[layer]`` views; the cache is written in
place. ``MoEImpl.ep_moe`` (the expert-parallel block) takes the MoE blocks'
place; a rank with no rows in another rank's forward runs its share of the
blocks' collectives through :func:`forward_cached_follow`.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..models.configs import MoEConfig
from ..models.layers import (MoEImpl, apply_rope, apply_rope_interleaved,
                             dense_mlp_block, make_rope_tables, mla_qkv, moe_block,
                             rms_norm)
from ..models.model import head_logits, layer_stacks
from .decode_attention import decode_attention_update_stacked
from .kv_cache import (KVCache, QuantKVCache, attention_with_cache,
                       attention_with_quant_cache, scatter_layer_cache,
                       scatter_layer_cache_quant)


def _attend_cached(q, k, v, cache, layer: int, valid, fused: bool,
                   scale: float | None = None):
    """Write this chunk's k / v [B, S, n_kv, d] into layer ``layer`` of the
    stacked ``cache`` (bf16 or int8, in place) and attend q [B, S, n_h, dk]
    over it -> [B, S, n_h, dv]: one fused kernel for a decode step when
    ``fused``, else the scatter and the plain attention."""
    s = q.shape[1]
    lengths = cache.lengths
    quant = isinstance(cache, QuantKVCache)
    if quant:
        ck, cks, cv, cvs = cache.k_q, cache.k_sc, cache.v_q, cache.v_sc
    else:
        ck, cks, cv, cvs = cache.k, None, cache.v, None
    if fused and s == 1:
        out, _ = decode_attention_update_stacked(
            q[:, 0].contiguous(), k[:, 0].contiguous(), v[:, 0].contiguous(),
            ck, cks, cv, cvs, lengths, layer, valid=valid, scale=scale)
        return out[:, None]
    if quant:
        scatter_layer_cache_quant(ck, cks, cv, cvs, layer, k, v, lengths,
                                  valid=valid)
        return attention_with_quant_cache(q, ck[layer], cks[layer], cv[layer],
                                          cvs[layer], lengths, s, scale=scale)
    scatter_layer_cache(ck, cv, layer, k, v, lengths, valid=valid)
    return attention_with_cache(q, ck[layer], cv[layer], lengths, s, scale=scale)


def _attention_block_cached(x, lp, cfg: MoEConfig, cos, sin, cache,
                            layer: int, valid, fused: bool = True):
    """GQA attention of one layer against the stacked ``cache`` (bf16 or
    int8), whose K/V arrays are written in place."""
    b, s, _ = x.shape
    q = x @ lp["wq"]
    k = x @ lp["wk"]
    v = x @ lp["wv"]
    if cfg.attention_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = apply_rope(q.reshape(b, s, cfg.num_heads, cfg.head_dim), cos, sin)
    k = apply_rope(k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim), cos, sin)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    out = _attend_cached(q, k, v, cache, layer, valid, fused)
    return out.reshape(b, s, -1) @ lp["wo"]


def _attention_block_cached_mla(x, lp, cfg: MoEConfig, cos, sin, cache,
                                layer: int, valid, fused: bool = True):
    """MLA attention of one layer against the stacked cache (bf16 or int8;
    the reference's ``_attention_block_cached_mla`` and
    ``_attention_block_cached_quant_mla``): q and k zero-padded to the
    cache's K width, scale 1/sqrt(qk_head_dim)."""
    b, s, _ = x.shape
    q, k, v = mla_qkv(x, lp, cfg, lambda t: apply_rope_interleaved(t, cos, sin))
    pad = (cache.k_q if isinstance(cache, QuantKVCache) else cache.k).shape[-1] \
        - cfg.qk_head_dim
    if pad > 0:
        q, k = F.pad(q, (0, pad)), F.pad(k, (0, pad))
    out = _attend_cached(q, k, v, cache, layer, valid, fused,
                         scale=1.0 / math.sqrt(cfg.qk_head_dim))
    return out.reshape(b, s, cfg.num_heads * cfg.v_head_dim) @ lp["wo"]


def forward_cached(params: dict, tokens: torch.Tensor,
                   cache: "KVCache | QuantKVCache", cfg: MoEConfig,
                   impl: MoEImpl = MoEImpl(),
                   valid_lengths: torch.Tensor | None = None):
    """Run a chunk [B, S_new] against the cache -> (logits [B, S_new, V],
    cache). The cache's K/V are written in place; the returned cache (of
    the argument's type) holds the new lengths
    ``min(lengths + valid_lengths, S_max)``."""
    b, s_new = tokens.shape
    dev = tokens.device
    if valid_lengths is None:
        valid_lengths = torch.full((b,), s_new, dtype=torch.int32, device=dev)
    embed = params["embed"]
    x = embed[tokens.long().clamp(0, embed.shape[0] - 1)]
    positions = cache.lengths.long()[:, None] + torch.arange(s_new, device=dev)
    cos, sin = make_rope_tables(cfg, positions)              # [B, S, ...]
    attn = (_attention_block_cached_mla if cfg.attention_type == "mla"
            else _attention_block_cached)
    fused = impl.use_fused_decode()
    write_ok = (valid_lengths > 0).to(torch.int32)
    l = 0                        # the cache's layer: dense layers come first
    for stack, dense in layer_stacks(params):
        for i in range(stack["input_norm"].shape[0]):
            lp = {name: t[i] for name, t in stack.items()}
            h = x + attn(rms_norm(x, lp["input_norm"], cfg.rms_norm_eps), lp, cfg,
                         cos, sin, cache, l, write_ok, fused)
            norm_h = rms_norm(h, lp["post_attn_norm"], cfg.rms_norm_eps)
            if dense:
                x = h + dense_mlp_block(norm_h, lp, cfg)
            elif impl.ep_moe is not None:
                x = h + impl.ep_moe(norm_h, lp, cfg)
            else:
                x = h + moe_block(norm_h, lp, cfg, impl)
            l += 1
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    logits = head_logits(params, x, cfg)
    new_len = torch.clamp(cache.lengths + valid_lengths.to(torch.int32),
                          max=cache.max_len).to(torch.int32)
    return logits, dataclasses.replace(cache, lengths=new_len)


def forward_cached_follow(params: dict, cfg: MoEConfig, impl: MoEImpl) -> None:
    """This rank's part of a forward that another rank runs under expert
    parallelism (one slot's prefill on the rank that owns the slot): every
    MoE layer's ``impl.ep_moe`` block, in order, with no rows of its own, so
    each of the block's collectives has this rank too. The caller sets the
    ranks' row counts (``EPMoEBlock.rows``)."""
    embed = params["embed"]
    x = torch.empty((1, 0, embed.shape[1]), dtype=embed.dtype, device=embed.device)
    stack = params["layers"]
    for i in range(stack["input_norm"].shape[0]):
        impl.ep_moe(x, {name: t[i] for name, t in stack.items()}, cfg)


def sample_tokens(logits: torch.Tensor, gen: torch.Generator | None = None,
                  temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """[B, V] last-position logits -> [B] int32 tokens (greedy at
    temperature 0; else top-k filtered sampling drawn from ``gen``).

    The draw is ``torch.multinomial``'s own one-sample path written out,
    ``argmax(probs / q)`` with q ~ Exp(1) from ``gen`` (the same tokens from
    the same generator state): multinomial first checks the probabilities
    on the host, a read that a CUDA graph cannot hold."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / temperature
    if top_k > 0:
        cutoff = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = scaled.masked_fill(scaled < cutoff, float("-inf"))
    probs = torch.softmax(scaled, dim=-1)
    q = torch.empty_like(probs).exponential_(1.0, generator=gen)
    return torch.argmax(probs / q, dim=-1).to(torch.int32)


def decode_scan(step, last_tokens: torch.Tensor, n_steps: int,
                valid: torch.Tensor) -> torch.Tensor:
    """Generate ``n_steps`` tokens of a slot batch from its last tokens [B]
    and active mask [B] through ``step``, the batch's captured decode step
    over its cache (``graph.DecodeGraph``, one replay a step; on the CPU its
    body runs eagerly) -> tokens [B, n_steps] int32, left on the device, so
    the host reads them once a chunk. The cache is written in place."""
    step.load(last_tokens.to(torch.int32), valid)
    return step.run(n_steps)
