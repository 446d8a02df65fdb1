"""Cache-aware decoder forward: prefill and decode share one code path
(port of the GQA part of ``mxmoe_tpu/serving/decode.py``, over the bf16
``KVCache`` and the int8 ``QuantKVCache``).

Both are [B, S_new] chunks against a cache; prefill uses S_new = chunk
size with per-slot valid lengths, decode uses S_new = 1. A decode step
(S_new == 1) always goes through ``decode_attention_update_stacked``
(kernel K3 or K3q on CUDA, their plain versions on the CPU); prefill keeps
the JAX package's plain path, ``scatter_layer_cache*`` +
``attention_with*_cache``. The layer loop is a Python loop over
``w[layer]`` views; the cache is written in place.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.configs import MoEConfig
from ..models.layers import MoEImpl, moe_block, rms_norm
from ..models.model import head_logits
from .decode_attention import decode_attention_update_stacked
from .kv_cache import (KVCache, QuantKVCache, attention_with_cache,
                       attention_with_quant_cache, scatter_layer_cache,
                       scatter_layer_cache_quant)


def _rope_tables(cfg: MoEConfig, positions: torch.Tensor):
    """cos/sin [B, S, hd] (float32) for per-slot positions [B, S]."""
    hd = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=positions.device) / hd))
    ang = positions.float()[..., None] * inv_freq             # [B, S, hd/2]
    emb = torch.cat([ang, ang], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _apply_rope_bs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [B, S, nH, hd], cos/sin [B, S, hd] (half-split convention)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return x * c + rotated * s


def _attention_block_cached(x, lp, cfg: MoEConfig, cos, sin, cache,
                            layer: int, valid):
    """GQA attention of one layer against the stacked ``cache`` (bf16 or
    int8), whose K/V arrays are written in place."""
    b, s, _ = x.shape
    lengths = cache.lengths
    quant = isinstance(cache, QuantKVCache)
    if quant:
        ck, cks, cv, cvs = cache.k_q, cache.k_sc, cache.v_q, cache.v_sc
    else:
        ck, cks, cv, cvs = cache.k, None, cache.v, None
    q = x @ lp["wq"]
    k = x @ lp["wk"]
    v = x @ lp["wv"]
    if cfg.attention_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = _apply_rope_bs(q.reshape(b, s, cfg.num_heads, cfg.head_dim), cos, sin)
    k = _apply_rope_bs(k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim), cos, sin)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if s == 1:
        out, _ = decode_attention_update_stacked(
            q[:, 0].contiguous(), k[:, 0].contiguous(), v[:, 0].contiguous(),
            ck, cks, cv, cvs, lengths, layer, valid=valid)
        out = out[:, None]
    elif quant:
        scatter_layer_cache_quant(ck, cks, cv, cvs, layer, k, v, lengths,
                                  valid=valid)
        out = attention_with_quant_cache(q, ck[layer], cks[layer], cv[layer],
                                         cvs[layer], lengths, s)
    else:
        scatter_layer_cache(ck, cv, layer, k, v, lengths, valid=valid)
        out = attention_with_cache(q, ck[layer], cv[layer], lengths, s)
    return out.reshape(b, s, -1) @ lp["wo"]


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
    cos, sin = _rope_tables(cfg, positions)
    write_ok = (valid_lengths > 0).to(torch.int32)
    layers = params["layers"]
    for l in range(cfg.num_layers):
        lp = {name: t[l] for name, t in layers.items()}
        h = x + _attention_block_cached(
            rms_norm(x, lp["input_norm"], cfg.rms_norm_eps), lp, cfg, cos, sin,
            cache, l, write_ok)
        x = h + moe_block(rms_norm(h, lp["post_attn_norm"], cfg.rms_norm_eps),
                          lp, cfg, impl)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    logits = head_logits(params, x, cfg)
    new_len = torch.clamp(cache.lengths + valid_lengths.to(torch.int32),
                          max=cache.max_len).to(torch.int32)
    return logits, dataclasses.replace(cache, lengths=new_len)


def sample_tokens(logits: torch.Tensor, gen: torch.Generator | None = None,
                  temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """[B, V] last-position logits -> [B] int32 tokens (greedy at
    temperature 0; else top-k filtered sampling drawn from ``gen``)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / temperature
    if top_k > 0:
        cutoff = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = scaled.masked_fill(scaled < cutoff, float("-inf"))
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def decode_scan(params: dict, last_tokens: torch.Tensor, cache,
                n_steps: int, cfg: MoEConfig, impl: MoEImpl = MoEImpl(),
                valid: torch.Tensor | None = None, temperature: float = 0.0,
                top_k: int = 0, gen: torch.Generator | None = None):
    """Generate ``n_steps`` tokens; the tokens stay on the device between
    steps (the host reads them once per chunk). Returns
    ``(tokens [B, n_steps] int32, cache)``."""
    b = last_tokens.shape[0]
    if valid is None:
        valid = torch.ones((b,), dtype=torch.int32, device=last_tokens.device)
    toks = last_tokens.to(torch.int32)[:, None]
    out = []
    for _ in range(n_steps):
        logits, cache = forward_cached(params, toks, cache, cfg, impl,
                                       valid_lengths=valid)
        nxt = sample_tokens(logits[:, -1], gen, temperature, top_k)
        out.append(nxt)
        toks = nxt[:, None]
    return torch.stack(out, dim=1), cache
