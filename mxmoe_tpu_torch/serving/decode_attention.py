"""Fused decode-step cache write + attention (port of
``mxmoe_tpu/serving/decode_attention.py:decode_attention_update_stacked``)
— kernels K3 (bf16 cache) and K3q (int8 cache), ``csrc/decode_attention.cu``.

One call per decode layer: write this step's K/V at ``lengths[b]`` of
layer ``layer`` of the stacked [L, B, n_kv, S, hd] caches (IN PLACE; the
write is skipped for ``valid[b] == 0`` or a full slot), then attend over
positions [0, min(lengths[b], S-1)].

With ``cache_ks`` / ``cache_vs`` given (the ``QuantKVCache`` layout: int8
codes and [L, B, n_kv, S] f32 scales) the step's vectors are quantized per
(slot, kv head) as ``kv_cache._quant_vec`` does, codes and scales are
written, and the scales fold into the scores and the probs; the new
position is attended from its quantized form.
"""

from __future__ import annotations

import torch

from ..ops import kernels
from .kv_cache import _quant_vec


def _masked_step_write(cache, new, lengths, layer, valid):
    """Sync-free masked write of one position per slot into ``cache``
    [L, B, n_kv, S, ...]: a dropped write stores back the value already at
    its (clamped) position."""
    s_max = cache.shape[3]
    ok = (valid != 0) & (lengths < s_max) & (lengths >= 0)
    pos = lengths.long().clamp(0, s_max - 1)
    bi = torch.arange(new.shape[0], device=new.device)
    cur = cache[layer, bi, :, pos]                         # [B, n_kv, ...]
    ok = ok.reshape(-1, *([1] * (cur.dim() - 1)))
    cache[layer, bi, :, pos] = torch.where(ok, new.to(cache.dtype), cur)


def _plain_attention(q, keys, vals, k_sc, v_sc, lengths, scale):
    """Full-softmax attention of one step over one layer's cache in f32
    ([B, n_kv, S, d]); optional per-position scales [B, n_kv, S]."""
    b, n_h, dk = q.shape
    n_kv, s_max = keys.shape[1], keys.shape[2]
    qg = q.float().reshape(b, n_kv, n_h // n_kv, dk)
    scores = torch.einsum("bngd,bnsd->bngs", qg, keys)
    if k_sc is not None:
        scores = scores * k_sc[:, :, None, :]
    scores = scores * scale
    length = lengths.long().clamp(max=s_max - 1)
    mask = torch.arange(s_max, device=q.device)[None, :] <= length[:, None]
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    if v_sc is not None:
        probs = probs * v_sc[:, :, None, :]
    out = torch.einsum("bngs,bnsd->bngd", probs, vals)
    return out.reshape(b, n_h, -1).to(q.dtype)


def decode_attention_update_plain(q, k_new, v_new, cache_k, cache_v, lengths,
                                  layer: int, valid, scale: float):
    """Plain PyTorch version of K3 (same in-place write, full softmax)."""
    _masked_step_write(cache_k, k_new, lengths, layer, valid)
    _masked_step_write(cache_v, v_new, lengths, layer, valid)
    return _plain_attention(q, cache_k[layer].float(), cache_v[layer].float(),
                            None, None, lengths, scale)


def decode_attention_update_q8_plain(q, k_new, v_new, cache_k, cache_ks,
                                     cache_v, cache_vs, lengths, layer: int,
                                     valid, scale: float):
    """Plain PyTorch version of K3q: quantize the step's vectors, write
    codes and scales in place, attend over the int8 cache."""
    kq, ks = _quant_vec(k_new)                              # [B, n_kv, d], [B, n_kv]
    vq, vs = _quant_vec(v_new)
    _masked_step_write(cache_k, kq, lengths, layer, valid)
    _masked_step_write(cache_ks, ks, lengths, layer, valid)
    _masked_step_write(cache_v, vq, lengths, layer, valid)
    _masked_step_write(cache_vs, vs, lengths, layer, valid)
    return _plain_attention(q, cache_k[layer].float(), cache_v[layer].float(),
                            cache_ks[layer], cache_vs[layer], lengths, scale)


def decode_attention_update_stacked(
    q: torch.Tensor,        # [B, n_h, dk]
    k_new: torch.Tensor,    # [B, n_kv, dk] this step's key vectors
    v_new: torch.Tensor,    # [B, n_kv, dv]
    cache_k: torch.Tensor,  # [L, B, n_kv, S, dk] bf16 (int8 with scales)
    cache_ks,               # [L, B, n_kv, S] f32, or None (bf16 cache)
    cache_v: torch.Tensor,  # [L, B, n_kv, S, dv]
    cache_vs,
    lengths: torch.Tensor,  # [B] int32: the write position AND attention bound
    layer: int,
    valid: torch.Tensor | None = None,   # [B] write mask (default all)
    scale: float | None = None,
):
    """Returns ``(out [B, n_h, dv], caches)`` with ``caches`` the argument
    tensors, written in place: ``(cache_k, cache_v)`` for the bf16 cache,
    ``(cache_k, cache_ks, cache_v, cache_vs)`` for the int8 cache."""
    name = "decode_attention_update_stacked"
    quant = cache_ks is not None
    if quant != (cache_vs is not None):
        raise ValueError(f"{name}: cache_ks and cache_vs come together")
    b, n_h, dk = q.shape
    scale = scale if scale is not None else 1.0 / float(dk) ** 0.5
    if valid is None:
        valid = torch.ones((b,), dtype=torch.int32, device=q.device)
    caches = (cache_k, cache_ks, cache_v, cache_vs) if quant else (cache_k, cache_v)
    if q.device.type == "cpu":
        if quant:
            out = decode_attention_update_q8_plain(
                q, k_new, v_new, cache_k, cache_ks, cache_v, cache_vs, lengths,
                layer, valid, scale)
        else:
            out = decode_attention_update_plain(q, k_new, v_new, cache_k, cache_v,
                                                lengths, layer, valid, scale)
        return out, caches
    req = kernels.require
    nl, cb, n_kv, s_max, _ = cache_k.shape
    dv = cache_v.shape[-1]
    dev = q.device
    valid = valid.to(torch.int32)
    req(all(t.is_cuda and t.device == dev and t.is_contiguous()
            for t in (q, k_new, v_new, *caches, lengths, valid)),
        f"{name}: operands must be contiguous tensors on one CUDA device")
    req(q.dtype in (torch.bfloat16, torch.float32)
        and k_new.dtype == q.dtype and v_new.dtype == q.dtype,
        f"{name}: q/k_new/v_new must share bf16/f32")
    code_dtype = torch.int8 if quant else torch.bfloat16
    req(cache_k.dtype == code_dtype and cache_v.dtype == code_dtype,
        f"{name}: caches must be {code_dtype}"
        + (" with float32 scales" if quant else ""))
    req(cb == b and cache_v.shape[:4] == cache_k.shape[:4]
        and cache_k.shape[-1] == dk and k_new.shape == (b, n_kv, dk)
        and v_new.shape == (b, n_kv, dv) and n_h % n_kv == 0,
        f"{name}: inconsistent shapes")
    if quant:
        req(cache_ks.dtype == torch.float32 and cache_vs.dtype == torch.float32
            and cache_ks.shape == cache_k.shape[:4]
            and cache_vs.shape == cache_k.shape[:4],
            f"{name}: scales must be float32 [L, B, n_kv, S]")
    req(lengths.dtype == torch.int32 and lengths.shape == (b,)
        and valid.shape == (b,), f"{name}: lengths/valid")
    req(0 <= layer < nl, f"{name}: layer {layer}")
    req(n_h // n_kv <= 8 and dk in (64, 128, 256) and dv <= 128
        and dv % (16 if quant else 8) == 0,
        f"{name}: needs G<=8, dk in 64/128/256, dv<=128 and a multiple of "
        "8 (16 for the int8 cache)")
    lib = kernels.lib()
    out = torch.empty((b, n_h, dv), dtype=q.dtype, device=dev)
    ws = torch.empty(lib.mxmoe_decode_attention_workspace_floats(
        b, n_h, n_kv, s_max, dv), dtype=torch.float32, device=dev)
    head = (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            int(q.dtype == torch.bfloat16))
    tail = (lengths.data_ptr(), valid.data_ptr(), out.data_ptr(), ws.data_ptr(),
            int(layer), b, n_h, n_kv, s_max, dk, dv, float(scale),
            kernels.stream_ptr(dev))
    if quant:
        err = lib.mxmoe_decode_attention_update_q8(
            *head, cache_k.data_ptr(), cache_ks.data_ptr(), cache_v.data_ptr(),
            cache_vs.data_ptr(), *tail)
        counter = name + "_q8"
    else:
        err = lib.mxmoe_decode_attention_update(
            *head, cache_k.data_ptr(), cache_v.data_ptr(), *tail)
        counter = name
    kernels.check(err, counter)
    kernels.launches[counter] += 1
    return out, caches
