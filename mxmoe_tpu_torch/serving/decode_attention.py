"""Decode attention over the KV cache (port of
``mxmoe_tpu/serving/decode_attention.py``), in
``csrc/decode_attention.cu`` (bf16 cache) and ``decode_attention_q8.cu``
(int8 cache) over one body in ``decode_attention_tile.cuh``:

- ``decode_attention_update_stacked``, the serving path's: kernels K3 (bf16
  cache) and K3q (int8 cache). One call per decode layer: write this step's
  K/V at ``lengths[b]`` of layer ``layer`` of the stacked [L, B, n_kv, S, hd]
  caches (IN PLACE; the write is skipped for ``valid[b] == 0`` or a full
  slot), then attend over positions [0, min(lengths[b], S-1)]. With
  ``cache_ks`` / ``cache_vs`` given (the ``QuantKVCache`` layout: int8 codes
  and [L, B, n_kv, S] f32 scales) the step's vectors are quantized per
  (slot, kv head) as ``kv_cache._quant_vec`` does, codes and scales are
  written, and the scales fold into the scores and the probs; the new
  position is attended from its quantized form.
- The read-only forms, the same kernel bodies compiled without the write:
  ``decode_attention_stacked`` (the stacked cache, bf16 or int8, clamped to
  S-1), ``decode_attention`` (a per-layer [B, n_kv, S, d] bf16 cache) and
  ``decode_attention_q8`` (its int8 form with [B, n_kv, S] f32 scales). The
  per-layer forms do not clamp: a slot with ``lengths[b] >= S`` attends all
  S positions, which is what the clamp gives. The reference's per-layer
  kernels refuse a stacked 5D cache (their block specs are 4D), and so do
  these. ``block_s`` (the reference's S block) is accepted for parity and
  changes nothing: the kernels split S into chunks of their own.

Every kernel takes the K3 domain: G = n_h / n_kv <= 8, dk in {32, 64, 128,
256}, dv <= 128 and a multiple of 8 (16 for an int8 cache); elsewhere a CUDA
tensor raises (a CPU tensor takes the plain version at any shape).

The kernels split S into chunks of ``DA_CHUNK`` positions, one warp each,
in tiles of ``DA_TILE`` positions with an online softmax per warp; a block's
chunks are merged in order, then the blocks' partials in order (``decode_attn_schedule`` sizes the
workspace; ``decode_attention_split_plain`` emulates that order on the CPU
for the tests).
"""

from __future__ import annotations

import torch

from ..ops import kernels
from .kv_cache import _quant_vec


DA_CHUNK = 64      # positions of one warp's chunk
DA_WARPS = 4       # warps (chunks) of one block: an S-block of 4 chunks
DA_TILE = 16       # positions of one staged tile inside a chunk


def supports_fused_decode(dk: int, dv: int, quant: bool) -> bool:
    """Whether K3 / K3q (and the read-only forms) take head dims ``dk`` /
    ``dv`` over a bf16 (``quant`` False) or int8 cache."""
    return dk in (32, 64, 128, 256) and dv <= 128 and dv % (16 if quant else 8) == 0


def decode_attn_schedule(b: int, n_h: int, n_kv: int, s_max: int, dv: int) -> dict:
    """The kernels' split of S, in one place: ``DA_CHUNK`` positions a warp,
    S-blocks of ``DA_WARPS`` chunks a block, ``n_split`` = cdiv(S, DA_WARPS *
    DA_CHUNK) block partials per (slot, kv head), the f32 workspace they fill
    ([B, n_kv, n_split, G, dv + 2]) and one ticket per (slot, kv head). The
    C side takes these as given."""
    n_split = -(-s_max // (DA_WARPS * DA_CHUNK))
    return {"chunk": DA_CHUNK, "n_split": n_split,
            "ws_floats": b * n_h * n_split * (dv + 2), "tickets": b * n_kv,
            "blocks": n_kv * b * n_split}


def _merge(parts):
    """Partials (acc, max, sum) merged in their order."""
    m_all = torch.stack([p[1] for p in parts]).amax(0)
    l_all = torch.zeros_like(parts[0][2])
    a_all = torch.zeros_like(parts[0][0])
    for acc, m, l in parts:
        f = torch.exp(m - m_all)
        l_all = l_all + l * f
        a_all = a_all + acc * f[..., None]
    return a_all, m_all, l_all


def decode_attention_split_plain(q, keys, vals, k_sc, v_sc, lengths, scale,
                                 chunk: int = DA_CHUNK, tile: int = DA_TILE):
    """The kernels' order of work, in plain f32 PyTorch (for the tests): the
    attended positions of a slot in chunks of ``chunk``, each chunk an online
    softmax over tiles of ``tile`` positions -> (acc, max, sum); the chunks
    of an S-block (``DA_WARPS`` of them) merged in order, then the blocks in
    order. ``keys`` / ``vals`` [B, n_kv, S, d] (int8 codes as floats with
    scales [B, n_kv, S], or None). Returns [B, n_h, dv] f32."""
    b, n_h, dk = q.shape
    n_kv, s_max, dv = keys.shape[1], keys.shape[2], vals.shape[-1]
    g = n_h // n_kv
    qg = q.float().reshape(b, n_kv, g, dk)
    out = torch.empty((b, n_kv, g, dv), dtype=torch.float32)
    for bi in range(b):
        n_pos = min(max(int(lengths[bi]), 0), s_max - 1) + 1
        chunks = []
        for c0 in range(0, n_pos, chunk):
            m = torch.full((n_kv, g), float("-inf"))
            l = torch.zeros((n_kv, g))
            acc = torch.zeros((n_kv, g, dv))
            for p0 in range(c0, min(c0 + chunk, n_pos), tile):
                p1 = min(p0 + tile, c0 + chunk, n_pos)
                s = torch.einsum("ngd,npd->ngp", qg[bi], keys[bi, :, p0:p1].float())
                if k_sc is not None:
                    s = s * k_sc[bi, :, None, p0:p1]
                s = s * scale
                m_new = torch.maximum(m, s.amax(-1))
                e = torch.exp(s - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + e.sum(-1)
                m = m_new
                if v_sc is not None:
                    e = e * v_sc[bi, :, None, p0:p1]
                acc = acc * alpha[..., None] + torch.einsum(
                    "ngp,npd->ngd", e, vals[bi, :, p0:p1].float())
            chunks.append((acc, m, l))
        blocks = [_merge(chunks[i:i + DA_WARPS]) for i in range(0, len(chunks), DA_WARPS)]
        a_all, _, l_all = _merge(blocks)
        out[bi] = a_all / l_all.clamp_min(1e-30)[..., None]
    return out.reshape(b, n_h, dv)


def _workspace(b, n_h, n_kv, s_max, dv, device):
    """The launch's workspace and tickets, sized by ``decode_attn_schedule``
    -> (ws pointer, tickets pointer, chunk, n_split, workspace tensor)."""
    sch = decode_attn_schedule(b, n_h, n_kv, s_max, dv)
    ws = torch.empty((sch["ws_floats"],), dtype=torch.float32, device=device)
    tk = kernels.tickets(device, sch["tickets"])
    return ws.data_ptr(), tk.data_ptr(), sch["chunk"], sch["n_split"], ws


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


def _check_kernel_operands(name, q, cache_k, cache_ks, cache_v, cache_vs,
                           lengths, layer):
    """The checks every kernel of this file makes of q, the stacked caches
    [L, B, n_kv, S, d] (bf16, or int8 with [L, B, n_kv, S] f32 scales),
    ``lengths`` and ``layer``; raises ValueError (the K3 domain)."""
    req = kernels.require
    quant = cache_ks is not None
    b, n_h, dk = q.shape
    req(cache_k.dim() == 5 and cache_v.dim() == 5, f"{name}: 5D stacked caches")
    nl, cb, n_kv, _, _ = cache_k.shape
    dv = cache_v.shape[-1]
    dev = q.device
    caches = (cache_k, cache_ks, cache_v, cache_vs) if quant else (cache_k, cache_v)
    req(all(t.is_cuda and t.device == dev and t.is_contiguous()
            for t in (q, *caches, lengths)),
        f"{name}: operands must be contiguous tensors on one CUDA device")
    req(q.dtype in (torch.bfloat16, torch.float32), f"{name}: q must be bf16/f32")
    code_dtype = torch.int8 if quant else torch.bfloat16
    req(cache_k.dtype == code_dtype and cache_v.dtype == code_dtype,
        f"{name}: caches must be {code_dtype}"
        + (" with float32 scales" if quant else ""))
    req(cb == b and cache_v.shape[:4] == cache_k.shape[:4]
        and cache_k.shape[-1] == dk and n_h % n_kv == 0,
        f"{name}: inconsistent shapes")
    if quant:
        req(cache_ks.dtype == torch.float32 and cache_vs.dtype == torch.float32
            and cache_ks.shape == cache_k.shape[:4]
            and cache_vs.shape == cache_k.shape[:4],
            f"{name}: scales must be float32 [L, B, n_kv, S]")
    req(lengths.dtype == torch.int32 and lengths.shape == (b,),
        f"{name}: lengths must be int32 [B]")
    req(0 <= layer < nl, f"{name}: layer {layer}")
    req(n_h // n_kv <= 8 and supports_fused_decode(dk, dv, quant),
        f"{name}: needs G<=8, dk in 32/64/128/256, dv<=128 and a multiple of "
        "8 (16 for the int8 cache)")


def _plain_attention(q, keys, vals, k_sc, v_sc, lengths, scale):
    """Full-softmax attention of one step over one layer's cache in f32
    ([B, n_kv, S, d]); optional per-position scales [B, n_kv, S]. A slot
    attends positions [0, min(lengths[b], S-1)]; with scales, the softmax
    sums the unscaled probs and positions out of range are masked to 0
    again after the v-scale multiply (a scale there may be garbage)."""
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
        probs = torch.where(mask[:, None, None, :], probs * v_sc[:, :, None, :],
                            0.0)
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
    _check_kernel_operands(name, q, cache_k, cache_ks, cache_v, cache_vs,
                           lengths, layer)
    n_kv, s_max, dv = cache_k.shape[2], cache_k.shape[3], cache_v.shape[-1]
    dev = q.device
    valid = valid.to(torch.int32)
    req = kernels.require
    req(all(t.is_cuda and t.device == dev and t.is_contiguous()
            for t in (k_new, v_new, valid)),
        f"{name}: operands must be contiguous tensors on one CUDA device")
    req(k_new.dtype == q.dtype and v_new.dtype == q.dtype
        and k_new.shape == (b, n_kv, dk) and v_new.shape == (b, n_kv, dv)
        and valid.shape == (b,), f"{name}: k_new / v_new / valid")
    lib = kernels.lib()
    out = torch.empty((b, n_h, dv), dtype=q.dtype, device=dev)
    ws, tk, chunk, n_split, _ws = _workspace(b, n_h, n_kv, s_max, dv, dev)
    head = (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            int(q.dtype == torch.bfloat16))
    tail = (lengths.data_ptr(), valid.data_ptr(), out.data_ptr(), ws, tk,
            int(layer), b, n_h, n_kv, s_max, dk, dv, chunk, n_split, float(scale),
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


def decode_attention_stacked_plain(q, cache_k, cache_ks, cache_v, cache_vs,
                                   lengths, layer: int, scale: float):
    """Plain PyTorch version of the read-only stacked kernel (full softmax)."""
    k_sc = None if cache_ks is None else cache_ks[layer]
    v_sc = None if cache_vs is None else cache_vs[layer]
    return _plain_attention(q, cache_k[layer].float(), cache_v[layer].float(),
                            k_sc, v_sc, lengths, scale)


def _read_only_launch(name, q, cache_k, cache_ks, cache_v, cache_vs, lengths,
                      layer: int, scale: float):
    """One launch of the read-only kernel over stacked caches -> out."""
    _check_kernel_operands(name, q, cache_k, cache_ks, cache_v, cache_vs,
                           lengths, layer)
    b, n_h, dk = q.shape
    n_kv, s_max, dv = cache_k.shape[2], cache_k.shape[3], cache_v.shape[-1]
    lib = kernels.lib()
    out = torch.empty((b, n_h, dv), dtype=q.dtype, device=q.device)
    ws, tk, chunk, n_split, _ws = _workspace(b, n_h, n_kv, s_max, dv, q.device)
    head = (q.data_ptr(), int(q.dtype == torch.bfloat16))
    tail = (lengths.data_ptr(), out.data_ptr(), ws, tk, int(layer), b, n_h, n_kv,
            s_max, dk, dv, chunk, n_split, float(scale), kernels.stream_ptr(q.device))
    if cache_ks is None:
        err = lib.mxmoe_decode_attention(*head, cache_k.data_ptr(),
                                         cache_v.data_ptr(), *tail)
    else:
        err = lib.mxmoe_decode_attention_q8(
            *head, cache_k.data_ptr(), cache_ks.data_ptr(), cache_v.data_ptr(),
            cache_vs.data_ptr(), *tail)
    kernels.check(err, name)
    kernels.launches[name] += 1
    return out


def decode_attention_stacked(
    q: torch.Tensor,        # [B, n_h, dk]
    cache_k: torch.Tensor,  # [L, B, n_kv, S, dk] bf16 (int8 with scales)
    cache_ks,               # [L, B, n_kv, S] f32, or None (bf16 cache)
    cache_v: torch.Tensor,  # [L, B, n_kv, S, dv]
    cache_vs,
    lengths: torch.Tensor,  # [B] int32: the query sits at position lengths[b]
    layer: int,
    scale: float | None = None,
    block_s: int = 512,
):
    """Read-only decode attention of one layer of the stacked cache ->
    ``(out [B, n_h, dv], caches)``, ``caches`` the argument tensors,
    unchanged: ``(cache_k, cache_v)`` or ``(cache_k, cache_ks, cache_v,
    cache_vs)``. Positions [0, min(lengths[b], S-1)]. The int8 form scales
    the scores by ``k_sc[t]`` and then ``scale``, and the P.V weights by
    ``v_sc[t]``; the normaliser sums the unscaled probs. The kernel is K3's
    body without the write (``decode_attention_stacked``, with an int8
    cache ``decode_attention_stacked_q8``)."""
    del block_s
    quant = cache_ks is not None
    if quant != (cache_vs is not None):
        raise ValueError("decode_attention_stacked: cache_ks and cache_vs come "
                         "together")
    layer = int(layer)
    scale = scale if scale is not None else 1.0 / float(q.shape[-1]) ** 0.5
    caches = (cache_k, cache_ks, cache_v, cache_vs) if quant else (cache_k, cache_v)
    if q.device.type == "cpu":
        return decode_attention_stacked_plain(q, cache_k, cache_ks, cache_v,
                                              cache_vs, lengths, layer, scale), caches
    name = "decode_attention_stacked" + ("_q8" if quant else "")
    return _read_only_launch(name, q, cache_k, cache_ks, cache_v, cache_vs,
                             lengths, layer, scale), caches


def _per_layer(name, *caches):
    for c in caches:
        if c.dim() != 4:
            raise ValueError(f"{name}: a per-layer [B, n_kv, S, d] cache, got "
                             f"{tuple(c.shape)} (the stacked cache takes "
                             "decode_attention_stacked)")


def decode_attention(
    q: torch.Tensor,        # [B, n_h, dk] single-position queries
    cache_k: torch.Tensor,  # [B, n_kv, S, dk] bf16
    cache_v: torch.Tensor,  # [B, n_kv, S, dv]
    lengths: torch.Tensor,  # [B] int32: the query sits at position lengths[b]
    scale: float | None = None,
    block_s: int = 512,
) -> torch.Tensor:
    """Read-only decode attention over a per-layer cache -> [B, n_h, dv]
    (kernel ``decode_attention``)."""
    del block_s
    _per_layer("decode_attention", cache_k, cache_v)
    scale = scale if scale is not None else 1.0 / float(q.shape[-1]) ** 0.5
    if q.device.type == "cpu":
        return _plain_attention(q, cache_k.float(), cache_v.float(), None, None,
                                lengths, scale)
    return _read_only_launch("decode_attention", q, cache_k[None], None,
                             cache_v[None], None, lengths, 0, scale)


def decode_attention_q8(
    q: torch.Tensor,         # [B, n_h, dk]
    cache_kq: torch.Tensor,  # [B, n_kv, S, dk] int8
    cache_ks: torch.Tensor,  # [B, n_kv, S] f32
    cache_vq: torch.Tensor,  # [B, n_kv, S, dv] int8
    cache_vs: torch.Tensor,  # [B, n_kv, S] f32
    lengths: torch.Tensor,
    scale: float | None = None,
    block_s: int = 512,
) -> torch.Tensor:
    """The int8 form of :func:`decode_attention`: the scales fold into the
    scores and the P.V weights (kernel ``decode_attention_q8``)."""
    del block_s
    _per_layer("decode_attention_q8", cache_kq, cache_vq)
    scale = scale if scale is not None else 1.0 / float(q.shape[-1]) ** 0.5
    if q.device.type == "cpu":
        return _plain_attention(q, cache_kq.float(), cache_vq.float(), cache_ks,
                                cache_vs, lengths, scale)
    return _read_only_launch("decode_attention_q8", q, cache_kq[None],
                             cache_ks[None], cache_vq[None], cache_vs[None],
                             lengths, 0, scale)
