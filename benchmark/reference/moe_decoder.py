"""Plain float32 reference of the quantized MoE decoder the cells serve
(``qwen2_moe``: GQA with q/k/v bias, half-split RoPE, a gated shared expert;
``deepseek_v2``: MLA without a query LoRA, interleaved RoPE, a dense first
layer, two shared experts as one). No kernels, no cache, no batching.

It states the configuration's arithmetic with the rounding left out:
every float product runs in float32 over the bfloat16 weights (TF32 off),
and only the quantization the configuration names is applied, as the
configuration file's ``quant`` section names it:

- routed experts: per-channel symmetric weights (``amax / (2^(b-1) - 1)``
  per output column, codes rounded and clipped) and per-token symmetric
  activations (``max(amax, 1e-8) / (2^(b-1) - 1)``) before each of the two
  products, the schemes alternating over the experts (even: the first);
- the shared expert(s): the same, at its scheme;
- the KV cache: each key and value vector of a position and head rounded to
  int8 with a scale of ``max(amax, 1e-8) / 127``, before attention reads it;
- attention, the router, the dense layer, norms and the output head: float.

``variant="control"`` computes every quantity one precision step below
what the configuration states: the weights and activations of the 8-bit
routed experts and of the shared expert, and the KV cache, at 4 bits
("int4 for int8"); every bfloat16 product with a weight (the attention
projections, the router, the shared expert's gate, the dense layer and the
output head) at w8a8, per output column and per token ("int8 for
bfloat16"). The 4-bit experts have no step below and stay. It is the step
a faster path would be tempted to take.
"""

from __future__ import annotations

import math
import re

import torch

from benchmark.core import weights as W
from benchmark.core.arch import Arch

def parse_scheme(name: str) -> tuple[int, int]:
    """``w<b>a<b>_g-1_sym`` -> (weight bits, activation bits)."""
    m = re.fullmatch(r"w(\d+)a(\d+)_g-1_sym", name)
    if m is None:
        raise ValueError(f"reference: scheme {name!r} is not per-channel symmetric "
                         "w x a (w<b>a<b>_g-1_sym)")
    return int(m.group(1)), int(m.group(2))


def _lower(bits: int, variant: str) -> int:
    return 4 if variant == "control" and bits == 8 else bits


def _upper(bits: int) -> float:
    return float((1 << (bits - 1)) - 1)


def quant_weight(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-output-column symmetric fake quant of ``w`` [..., K, N] (f32)."""
    up = _upper(bits)
    scale = w.abs().amax(-2, keepdim=True) / up
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    return torch.round(torch.clamp(w / safe, -up, up)) * scale


def quant_rows(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-row (token, or key / value vector) symmetric fake quant."""
    scale = torch.clamp(x.abs().amax(-1, keepdim=True), min=1e-8) / _upper(bits)
    return torch.round(x / scale) * scale


def linear(x: torch.Tensor, w: torch.Tensor, lower: bool) -> torch.Tensor:
    """``x @ w`` over a bfloat16 weight; ``lower``: both at int8 (w8a8)."""
    if lower:
        return quant_rows(x, 8) @ quant_weight(w, 8)
    return x @ w


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _rope_half(x, pos, theta):
    """x [S, n, d]; HF rotate_half convention."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float64) / d)
    ang = (pos.double()[:, None] * inv).float()                  # [S, d/2]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _rope_pairs(x, pos, theta):
    """x [S, n, d]; (x[2i], x[2i+1]) rotated as a complex number."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float64) / d)
    ang = (pos.double()[:, None] * inv).float()
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1).reshape(x.shape)


def _causal(q, k, v, scale):
    """q [S, n, dq], k [S, n, dq], v [S, n, dv] -> [S, n * dv]."""
    s = q.shape[0]
    scores = torch.einsum("snd,tnd->nst", q, k) * scale
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("nst,tnd->snd", probs, v).reshape(s, -1)


def attention(a: Arch, x, lw, kv_bits: int, lower: bool = False):
    """One sequence's attention [S, H] -> [S, H], keys and values rounded
    as the cache stores them; ``lower``: the projections at w8a8."""
    s = x.shape[0]
    pos = torch.arange(s, device=x.device)
    f = {k: t.float() for k, t in lw.items() if not k.startswith(("expert", "shared", "mlp"))}
    if a.attention == "mla":
        q = linear(x, f["wq"], lower).reshape(s, a.heads, a.qk_dim)
        ckv = linear(x, f["kv_a"], lower)
        c = rms_norm(ckv[:, : a.kv_lora], f["kv_a_norm"], a.eps)
        kv = linear(c, f["kv_b"], lower).reshape(s, a.heads, a.qk_nope + a.v_dim)
        k_pe = _rope_pairs(ckv[:, None, a.kv_lora:], pos, a.rope_theta)
        q = torch.cat([q[..., : a.qk_nope], _rope_pairs(q[..., a.qk_nope:], pos, a.rope_theta)], -1)
        k = torch.cat([kv[..., : a.qk_nope], k_pe.expand(s, a.heads, a.qk_rope)], -1)
        v = kv[..., a.qk_nope:]
    else:
        q, k, v = (linear(x, f[w], lower) for w in ("wq", "wk", "wv"))
        if a.qkv_bias:
            q, k, v = q + f["bq"], k + f["bk"], v + f["bv"]
        q = _rope_half(q.reshape(s, a.heads, a.head_dim), pos, a.rope_theta)
        k = _rope_half(k.reshape(s, a.kv_heads, a.head_dim), pos, a.rope_theta)
        v = v.reshape(s, a.kv_heads, a.head_dim)
        rep = a.heads // a.kv_heads
        k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    if kv_bits < 16:
        k, v = quant_rows(k, kv_bits), quant_rows(v, kv_bits)
    return linear(_causal(q, k, v, 1.0 / math.sqrt(a.qk_dim)), f["wo"], lower)


def _swiglu(x, gate_up, down, bits=None):
    """SwiGLU with optional (w bits, a bits) fake quant of both products
    (``gate_up`` [.., H, 2N], ``down`` [.., N, H], float32)."""
    if bits is not None:
        gate_up, down = quant_weight(gate_up, bits[0]), quant_weight(down, bits[0])
        x = quant_rows(x, bits[1])
    gu = x @ gate_up
    n = gu.shape[-1] // 2
    h = torch.nn.functional.silu(gu[:, :n]) * gu[:, n:]
    if bits is not None:
        h = quant_rows(h, bits[1])
    return h @ down


def moe(a: Arch, x, lw, quant: dict, variant: str):
    """The routed and shared experts over tokens x [T, H]."""
    lower = variant == "control"
    probs = torch.softmax(linear(x, lw["router"].float(), lower), dim=-1)
    wts, ids = torch.topk(probs, a.top_k, dim=-1)
    if a.norm_topk:
        wts = wts / wts.sum(-1, keepdim=True)
    wts = wts * a.routed_scale
    schemes = [parse_scheme(n) for n in quant["routed_schemes"]]
    if quant.get("routed_split", "alternating") != "alternating":
        raise ValueError("reference: only the alternating routed split is stated")
    y = torch.zeros_like(x)
    for e in ids.unique().tolist():
        tok, slot = (ids == e).nonzero(as_tuple=True)
        wb, ab = schemes[e % len(schemes)]
        bits = (_lower(wb, variant), _lower(ab, variant))
        out = _swiglu(x[tok], lw["expert_gate_up"][e].float(), lw["expert_down"][e].float(), bits)
        y.index_add_(0, tok, out * wts[tok, slot][:, None])
    if a.shared_n:
        wb, ab = parse_scheme(quant["shared_scheme"])
        sh = _swiglu(x, lw["shared_gate_up"].float(), lw["shared_down"].float(),
                     (_lower(wb, variant), _lower(ab, variant)))
        if a.shared_gate:
            sh = sh * torch.sigmoid(linear(x, lw["shared_gate"].float(), lower))
        y = y + sh
    return y


def served_logits(a: Arch, quant: dict, seed: int, seqs: list[tuple[list[int], int]],
                  variants=("stated",), device="cuda") -> dict:
    """Logits at the positions that predicted each sequence's served
    tokens: ``seqs`` holds (the prompt followed by its m served tokens, the
    prompt's length P); the rows are positions P - 1 .. P + m - 2 ->
    {variant: [f32 [m, V] per sequence]}. Weights are drawn from ``seed``
    one layer at a time."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _served_logits(a, quant, seed, seqs, variants, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _served_logits(a, quant, seed, seqs, variants, device):
    kv_bits = int(quant.get("kv_cache_bits", 16))
    kv = {v: _lower(kv_bits, v) for v in variants}
    outer = W.draw(a, seed, "outer", 0, device)
    fed = [toks[:-1] for toks, _ in seqs]          # the last served token feeds nothing
    lens = [len(t) for t in fed]
    ids = torch.tensor([t for toks in fed for t in toks], device=device)
    xs = {v: outer["embed"][ids].float() for v in variants}
    for layer in range(a.layers):
        lw, dense = W.draw_layer(a, seed, layer, device)
        for v in variants:
            x = xs[v]
            lower = v == "control"
            attn = torch.cat([attention(a, rms_norm(p, lw["input_norm"], a.eps), lw, kv[v],
                                        lower) for p in torch.split(x, lens)])
            h = x + attn
            hn = rms_norm(h, lw["post_attn_norm"], a.eps)
            if dense:
                xs[v] = h + _swiglu(hn, lw["mlp_gate_up"].float(), lw["mlp_down"].float(),
                                    (8, 8) if lower else None)
            else:
                xs[v] = h + moe(a, hn, lw, quant, v)
        del lw
    head = (outer["embed"].T if a.tie_embed else outer["lm_head"]).float()
    out = {}
    for v in variants:
        rows, off = [], 0
        for (_, p), n in zip(seqs, lens):
            rows.append(linear(rms_norm(xs[v][off + p - 1: off + n], outer["final_norm"], a.eps),
                               head, v == "control"))
            off += n
        out[v] = rows
    return out
