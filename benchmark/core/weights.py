"""Seeded random weights, drawn on the device in the type they are served
in (bfloat16), one flat ``normal_`` call a layer.

The same (seed, part) gives the same bits on the same device, so the
program's set-up and the plain reference draw each part themselves: the
reference takes nothing the program made. Layout: matrices ``[in, out]``
(a projection is ``x @ w``), experts ``[E, in, out]`` with gate and up
fused as ``[E, H, 2N]``. Distribution: matrices N(0, 0.4 / sqrt(fan_in)),
the embedding and the output head N(0, 0.02), norms 1 + N(0, 0.1), biases
N(0, 0.1).
"""

from __future__ import annotations

import hashlib

import torch

from .arch import Arch

DTYPE = torch.bfloat16


def _attention_leaves(a: Arch) -> list[tuple[str, tuple]]:
    h = a.hidden
    if a.attention == "mla":
        return [("wq", (h, a.heads * a.qk_dim)),
                ("kv_a", (h, a.kv_lora + a.qk_rope)),
                ("kv_a_norm", (a.kv_lora,)),
                ("kv_b", (a.kv_lora, a.heads * (a.qk_nope + a.v_dim))),
                ("wo", (a.heads * a.v_dim, h))]
    q, kv = a.heads * a.head_dim, a.kv_heads * a.head_dim
    out = [("wq", (h, q)), ("wk", (h, kv)), ("wv", (h, kv)), ("wo", (q, h))]
    if a.qkv_bias:
        out += [("bq", (q,)), ("bk", (kv,)), ("bv", (kv,))]
    return out


def leaves(a: Arch, part: str) -> list[tuple[str, tuple]]:
    """(name, shape) of a part: ``"outer"`` (embedding, final norm, output
    head), ``"dense"`` (a leading dense layer) or ``"moe"`` (an MoE layer)."""
    h = a.hidden
    if part == "outer":
        return [("embed", (a.vocab, h)), ("final_norm", (h,)), ("lm_head", (h, a.vocab))]
    common = _attention_leaves(a) + [("input_norm", (h,)), ("post_attn_norm", (h,))]
    if part == "dense":
        return common + [("mlp_gate_up", (h, 2 * a.dense_n)), ("mlp_down", (a.dense_n, h))]
    out = common + [("router", (h, a.experts)),
                    ("expert_gate_up", (a.experts, h, 2 * a.expert_n)),
                    ("expert_down", (a.experts, a.expert_n, h))]
    if a.shared_n:
        out += [("shared_gate_up", (h, 2 * a.shared_n)), ("shared_down", (a.shared_n, h))]
        if a.shared_gate:
            out.append(("shared_gate", (h, 1)))
    return out


def subseed(seed: int, tag: str) -> int:
    """A 63-bit generator seed for one part of the run drawn from
    ``seed`` (any integer)."""
    d = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(d[:8], "little") >> 1


def draw(a: Arch, seed: int, part: str, index: int = 0, device="cuda") -> dict:
    """One part's weights {name: bf16 tensor} (``index``: the layer within
    the dense or MoE layers), from one flat draw of the part's generator."""
    shapes = leaves(a, part)
    sizes = [int(torch.Size(s).numel()) for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(subseed(seed, f"weights:{part}:{index}"))
    flat = torch.empty((sum(sizes),), dtype=DTYPE, device=device).normal_(generator=gen)
    out, off = {}, 0
    for (name, shape), n in zip(shapes, sizes):
        t = flat[off: off + n].view(shape)
        off += n
        if name.endswith("norm"):
            t.mul_(0.1).add_(1.0)
        elif len(shape) == 1:
            t.mul_(0.1)
        elif name in ("embed", "lm_head"):
            t.mul_(0.02)
        else:
            t.mul_(0.4 / shape[-2] ** 0.5)
        out[name] = t
    return out


def draw_layer(a: Arch, seed: int, layer: int, device="cuda") -> tuple[dict, bool]:
    """Decoder layer ``layer`` (dense layers first) -> (weights, dense)."""
    if layer < a.dense_layers:
        return draw(a, seed, "dense", layer, device), True
    return draw(a, seed, "moe", layer - a.dense_layers, device), False
