"""Model operations from the published widths, whatever implements them.

A token costs 2 operations per parameter it uses (attention projections,
the router, its top-k routed experts, the shared experts or a dense
layer's MLP, the output head) plus attention's two products over the keys
it attends (its own position included): 2 x heads x (query/key width +
value width) per key and layer.
"""

from __future__ import annotations

from .arch import Arch


def _attn_params(a: Arch) -> int:
    h = a.hidden
    if a.attention == "mla":
        return (h * a.heads * a.qk_dim + h * (a.kv_lora + a.qk_rope)
                + a.kv_lora * a.heads * (a.qk_nope + a.v_dim) + a.heads * a.v_dim * h)
    q, kv = a.heads * a.head_dim, a.kv_heads * a.head_dim
    return 2 * h * q + 2 * h * kv


def params_per_token(a: Arch) -> int:
    """Parameters one token multiplies (norms and biases left out)."""
    h = a.hidden
    moe = (h * a.experts + a.top_k * 3 * h * a.expert_n + 3 * h * a.shared_n
           + (h if a.shared_gate else 0))
    dense = 3 * h * a.dense_n
    return (a.layers * _attn_params(a) + a.moe_layers * moe + a.dense_layers * dense
            + h * a.vocab)


def ops_per_key(a: Arch) -> int:
    """Operations of one query position over one key, all layers."""
    return 2 * a.layers * a.heads * (a.qk_dim + a.vo_dim)


def token_ops(a: Arch, n_tokens: int, keys: int) -> int:
    """Operations of ``n_tokens`` tokens that attend ``keys`` keys in all."""
    return 2 * params_per_token(a) * n_tokens + ops_per_key(a) * keys

