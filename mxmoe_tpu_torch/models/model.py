"""Parameters and output head of the MoE decoder (port of
``mxmoe_tpu/models/model.py``: ``layer_param_shapes``, ``init_params``,
``head_logits`` with its int8 branch).

Layout (as in the JAX package):
  embed        [V, H]
  layers/...   each [L, ...]  (attention, norms, router, experts, shared)
  final_norm   [H]
  lm_head      [H, V]
"""

from __future__ import annotations

import torch

from .configs import MoEConfig


def layer_param_shapes(cfg: MoEConfig) -> dict[str, tuple]:
    if cfg.attention_type != "gqa" or cfg.first_dense_layers:
        raise NotImplementedError(
            "MLA / dense-first-layer families are not ported yet (ROADMAP "
            "queue A: model families)")
    h = cfg.hidden_size
    n = cfg.moe_intermediate_size
    ns = cfg.shared_expert_intermediate_size
    shapes = {
        "wq": (h, cfg.q_dim),
        "wk": (h, cfg.kv_dim),
        "wv": (h, cfg.kv_dim),
        "wo": (cfg.q_dim, h),
    }
    if cfg.attention_bias:
        shapes.update({"bq": (cfg.q_dim,), "bk": (cfg.kv_dim,), "bv": (cfg.kv_dim,)})
    shapes.update({
        "input_norm": (h,),
        "post_attn_norm": (h,),
        "router": (h, cfg.num_experts),
        "expert_gate_up": (cfg.num_experts, h, 2 * n),
        "expert_down": (cfg.num_experts, n, h),
    })
    if ns > 0:
        shapes.update({"shared_gate_up": (h, 2 * ns), "shared_down": (ns, h)})
        if cfg.has_shared_expert_gate:
            shapes["shared_gate"] = (h, 1)
    return shapes


def _normal(shape, std, gen, dtype, device):
    """N(0, std) drawn in float32, stored in ``dtype``."""
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return t.mul_(std).to(dtype)


def init_params(cfg: MoEConfig, gen: torch.Generator, dtype=torch.bfloat16,
                device="cuda") -> dict:
    """Random-init params with the JAX package's distribution: matrices
    N(0, 0.4/sqrt(fan_in)), norms 1, biases 0, embed/lm_head N(0, 0.02).

    ``gen`` must live on ``device``. Tensors are drawn one layer at a time
    in float32 and stored in ``dtype``, so a full-width model never exists
    in float32. (torch and jax draw different numbers from one seed; tests
    share weights through ``params_from_jax``.)"""
    nl = cfg.num_moe_layers
    layers = {}
    for name, shape in layer_param_shapes(cfg).items():
        if len(shape) == 1:
            fill = 1.0 if "norm" in name else 0.0
            layers[name] = torch.full((nl, *shape), fill, dtype=dtype, device=device)
            continue
        std = 0.4 / shape[-2] ** 0.5
        stack = torch.empty((nl, *shape), dtype=dtype, device=device)
        for l in range(nl):
            stack[l] = _normal(shape, std, gen, dtype, device)
        layers[name] = stack
    return {
        "embed": _normal((cfg.vocab_size, cfg.hidden_size), 0.02, gen, dtype, device),
        "layers": layers,
        "final_norm": torch.ones((cfg.hidden_size,), dtype=dtype, device=device),
        "lm_head": _normal((cfg.hidden_size, cfg.vocab_size), 0.02, gen, dtype, device),
    }


def head_logits(params: dict, h: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Final projection; with the int8 lm_head of
    ``quant.qparams.quantize_lm_head`` the hidden states are quantized per
    token to 8 bits (K1) and multiplied as one group of a grouped int8 GEMM
    (K2): the int32 sums are exact, so this is the reference's int8 dot with
    its ``acc * s_h * s_w`` epilogue."""
    if "lm_head_q" in params:
        from ..ops import act_quant
        from ..ops.gmm_w8a8 import gmm_w8a8

        h2 = h.reshape(-1, h.shape[-1])
        hq, hsc = act_quant.quantize_rows_uniform(h2, 8)
        one_group = torch.full((1,), h2.shape[0], dtype=torch.int32,
                               device=h.device)
        out = gmm_w8a8(hq, hsc, params["lm_head_q"][None],
                       params["lm_head_sc"][None], one_group, out_dtype=h.dtype)
        return out.reshape(*h.shape[:-1], -1)
    head = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    return h @ head
