"""Parameters, output head and full causal-LM forward of the MoE decoder
families (port of ``mxmoe_tpu/models/model.py``: ``layer_param_shapes``,
``dense_layer_param_shapes``, ``init_params`` (which can quantize as it
draws), ``forward_hidden``, ``head_logits`` with its int8 branch,
``forward_logits``, ``make_forward_fn``).

Layout (as in the JAX package):
  embed          [V, H]
  dense_layers/  each [first_dense_layers, ...]  (ds2: attention, norms,
                 the SwiGLU MLP)
  layers/...     each [num_moe_layers, ...]  (attention, norms, router,
                 experts, shared)
  final_norm     [H]
  lm_head        [H, V]

The forward is a Python loop over per-layer views ``stack[l]`` (quantized
params included: the JAX package's loop-constant expert stack,
``split_expert_stack``, has no counterpart here).
"""

from __future__ import annotations

import torch

from .configs import MoEConfig
from .layers import MoEImpl, decoder_layer, make_rope_tables, rms_norm


def _attn_shapes(cfg: MoEConfig) -> dict[str, tuple]:
    h = cfg.hidden_size
    if cfg.attention_type == "mla":
        return {
            "wq": (h, cfg.num_heads * cfg.qk_head_dim),
            "kv_a": (h, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
            "kv_a_norm": (cfg.kv_lora_rank,),
            "kv_b": (cfg.kv_lora_rank,
                     cfg.num_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
            "wo": (cfg.num_heads * cfg.v_head_dim, h),
        }
    shapes = {
        "wq": (h, cfg.q_dim),
        "wk": (h, cfg.kv_dim),
        "wv": (h, cfg.kv_dim),
        "wo": (cfg.q_dim, h),
    }
    if cfg.attention_bias:
        shapes.update({"bq": (cfg.q_dim,), "bk": (cfg.kv_dim,), "bv": (cfg.kv_dim,)})
    return shapes


def layer_param_shapes(cfg: MoEConfig) -> dict[str, tuple]:
    h = cfg.hidden_size
    n = cfg.moe_intermediate_size
    ns = cfg.shared_expert_intermediate_size
    shapes = _attn_shapes(cfg)
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


def dense_layer_param_shapes(cfg: MoEConfig) -> dict[str, tuple]:
    """The first dense layers (ds2 layer 0: a plain SwiGLU MLP)."""
    h = cfg.hidden_size
    i = cfg.dense_intermediate_size
    return {
        **_attn_shapes(cfg),
        "input_norm": (h,),
        "post_attn_norm": (h,),
        "mlp_gate_up": (h, 2 * i),
        "mlp_down": (i, h),
    }


def _normal(shape, std, gen, dtype, device):
    """N(0, std) drawn in float32, stored in ``dtype``."""
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return t.mul_(std).to(dtype)


def _init_stack(shapes: dict, num: int, gen, dtype, device) -> dict:
    layers = {}
    for name, shape in shapes.items():
        if len(shape) == 1:
            fill = 1.0 if "norm" in name else 0.0
            layers[name] = torch.full((num, *shape), fill, dtype=dtype, device=device)
            continue
        std = 0.4 / shape[-2] ** 0.5
        stack = torch.empty((num, *shape), dtype=dtype, device=device)
        for l in range(num):
            stack[l] = _normal(shape, std, gen, dtype, device)
        layers[name] = stack
    return layers


def _put_layer(stacks: dict, layer: dict, l: int, num: int) -> None:
    """Copy one layer's [1, ...] tensors into slot ``l`` of the [num, ...]
    stacks, which the first layer allocates (zero-filled). A ragged
    ``_qcat`` buffer with more rows than the stack so far grows it; shorter
    ones leave zero rows, as ``pack_ragged_stack`` pads."""
    for key, t in layer.items():
        st = stacks.get(key)
        if st is None:
            st = stacks[key] = torch.zeros((num, *t.shape[1:]), dtype=t.dtype,
                                           device=t.device)
        if t.dim() > 1 and t.shape[1] > st.shape[1]:
            st = stacks[key] = torch.nn.functional.pad(
                st, (0, 0) * (st.dim() - 2) + (0, t.shape[1] - st.shape[1]))
        st[l, :t.shape[1]] = t[0]


def init_params(cfg: MoEConfig, gen: torch.Generator, dtype=torch.bfloat16,
                device="cuda", quantize=None) -> dict:
    """Random-init params with the JAX package's distribution: matrices
    N(0, 0.4/sqrt(fan_in)), norms 1, biases 0, embed/lm_head N(0, 0.02);
    ``dense_layers`` for a family with first dense layers.

    ``gen`` must live on ``device``. Tensors are drawn one layer at a time
    in float32 and stored in ``dtype``, so a full-width model never exists
    in float32. The MoE layers are drawn one at a time, each passed through
    ``quantize`` (a params dict ``{"layers": one layer's [1, ...] stacks}``
    -> that dict quantized, e.g. ``quantize_for_serving`` with a
    one-MoE-layer config) before the next is drawn: one float MoE layer
    exists at a time beside the quantized stacks, so a model whose float
    experts would not fit beside their quantized copy is set up layer by
    layer. A quantizer that pools over layers (the shared expert's finest
    group size) sees one layer. (torch and jax draw different numbers from
    one seed; tests share weights through ``params_from_jax``.)"""
    params = {
        "embed": _normal((cfg.vocab_size, cfg.hidden_size), 0.02, gen, dtype, device),
        "final_norm": torch.ones((cfg.hidden_size,), dtype=dtype, device=device),
        "lm_head": _normal((cfg.hidden_size, cfg.vocab_size), 0.02, gen, dtype, device),
    }
    if cfg.first_dense_layers > 0:
        params["dense_layers"] = _init_stack(dense_layer_param_shapes(cfg),
                                             cfg.first_dense_layers, gen, dtype,
                                             device)
    shapes = layer_param_shapes(cfg)
    params["layers"] = {}
    for l in range(cfg.num_moe_layers):
        one = {"layers": _init_stack(shapes, 1, gen, dtype, device)}
        if quantize is not None:
            one = quantize(one)
        _put_layer(params["layers"], one["layers"], l, cfg.num_moe_layers)
    return params


def layer_stacks(params: dict):
    """(stack, dense) for the dense layers (if any), then the MoE layers, in
    the order the forward runs them."""
    if "dense_layers" in params:
        yield params["dense_layers"], True
    yield params["layers"], False


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: MoEConfig,
                   impl: MoEImpl = MoEImpl(),
                   positions: torch.Tensor | None = None) -> torch.Tensor:
    """Token ids [B, S] -> final hidden states [B, S, H] (final norm
    applied). Out-of-range ids are clamped, as the reference's take."""
    embed = params["embed"]
    x = embed[tokens.long().clamp(0, embed.shape[0] - 1)]
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    cos, sin = make_rope_tables(cfg, positions)
    for stack, dense in layer_stacks(params):
        for l in range(stack["input_norm"].shape[0]):
            lp = {name: t[l] for name, t in stack.items()}
            x = decoder_layer(x, lp, cfg, cos, sin, impl, dense_mlp=dense)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


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


def forward_logits(params: dict, tokens: torch.Tensor, cfg: MoEConfig,
                   impl: MoEImpl = MoEImpl()) -> torch.Tensor:
    """Token ids [B, S] -> logits [B, S, V]."""
    return head_logits(params, forward_hidden(params, tokens, cfg, impl), cfg)


def make_forward_fn(cfg: MoEConfig, impl: MoEImpl = MoEImpl()):
    """``fn(params, tokens) -> logits`` closed over the config, run under
    ``torch.inference_mode`` (the reference's ``jax.jit`` closure; nothing is
    compiled)."""

    def fn(params: dict, tokens: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return forward_logits(params, tokens, cfg, impl)

    return fn
