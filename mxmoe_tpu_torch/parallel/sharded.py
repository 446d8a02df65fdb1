"""Full-model forwards over a process group (port of
``mxmoe_tpu/parallel/sharded.py``): the expert-parallel forward and the
sequence-parallel prefill.

Where the JAX package lets GSPMD place the dense parts under ``jit``, here
every rank runs them on its own tokens (dense weights replicated) and only
the routed experts exchange rows: one mesh axis ("expert") carries both the
token batch and the experts.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.configs import MoEConfig
from ..models.layers import MoEImpl, attention_block, make_rope_tables, rms_norm, \
    shared_expert_ffn
from ..models.model import forward_hidden, head_logits
from .ep import (EPConfig, capacity_factor_from_freq, make_ep_moe_fn,
                 make_ep_moe_quant_fn)
from .mesh import P, axis_index, axis_size


def make_sharded_forward(cfg: MoEConfig, mesh, quantized: bool = False,
                         ep_cfg: EPConfig | None = None, gate_freq=None):
    """``forward(params, tokens) -> logits`` over this rank's batch block
    (tokens [B/ep, S], the JAX ``P("expert", None)`` block) and its params
    (experts sliced by :func:`ep_param_shardings`), returning its logits
    block. ``quantized=True``: params from
    ``quant.qparams.quantize_model_experts_uniform`` (w8a8), int8 on the
    wire. ``gate_freq``: a gate trace's per-expert frequencies, from which
    the capacity factor is derived when ``ep_cfg`` is not given.
    Non-divisible E: pad the global params first with
    ``ep.pad_expert_arrays(params["layers"], cfg.num_experts, ep)``."""
    if ep_cfg is None:
        cap = (capacity_factor_from_freq(gate_freq, axis_size(mesh, "expert"),
                                         margin=1.5)
               if gate_freq is not None else 2.0)
        ep_cfg = EPConfig(axis="expert", capacity_factor=max(cap, 2.0))
    ep_fn = (make_ep_moe_quant_fn if quantized else make_ep_moe_fn)(cfg, mesh, ep_cfg)

    def forward(params: dict, tokens: torch.Tensor) -> torch.Tensor:
        embed = params["embed"]
        x = embed[tokens.long().clamp(0, embed.shape[0] - 1)]
        b, s = tokens.shape
        cos, sin = make_rope_tables(cfg, torch.arange(s, device=tokens.device))
        stack = params["layers"]
        for i in range(stack["input_norm"].shape[0]):
            lp = {name: t[i] for name, t in stack.items()}
            h = x + attention_block(rms_norm(x, lp["input_norm"], cfg.rms_norm_eps),
                                    lp, cfg, cos, sin)
            x2d = rms_norm(h, lp["post_attn_norm"], cfg.rms_norm_eps).reshape(
                -1, cfg.hidden_size)
            if quantized:
                y = ep_fn(x2d, lp["router"], lp["expert_gate_up_q"],
                          lp["expert_gate_up_sc"], lp["expert_down_q"],
                          lp["expert_down_sc"])
            else:
                y = ep_fn(x2d, lp["router"], lp["expert_gate_up"], lp["expert_down"])
            if ep_cfg.return_stats:
                y = y[0]
            if cfg.shared_expert_intermediate_size > 0:
                y = y + shared_expert_ffn(x2d, lp, cfg)
            x = h + y.reshape(b, s, cfg.hidden_size)
        return head_logits(params, rms_norm(x, params["final_norm"], cfg.rms_norm_eps),
                           cfg)

    return forward


def make_sp_prefill_forward(cfg: MoEConfig, mesh, axis: str = "seq",
                            impl: MoEImpl | None = None, transport: str = "direct"):
    """Sequence-parallel prefill: ``logits(params, tokens)`` over this rank's
    contiguous block of the sequence (tokens [B, S/P], rank r holding
    positions [r S/P, (r+1) S/P)), attention through ring attention
    (``attn_backend="ring"``). Everything position-local (embedding, norms,
    router, experts, head) runs on the rank's own positions; params are
    replicated."""
    from .ring_attention import make_ring_attention_fn

    impl = dataclasses.replace(impl or MoEImpl(), attn_backend="ring",
                               ring_attn=make_ring_attention_fn(mesh, axis, transport))
    me = axis_index(mesh, axis)

    def forward(params: dict, tokens: torch.Tensor) -> torch.Tensor:
        s_l = tokens.shape[1]
        positions = me * s_l + torch.arange(s_l, device=tokens.device)
        h = forward_hidden(params, tokens, cfg, impl, positions=positions)
        return head_logits(params, h, cfg)

    return forward


def ep_param_shardings(params: dict, mesh=None, quantized=False,
                       axis: str = "expert") -> dict:
    """Specs for the expert-parallel forward and the mesh Engine: expert
    arrays sharded on ``axis`` (dim 1 of the stacked [L, E, ...] layout; a
    per-shard packed buffer [L, ep, R, N] on its dim 1), everything else
    replicated. Walks the whole tree, so quantized keys (``expert_*_q`` /
    ``_sc`` / ``_zp`` / ``_blk`` / ``_pf``, ``lm_head_q``) follow by name."""
    if mesh is not None:
        (axis,) = mesh.mesh_dim_names

    def spec_for(name: str, t: torch.Tensor) -> P:
        if name.endswith("_qcat"):
            # the global [L, R, N] ragged layout has no expert dim
            return P(None, axis, None, None) if t.dim() == 4 else P(*[None] * t.dim())
        if name.startswith("expert_") and t.dim() >= 2:
            return P(None, axis, *[None] * (t.dim() - 2))
        return P(*[None] * t.dim())

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else spec_for(k, v)
                for k, v in tree.items()}

    return walk(params)
