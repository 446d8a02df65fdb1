"""Full-model forwards over a process group (port of
``mxmoe_tpu/parallel/sharded.py``): the expert-parallel forward, the
sequence-parallel prefill, and the tensor-parallel forward that the JAX
package gets from GSPMD (``jax.jit(forward_logits)`` over
``parallel.mesh.shard_params``' layout on a ("data", "expert") mesh).

In the expert-parallel forward, where the JAX package lets GSPMD place the
dense parts under ``jit``, every rank runs them on its own tokens (dense
weights replicated) and only the routed experts exchange rows: one mesh
axis ("expert") carries both the token batch and the experts.

In the tensor-parallel forward (:func:`make_tp_forward`) the ranks of one
"expert" group share their "data" block of the tokens and split the work of
every layer: each runs its heads, its block of the shared expert's columns
and rows and its E/ep routed experts (all tokens routed by the replicated
router, the assignments to other ranks' experts left out), and the partial
outputs are summed over the group, one all-reduce after attention and one
after the MoE layer. Nothing is dropped: every assignment is computed by
exactly one rank, as GSPMD computes the global product.

Each ``forward`` carries the transport its collectives take
(``forward.transport``): ``serving.graph.ForwardGraph`` captures a forward
over ``"direct"`` and refuses one over ``"host"``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.configs import MoEConfig
from ..models.layers import (MoEImpl, attention_block, make_rope_tables, moe_ffn_ragged,
                             rms_norm, shared_expert_ffn, shared_expert_gate,
                             silu_mul)
from ..models.model import forward_hidden, head_logits
from .ep import (EPConfig, capacity_factor_from_freq, ep_comm, make_ep_moe_fn,
                 make_ep_moe_quant_fn, padded_num_experts)
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

    forward.transport = ep_cfg.transport
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

    forward.transport = transport
    return forward


def tp_local_config(cfg: MoEConfig, ep: int) -> MoEConfig:
    """The config of one rank's share of a layer's attention under tensor
    parallelism over ``ep`` ranks: ``num_heads`` / ``num_kv_heads`` divided
    by ``ep`` (the head blocks are contiguous, so query head i of a rank
    still reads kv head i // (num_heads / num_kv_heads) of its block).
    Raises, naming the numbers, where the split is not whole: heads or the
    shared expert's width that ``ep`` does not divide (GSPMD pads such a
    shard; the port refuses it), and the families the JAX package's specs
    do not cover (MLA attention, dense first layers)."""
    if cfg.attention_type != "gqa" or cfg.first_dense_layers:
        raise ValueError(f"make_tp_forward: {cfg.model_type} ({cfg.attention_type} "
                         f"attention, {cfg.first_dense_layers} dense first layers) has "
                         "no tensor-parallel specs; param_shardings covers the GQA "
                         "families without dense layers (qwen2_moe, mixtral)")
    if cfg.num_kv_heads % ep or cfg.num_heads % ep:
        raise ValueError(f"make_tp_forward: {cfg.num_kv_heads} kv heads and "
                         f"{cfg.num_heads} query heads do not split over the {ep} "
                         "ranks of 'expert' (GSPMD pads uneven head shards; the port "
                         "needs num_kv_heads % ep == 0)")
    if cfg.shared_expert_intermediate_size % ep:
        raise ValueError(f"make_tp_forward: the shared expert's "
                         f"{cfg.shared_expert_intermediate_size} columns do not split "
                         f"over the {ep} ranks of 'expert'")
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // ep,
                               num_kv_heads=cfg.num_kv_heads // ep)


def make_tp_forward(cfg: MoEConfig, mesh, impl: MoEImpl | None = None,
                    transport: str = "direct"):
    """``forward(local_params, tokens) -> logits`` under tensor parallelism
    on a ("data", "expert") mesh (module docstring): ``local_params`` from
    ``parallel.mesh.shard_params(params, mesh)`` (the default specs),
    ``tokens`` this rank's ``P("data", None)`` block [B/dp, S], the logits
    that block's [B/dp, S, V], the same on every rank of an "expert" group.
    The routed experts go through ``moe_ffn_ragged`` on the rank's block of
    E/ep experts, so ``impl.gmm_backend="pallas"`` runs K11. The sums go
    through ``parallel.ep.EPComm`` on the "expert" group (``transport`` as
    the EP paths take it). Reads nothing on the host: the forward can be
    captured (``serving.graph.ForwardGraph``) over ``"direct"``."""
    impl = impl or MoEImpl()
    if impl.kind != "ragged" or impl.quant is not None or impl.attn_backend == "ring":
        raise ValueError(f"make_tp_forward: MoEImpl(kind={impl.kind!r}, quant="
                         f"{impl.quant!r}, attn_backend={impl.attn_backend!r}): the "
                         "forward runs the float ragged path")
    comm = ep_comm(mesh, EPConfig(axis="expert", transport=transport))
    local = tp_local_config(cfg, comm.size)
    e_local = padded_num_experts(cfg.num_experts, comm.size) // comm.size
    experts = (comm.index * e_local, e_local)
    eps, hdim = cfg.rms_norm_eps, cfg.hidden_size

    def forward(params: dict, tokens: torch.Tensor) -> torch.Tensor:
        embed = params["embed"]
        x = embed[tokens.long().clamp(0, embed.shape[0] - 1)]
        b, s = tokens.shape
        cos, sin = make_rope_tables(cfg, torch.arange(s, device=tokens.device))
        stack = params["layers"]
        for i in range(stack["input_norm"].shape[0]):
            lp = {name: t[i] for name, t in stack.items()}
            attn = attention_block(rms_norm(x, lp["input_norm"], eps), lp, local, cos,
                                   sin, impl.attn_backend)
            h = x + comm.all_reduce_sum(attn)
            x2d = rms_norm(h, lp["post_attn_norm"], eps).reshape(-1, hdim)
            routed = moe_ffn_ragged(x2d, lp, cfg, impl, experts=experts)
            if cfg.shared_expert_intermediate_size > 0:
                # gate / up block r through SwiGLU, the row block of down; the
                # sigmoid gate multiplies the sum, as in shared_expert_ffn
                part = silu_mul(x2d @ lp["shared_gate_up"]) @ lp["shared_down"]
                routed, shared = comm.all_reduce_sum(torch.stack([routed, part]))
                y = routed + shared_expert_gate(shared, x2d, lp, cfg)
            else:
                y = comm.all_reduce_sum(routed)
            x = h + y.reshape(b, s, hdim)
        return head_logits(params, rms_norm(x, params["final_norm"], eps), cfg)

    forward.transport = transport
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
