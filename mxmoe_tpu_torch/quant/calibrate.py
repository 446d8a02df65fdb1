"""The float decoder layers that GPTQ propagates its calibration rows
through (port of the first two functions of ``mxmoe_tpu/quant/calibrate.py``:
``dense_layer_forward_fp`` and ``layer_forward_fp``). The calibration
losses (``moe_calib_errors``, ``calibrate_model``, ...) are the next slice's.
"""

from __future__ import annotations

import torch

from ..models.configs import MoEConfig
from ..models.layers import (attention_dispatch, rms_norm, shared_expert_ffn,
                             silu_mul)
from ..ops.dispatch import combine_tokens, gather_tokens, make_dispatch, route_topk
from ..ops.gmm import gmm


def dense_layer_forward_fp(x: torch.Tensor, dlp: dict, cfg: MoEConfig, cos, sin):
    """A float dense decoder layer -> (layer output [B, S, H], its MLP input
    [B*S, H])."""
    h = x + attention_dispatch(rms_norm(x, dlp["input_norm"], cfg.rms_norm_eps),
                               dlp, cfg, cos, sin)
    mlp_in = rms_norm(h, dlp["post_attn_norm"], cfg.rms_norm_eps)
    b, s, hid = mlp_in.shape
    x2d = mlp_in.reshape(-1, hid)
    y = silu_mul(x2d @ dlp["mlp_gate_up"]) @ dlp["mlp_down"]
    return h + y.reshape(b, s, hid), x2d


def layer_forward_fp(x: torch.Tensor, lp: dict, cfg: MoEConfig, cos, sin,
                     backend: str = "ragged_dot"):
    """A float MoE decoder layer -> (layer output [B, S, H], the MoE block's
    input [B*S, H]). ``backend`` is ``ops.gmm``'s: ``"ragged_dot"`` the stock
    grouped product, ``"pallas"`` K11."""
    h = x + attention_dispatch(rms_norm(x, lp["input_norm"], cfg.rms_norm_eps),
                               lp, cfg, cos, sin)
    moe_in = rms_norm(h, lp["post_attn_norm"], cfg.rms_norm_eps)
    b, s, hid = moe_in.shape
    x2d = moe_in.reshape(-1, hid)
    routing = route_topk(x2d @ lp["router"], cfg.top_k, cfg.norm_topk_prob,
                         cfg.routed_scaling_factor)
    disp = make_dispatch(routing, cfg.num_experts)
    xs = gather_tokens(x2d, disp)
    hh = silu_mul(gmm(xs, lp["expert_gate_up"], disp.group_sizes, backend=backend))
    out = gmm(hh, lp["expert_down"], disp.group_sizes, backend=backend)
    y = combine_tokens(out, disp, x2d.shape[0])
    if cfg.shared_expert_intermediate_size > 0:
        y = y + shared_expert_ffn(x2d, lp, cfg)
    return h + y.reshape(b, s, hid), x2d
