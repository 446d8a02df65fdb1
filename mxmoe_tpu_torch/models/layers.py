"""Transformer building blocks of the quantized serving slices (port of
``mxmoe_tpu/models/layers.py``: ``rms_norm``, ``silu_mul``, ``MoEImpl``,
``moe_ffn_ragged_quant``, ``shared_expert_ffn``, ``moe_block``).

Layouts are the JAX package's: matmul weights [in, out] (a projection is
``x @ w``), expert weights [E, in, out] with gate/up fused as [E, H, 2N].
A layer's params are ``{name: stacked[layer]}`` views.

Ported branches of ``moe_ffn_ragged_quant`` (all symmetric per-channel
w x a, K1 act quant -> grouped GEMM -> SwiGLU -> K1 -> grouped GEMM):
uniform int8-stored (K2), uniform or mixed nibble-packed ``_q_packed`` (K5),
per-expert mixed int8-stored (K2 with per-row activation bits) and mixed
over the ragged packed buffer ``_qcat`` (K4). The shared expert runs in
float or, real-quantized per channel, through K2 with one group. Every
other branch raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .configs import MoEConfig
from ..ops import act_quant
from ..ops.dispatch import combine_tokens, gather_tokens, make_dispatch, route_topk
from ..ops.gmm_mixed_packed import gmm_mixed_packed
from ..ops.gmm_w4a8_packed import gmm_w4a8_packed
from ..ops.gmm_w8a8 import gmm_w8a8


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


def silu_mul(gate_up: torch.Tensor) -> torch.Tensor:
    """SwiGLU on a [.., 2N] gate_up projection."""
    n = gate_up.shape[-1] // 2
    return F.silu(gate_up[..., :n]) * gate_up[..., n:]


@dataclasses.dataclass(frozen=True)
class MoEImpl:
    """How the expert FFN runs (the field of the JAX ``MoEImpl`` that the
    serving slices read).

    quant: the uniform QLinearConfig of the routed expert linears (params
      from quantize_model_experts_uniform), or ``"mixed"`` for per-expert
      schemes (params from quantize_model_experts_mixed, whose
      ``act_bits_*`` arrays carry the activation widths).
    The JAX serving defaults hold for the rest: unaligned dispatch
    (``dispatch_align=None``, ``fused_ffn=False``), act quant through the
    single-pass kernel (``pallas_quant=True``, here K1) and no a16 experts
    in a mixed layer (``mixed_weight_only=False``).
    """

    quant: object | None = None


_STORAGE_KEYS = ("expert_gate_up_q", "expert_gate_up_q_packed",
                 "expert_gate_up_qcat")


def _check_quant_domain(lp: dict, qcfg) -> bool:
    """Admit exactly the ported domains; returns whether the layer is mixed
    (per-expert activation bits)."""
    if qcfg is None:
        raise NotImplementedError(
            "the bf16 ragged MoE path is not ported yet (ROADMAP queue A: "
            "moe_ffn_ragged)")
    if not any(k in lp for k in _STORAGE_KEYS):
        raise ValueError("moe_ffn_ragged_quant: the layer carries no quantized "
                         f"expert weights (one of {_STORAGE_KEYS})")
    if ("act_gsize_gateup" in lp or "act_gsize_down" in lp
            or lp["expert_gate_up_sc"].shape[-2] != 1
            or lp["expert_down_sc"].shape[-2] != 1):
        raise NotImplementedError(
            "grouped / asymmetric (flex) expert families need the flex form "
            "of gmm_mixed_packed and gmm_w8a8_grouped (ROADMAP queue B)")
    if "act_bits_gateup" in lp:
        return True
    if "expert_gate_up_qcat" in lp:
        raise ValueError("a ragged packed buffer (expert_*_qcat) needs the "
                         "per-expert act_bits_gateup / act_bits_down arrays")
    if isinstance(qcfg, str):
        raise ValueError(f"MoEImpl.quant={qcfg!r} needs mixed params "
                         "(quantize_model_experts_mixed)")
    if qcfg.a_bits >= 16:
        raise NotImplementedError(
            "weight-only (a16) experts need gmm_weight_only / "
            "gmm_weight_only_packed (ROADMAP queue B)")
    if not qcfg.a_sym:
        raise NotImplementedError("asymmetric activations are not wired")
    if qcfg.w_gsize != -1:
        raise NotImplementedError(
            "grouped schemes need gmm_w8a8_grouped (ROADMAP queue B)")
    if not qcfg.w_sym:
        raise NotImplementedError(
            "asymmetric weights need gmm_w8a8_asym (ROADMAP queue B)")
    return False


def moe_ffn_ragged_quant(x2d: torch.Tensor, lp: dict, cfg: MoEConfig,
                         impl: MoEImpl) -> torch.Tensor:
    """Real-quantized expert FFN: per-token act quant + int8 grouped GEMMs.
    Per-expert bitwidths are data (the weight scales and the per-row clip
    range of the activations), so a mixed layer is one launch per GEMM."""
    qcfg = impl.quant
    mixed = _check_quant_domain(lp, qcfg)

    logits = x2d @ lp["router"]
    routing = route_topk(logits, cfg.top_k, cfg.norm_topk_prob,
                         cfg.routed_scaling_factor)
    disp = make_dispatch(routing, cfg.num_experts)
    xs = gather_tokens(x2d, disp)                                   # [T*k, H]
    if mixed:
        # output_size keeps repeat_interleave from reading the sizes on the host
        row_expert = torch.repeat_interleave(
            torch.arange(cfg.num_experts, device=xs.device),
            disp.group_sizes.long(), output_size=xs.shape[0])

    def qgemm(acts, prefix, bits_key):
        if mixed:
            aq, asc = act_quant.quantize_rows(acts, lp[bits_key][row_expert])
        else:
            aq, asc = act_quant.quantize_rows_uniform(acts, int(qcfg.a_bits))
        sc = lp[f"{prefix}_sc"]
        if f"{prefix}_qcat" in lp:
            return gmm_mixed_packed(aq, asc, lp[f"{prefix}_qcat"], sc,
                                    disp.group_sizes, lp[f"{prefix}_pf"],
                                    lp[f"{prefix}_blk"], out_dtype=acts.dtype)
        if f"{prefix}_q_packed" in lp:
            return gmm_w4a8_packed(aq, asc, lp[f"{prefix}_q_packed"], sc,
                                   disp.group_sizes, out_dtype=acts.dtype)
        return gmm_w8a8(aq, asc, lp[f"{prefix}_q"], sc, disp.group_sizes,
                        out_dtype=acts.dtype)

    h = silu_mul(qgemm(xs, "expert_gate_up", "act_bits_gateup"))    # [T*k, N]
    out = qgemm(h, "expert_down", "act_bits_down")                  # [T*k, H]
    return combine_tokens(out, disp, x2d.shape[0])


def _shared_expert_int8(x2d: torch.Tensor, lp: dict) -> torch.Tensor:
    """Real-quantized shared expert, per-channel symmetric w x a: per-token
    act quant (K1) and the dense int8 product as K2 with one group. The
    int32 sum is exact, so this equals the reference's K-split int8 dots."""
    if (lp["shared_gate_up_sc"].shape[-2] != 1 or "shared_gate_up_zp" in lp
            or "shared_down_zp" in lp):
        raise NotImplementedError(
            "a grouped / asymmetric shared expert needs gmm_w8a8_grouped "
            "(ROADMAP queue B)")
    if "shared_wo" in lp:
        raise NotImplementedError(
            "a weight-only (a16) shared expert needs gmm_weight_only "
            "(ROADMAP queue B)")
    t = x2d.shape[0]
    bits = lp["act_bits_shared"]                                    # [2]
    one_group = torch.full((1,), t, dtype=torch.int32, device=x2d.device)

    def qdot(acts, name, b):
        aq, asc = act_quant.quantize_rows(acts, b.expand(t))
        return gmm_w8a8(aq, asc, lp[f"{name}_q"][None], lp[f"{name}_sc"][None],
                        one_group, out_dtype=x2d.dtype)

    return qdot(silu_mul(qdot(x2d, "shared_gate_up", bits[0])),
                "shared_down", bits[1])


def shared_expert_ffn(x2d: torch.Tensor, lp: dict, cfg: MoEConfig) -> torch.Tensor:
    """Shared expert (float, or int8 when the params carry its codes), with
    the qwen2_moe sigmoid gate."""
    if "shared_gate_up_q" in lp:
        out = _shared_expert_int8(x2d, lp)
    elif "act_bits_shared" in lp:
        raise NotImplementedError(
            "the fake-quantized shared expert (layer-heterogeneous schemes) "
            "is not ported (ROADMAP queue A: quantizer)")
    else:
        out = silu_mul(x2d @ lp["shared_gate_up"]) @ lp["shared_down"]
    if cfg.has_shared_expert_gate:
        gate = torch.sigmoid(x2d @ lp["shared_gate"])               # [T, 1]
        out = out * gate.to(out.dtype)
    return out


def moe_block(x: torch.Tensor, lp: dict, cfg: MoEConfig,
              impl: MoEImpl = MoEImpl()) -> torch.Tensor:
    b, s, h = x.shape
    x2d = x.reshape(-1, h)
    y = moe_ffn_ragged_quant(x2d, lp, cfg, impl)
    if cfg.shared_expert_intermediate_size > 0:
        y = y + shared_expert_ffn(x2d, lp, cfg)
    return y.reshape(b, s, h)
