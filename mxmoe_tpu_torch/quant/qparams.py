"""Quantized expert-weight params and per-token activation quant (port of
``mxmoe_tpu/quant/qparams.py``: the uniform quantizer and the per-channel
symmetric domain of the per-expert mixed quantizer).

Uniform-scheme layout (per layer, stacked leading L axis like the float
params):

  expert_gate_up_q   [L, E, H, 2N] int8
  expert_gate_up_sc  [L, E, H//g, 2N] f32     (g=-1 -> H//g == 1)
  expert_gate_up_zp  [L, E, H//g, 2N] f32     (zeros when symmetric)
  expert_down_*      likewise with [L, E, N, H]

Mixed layout (``quantize_model_experts_mixed``): the same ``_q/_sc/_zp``
keys, or with ``pack_w4`` the ragged buffer ``expert_*_qcat`` [L, R, N] with
``_blk`` / ``_pf`` [L, E] and ``_sc``; plus ``act_bits_gateup`` /
``act_bits_down`` [L, E], and for a real-quantized shared expert
``shared_*_q`` [L, K, N], ``shared_*_sc`` [L, 1, N], ``act_bits_shared``
[L, 2].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .packing import pack_ragged_stack, quantize_weight_kn
from .schemes import QLinearConfig, QModelConfig, flex_family_info


class QuantLinearParams(NamedTuple):
    q: torch.Tensor       # [..., K, N] int8 codes (signed storage)
    scale: torch.Tensor   # [..., K//g, N] f32
    zp: torch.Tensor      # [..., K//g, N] f32 (zeros when symmetric)


def quantize_expert_weights(w: torch.Tensor, cfg: QLinearConfig,
                            scale_by_reciprocal: bool = True) -> QuantLinearParams:
    """RTN-quantize stacked expert weights [.., E, K, N] (groups along K).
    ``scale_by_reciprocal``: see ``rtn.quantize``."""
    packed = quantize_weight_kn(w, cfg, scale_by_reciprocal)
    return QuantLinearParams(packed.values, packed.scale, packed.zp)


def quantize_act_per_token(x: torch.Tensor, bits: int = 8):
    """Symmetric per-token quant -> (int8 codes [M,K], f32 scale [M,1])."""
    upper = float((1 << (bits - 1)) - 1)
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(-1, keepdim=True), min=1e-8) / upper
    return torch.round(xf / scale).to(torch.int8), scale


def quantize_act_rtn(x: torch.Tensor, cfg: QLinearConfig):
    """Per-token path honoring the scheme's a_bits (symmetric only)."""
    if not (cfg.a_sym or cfg.a_bits >= 16):
        raise NotImplementedError("asymmetric activations are not wired")
    return quantize_act_per_token(x, int(cfg.a_bits))


def _row_upper(bits_per_row: torch.Tensor) -> torch.Tensor:
    """2^(min(bits,8)-1) - 1 per row, computed exactly in integers (bits
    are integral; >=16 clips to 8) -> float32 [M]."""
    e = (torch.clamp(bits_per_row.float(), max=8.0) - 1.0).to(torch.int32)
    return ((torch.ones_like(e) << e) - 1).float()


def quantize_act_per_row_bits(x: torch.Tensor, bits_per_row: torch.Tensor):
    """Per-token sym quant with a per-row bitwidth -> (int8 [M,K], f32 [M,1])."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(-1), min=1e-8) / _row_upper(bits_per_row)
    q = torch.round(xf / scale[:, None])
    return q.to(torch.int8), scale[:, None]


def quantize_model_experts_uniform(params: dict, cfg: QLinearConfig) -> dict:
    """Float params -> params whose routed expert weights are quantized
    (``expert_*`` replaced by ``expert_*_q/_sc/_zp``).

    Streams one layer at a time: only one layer's f32 working set exists
    at once, so full-width models quantize on one card. The float expert
    stacks are dropped from the returned dict (the caller's dict keeps
    them alive only if the caller holds it)."""
    layers = dict(params["layers"])
    for name in ("expert_gate_up", "expert_down"):
        w = layers.pop(name)                       # [L, E, K, N]
        nl, e, k, n = w.shape
        g = 1 if cfg.w_gsize == -1 else k // cfg.w_gsize
        q = torch.empty((nl, e, k, n), dtype=torch.int8, device=w.device)
        sc = torch.empty((nl, e, g, n), dtype=torch.float32, device=w.device)
        zp = torch.empty_like(sc)
        for l in range(nl):
            qp = quantize_expert_weights(w[l], cfg)
            q[l], sc[l], zp[l] = qp.q, qp.scale, qp.zp
        del w
        layers[f"{name}_q"] = q
        layers[f"{name}_sc"] = sc
        layers[f"{name}_zp"] = zp
    return {**params, "layers": layers}


def _check_mixed_scheme(c: QLinearConfig, what: str) -> None:
    """The ported mixed domain: per-channel symmetric w x a, both <= 8 bit."""
    if c.w_bits > 8:
        raise ValueError(f"mixed real-quant needs integer weights w<=8, got "
                         f"{c.scheme_name} for {what}")
    if c.a_bits >= 16:
        raise NotImplementedError(
            f"weight-only (a16) experts in a mixed layer ({c.scheme_name} for "
            f"{what}) need gmm_mixed_wo_wxa / gmm_weight_only (ROADMAP queue B)")
    if c.a_bits > 8:
        raise ValueError(f"activation width {c.a_bits} of {c.scheme_name}")
    if c.w_gsize != -1 or c.a_gsize != -1 or not c.w_sym:
        raise NotImplementedError(
            f"grouped / asymmetric schemes in a mixed layer ({c.scheme_name} "
            f"for {what}) need the flex form of gmm_mixed_packed and "
            "gmm_w8a8_grouped (ROADMAP queue B)")


def quantize_model_experts_mixed(params: dict, model_cfg,
                                 qmodel_cfg: QModelConfig,
                                 pack_w4: bool = False) -> dict:
    """Real-quantize routed experts with per-expert mixed schemes.

    Every w<=8 symmetric per-channel scheme shares the int8 kernels:
    per-expert bitwidths live in the scales (weights) and the per-row clip
    range (activations), so a mixed layer is one grouped-GEMM launch. Emits
    ``expert_*_q/_sc/_zp`` plus ``act_bits_gateup`` / ``act_bits_down``
    [L, E]. ``pack_w4=True`` stores w<=4 experts nibble-packed in a
    per-layer ragged buffer (``expert_*_qcat`` [L, R, N] + ``_blk`` / ``_pf``
    [L, E]) consumed by ``ops.gmm_mixed_packed``: bitwise the same outputs
    from about half the bytes for those experts.

    A shared expert configured at index E (w<=8, a<=8 in every layer) is
    real-quantized too: ``shared_*_q/_sc`` and ``act_bits_shared`` [L, 2].

    Quantizes one layer at a time on the params' device, so only one
    layer's f32 working set exists at once. Scales are rounded as the
    reference's op-by-op mixed quantizer rounds them (a true division).
    Grouped, asymmetric and a16 schemes raise ``NotImplementedError``.
    """
    e = model_cfg.num_experts
    layers = dict(params["layers"])
    num_layers = layers["router"].shape[0]
    new = {}
    for name, lin in (("expert_gate_up", "gate"), ("expert_down", "down")):
        w = layers.pop(name)                          # [L, E, K, N]
        kdim, n = w.shape[-2], w.shape[-1]
        for l in range(num_layers):
            for ei in range(e):
                _check_mixed_scheme(qmodel_cfg.layer(l).experts[str(ei)].qmap()[lin],
                                    f"layer {l} expert {ei} {lin}")
        any_flex, _, _ = flex_family_info(qmodel_cfg, num_layers, e, lin, kdim)
        if any_flex:    # unreachable after the check above; keeps them tied
            raise NotImplementedError(
                "flex (grouped / asymmetric) mixed families are not ported "
                "(ROADMAP queue B: gmm_mixed_packed flex form)")
        sc = torch.empty((num_layers, e, 1, n), dtype=torch.float32,
                         device=w.device)

        def layer_codes():
            """One layer's int8 codes [E, K, N] at a time; fills sc."""
            for l in range(num_layers):
                lcfg = qmodel_cfg.layer(l)
                buckets: dict[str, list[int]] = {}
                for ei in range(e):
                    c = lcfg.experts[str(ei)].qmap()[lin]
                    buckets.setdefault(c.scheme_name, []).append(ei)
                q_l = torch.empty((e, kdim, n), dtype=torch.int8, device=w.device)
                for eids in buckets.values():
                    c = lcfg.experts[str(eids[0])].qmap()[lin]
                    idx = torch.tensor(eids, device=w.device)
                    qp = quantize_expert_weights(w[l][idx], c,
                                                 scale_by_reciprocal=False)
                    q_l[idx] = qp.q
                    sc[l, idx] = qp.scale
                yield q_l

        if pack_w4:
            # the flags of every layer size the buffer, so list them first
            flags = [[int(qmodel_cfg.layer(l).experts[str(ei)].qmap()[lin].w_bits <= 4)
                      for ei in range(e)] for l in range(num_layers)]
            (new[f"{name}_qcat"], new[f"{name}_blk"],
             new[f"{name}_pf"]) = pack_ragged_stack(layer_codes(), flags)
            new[f"{name}_sc"] = sc
        else:
            q = torch.empty((num_layers, e, kdim, n), dtype=torch.int8,
                            device=w.device)
            for l, q_l in enumerate(layer_codes()):
                q[l] = q_l
            new[f"{name}_q"] = q
            new[f"{name}_sc"] = sc
            new[f"{name}_zp"] = torch.zeros_like(sc)
        del w

    def bits_of(lin):
        return torch.tensor(
            [[float(qmodel_cfg.layer(l).experts[str(ei)].qmap()[lin].a_bits)
              for ei in range(e)] for l in range(num_layers)],
            dtype=torch.float32, device=layers["router"].device)

    new["act_bits_gateup"] = bits_of("gate")
    new["act_bits_down"] = bits_of("down")

    # shared expert (config index E): real-quantized when every layer
    # configures it with integer weights and a<=8
    shared = [qmodel_cfg.layer(l).experts.get(str(e)) for l in range(num_layers)]
    if all(c is not None for c in shared) and "shared_gate_up" in layers:
        qmaps = [c.qmap() for c in shared]
        cs = [qm[lin] for qm in qmaps for lin in ("gate", "down")]
        w_int = all(c.w_bits <= 8 for c in cs)
        if w_int and all(c.a_bits >= 16 for c in cs):
            raise NotImplementedError(
                "a weight-only (a16) shared expert needs gmm_weight_only "
                "(ROADMAP queue B)")
        if not (w_int and all(c.a_bits <= 8 for c in cs)):
            raise NotImplementedError(
                "a shared expert whose schemes mix a16 with a<=8 across layers "
                "(or keep float weights) takes the fake-quant fallback, which "
                "is not ported (ROADMAP queue A: quantizer)")
        for l, qm in enumerate(qmaps):
            for lin in ("gate", "down"):
                _check_mixed_scheme(qm[lin], f"layer {l} shared expert {lin}")
        for name, lin in (("shared_gate_up", "gate"), ("shared_down", "down")):
            w = layers.pop(name)                      # [L, K, N]
            q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
            sc = torch.empty((num_layers, 1, w.shape[-1]), dtype=torch.float32,
                             device=w.device)
            for l in range(num_layers):
                qp = quantize_expert_weights(w[l][None], qmaps[l][lin],
                                             scale_by_reciprocal=False)
                q[l], sc[l] = qp.q[0], qp.scale[0]
            layers[f"{name}_q"] = q
            layers[f"{name}_sc"] = sc
        layers["act_bits_shared"] = torch.tensor(
            [[float(qm["gate"].a_bits), float(qm["down"].a_bits)] for qm in qmaps],
            dtype=torch.float32, device=layers["router"].device)

    layers.update(new)
    return {**params, "layers": layers}
