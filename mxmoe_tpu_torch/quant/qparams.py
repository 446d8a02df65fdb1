"""Quantized expert-weight params and activation quant (port of
``mxmoe_tpu/quant/qparams.py``: the uniform quantizer, the per-expert mixed
quantizer with its flex families and shared-expert storage, and the
per-token, per-group and flex activation quantizers).

Uniform-scheme layout (per layer, stacked leading L axis like the float
params):

  expert_gate_up_q   [L, E, H, 2N] int8
  expert_gate_up_sc  [L, E, H//g, 2N] f32     (g=-1 -> H//g == 1)
  expert_gate_up_zp  [L, E, H//g, 2N] f32     (zeros when symmetric)
  expert_down_*      likewise with [L, E, N, H]

Mixed layout (``quantize_model_experts_mixed``): the same ``_q/_sc/_zp``
keys (a flex family: [L, E, G, N] scales, ``_zp`` only with an asymmetric
scheme, plus ``act_gsize_*`` [L, E, G]), or with ``pack_w4`` the ragged
buffer ``expert_*_qcat`` [L, R, N] with ``_blk`` / ``_pf`` [L, E] and
``_sc``; plus ``act_bits_gateup`` / ``act_bits_down`` [L, E], and for a
real-quantized shared expert ``shared_*_q`` [L, K, N], ``shared_*_sc``
[L, G, N], optional ``shared_*_zp``, ``act_bits_shared`` [L, 2] and the
``shared_wo`` marker of an all-a16 one. ``quantize_lm_head`` replaces
``lm_head`` by ``lm_head_q`` [H, V] int8 and ``lm_head_sc`` [1, V] f32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .packing import pack_ragged_stack, quantize_weight_kn
from .schemes import QLinearConfig, QModelConfig, flex_family_info

# f32 elements a slice of experts may hold while it quantizes (512 MiB; the
# temporaries of ``quantize_weight_kn`` take a few times that)
SLICE_ELEMS = 1 << 27


def expert_slices(num_experts: int, k: int, n: int):
    """[start, end) ranges of experts of at most ``SLICE_ELEMS`` f32
    elements of [K, N] weights each (at least one expert a slice)."""
    step = max(1, SLICE_ELEMS // (k * n))
    return [(e0, min(e0 + step, num_experts)) for e0 in range(0, num_experts, step)]


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


def quantize_act_grouped(x: torch.Tensor, bits: int, gsize: int):
    """Per-token-per-k-group symmetric quant -> (int8 [M,K], f32 [M,K//g]):
    the activation side of the g128-class w x a schemes.

    The scale is ``amax * f32(1 / upper)``, not ``amax / upper`` (one ulp
    apart on about half the scales): the reference reaches this function
    compiled, in the serving forward, where the division by a constant
    becomes that multiply (a Python float multiplies a float32 tensor as
    its float32 rounding, with no constant copied to the device, which a
    captured decode step cannot hold). The codes divide by the scale."""
    m, k = x.shape
    if k % gsize != 0:
        raise ValueError(f"quantize_act_grouped: K={k} % gsize={gsize}")
    upper = float((1 << (bits - 1)) - 1)
    xg = x.float().reshape(m, k // gsize, gsize)
    amax = torch.clamp(xg.abs().amax(-1), min=1e-8)
    scale = amax * (1.0 / upper)
    q = torch.round(xg / scale[..., None]).reshape(m, k)
    return q.to(torch.int8), scale


def quantize_act_rows_flex(x: torch.Tensor, bits_per_row: torch.Tensor,
                           gflags_per_row: torch.Tensor, gsize: int):
    """Per-row act quant of the flex mixed path -> (int8 [M,K], f32 [M,G]).

    Rows with ``gflags_per_row <= 0`` quantize per token (their scale
    replicated over the G = K // gsize groups; codes equal
    ``quantize_act_per_row_bits``), rows with a positive flag per k-group of
    ``gsize``. Bitwidth and group size are data, so one array pair feeds the
    grouped kernel whatever each expert's scheme. The per-row divisor is an
    array, so compiled and op-by-op reference agree: a true division."""
    m, k = x.shape
    if k % gsize != 0:
        raise ValueError(f"quantize_act_rows_flex: K={k} % gsize={gsize}")
    g = k // gsize
    xf = x.float().reshape(m, g, gsize)
    amax_g = xf.abs().amax(-1)                                   # [M, G]
    amax_row = amax_g.amax(-1, keepdim=True).expand(m, g)
    amax = torch.where(gflags_per_row[:, None] > 0, amax_g, amax_row)
    scale = torch.clamp(amax, min=1e-8) / _row_upper(bits_per_row)[:, None]
    q = torch.round(xf / scale[..., None]).reshape(m, k)
    return q.to(torch.int8), scale


def quantize_model_experts_uniform(params: dict, cfg: QLinearConfig,
                                   device=None) -> dict:
    """Float params -> params whose routed expert weights are quantized
    (``expert_*`` replaced by ``expert_*_q/_sc/_zp``).

    Streams one layer, and in it one slice of experts (``expert_slices``), at
    a time: only that slice's f32 working set exists at once, so full-width,
    full-depth models quantize on one card beside their quantized stacks
    (the experts are independent, so the output is that of one pass).
    ``device`` runs the work (default: the params' device); the results stay
    on the params' device, so host-staged params are quantized on the card
    one slice at a time. The float expert stacks are dropped from the
    returned dict."""
    layers = dict(params["layers"])
    for name in ("expert_gate_up", "expert_down"):
        w = layers.pop(name)                       # [L, E, K, N]
        dev = torch.device(device) if device is not None else w.device
        nl, e, k, n = w.shape
        g = 1 if cfg.w_gsize == -1 else k // cfg.w_gsize
        q = torch.empty((nl, e, k, n), dtype=torch.int8, device=w.device)
        sc = torch.empty((nl, e, g, n), dtype=torch.float32, device=w.device)
        zp = torch.empty_like(sc)
        for l in range(nl):
            for e0, e1 in expert_slices(e, k, n):
                qp = quantize_expert_weights(w[l, e0:e1].to(dev), cfg)
                q[l, e0:e1], sc[l, e0:e1], zp[l, e0:e1] = qp.q, qp.scale, qp.zp
        del w
        layers[f"{name}_q"] = q
        layers[f"{name}_sc"] = sc
        layers[f"{name}_zp"] = zp
    return {**params, "layers": layers}


def _check_mixed_scheme(c: QLinearConfig, what: str, pack_w4: bool) -> None:
    """The routed-expert domain of a mixed layer: integer weights of at most
    8 bits with activations of at most 8 bits (w x a) or of 16 and more
    (weight-only), any group size, symmetric or not. ``pack_w4`` needs pure
    w x a mixes: the one-launch kernel of weight-only and w x a experts reads
    int8-stored codes."""
    if c.w_bits > 8 or 8 < c.a_bits < 16:
        raise ValueError(
            "mixed real-quant supports int w<=8 w x a (a<=8) and weight-only "
            f"(a>=16) schemes, got {c.scheme_name} for {what}")
    if pack_w4 and c.a_bits > 8:
        raise ValueError(
            "pack_w4 requires pure w x a mixes (a16 weight-only experts need "
            f"int8-stored codes), got {c.scheme_name} for {what}")


def _replicate_groups(t: torch.Tensor, gdim: int) -> torch.Tensor:
    """[.., G0, N] scales or zero points -> [.., gdim, N]: a per-channel row
    (or a coarser grouping) repeated over the family's finer groups (exact)."""
    return t.repeat_interleave(gdim // t.shape[-2], dim=-2)


def quantize_model_experts_mixed(params: dict, model_cfg,
                                 qmodel_cfg: QModelConfig,
                                 pack_w4: bool = False, device=None) -> dict:
    """Real-quantize routed experts with per-expert mixed schemes.

    Every w<=8, a<=8 scheme shares the int8 kernels: per-expert bitwidths
    live in the scales (weights) and the per-row clip range (activations),
    so a mixed layer is one grouped-GEMM launch. Emits ``expert_*_q/_sc/_zp``
    plus ``act_bits_gateup`` / ``act_bits_down`` [L, E]. Weight-only (a>=16)
    experts are admitted beside them: their ``act_bits_*`` read 16, and the
    forward serves such a layer through ``ops.gmm_mixed_wo_wxa`` when its
    ``MoEImpl`` says ``mixed_weight_only``.

    A linear family whose scheme set holds a grouped or asymmetric scheme is
    FLEX (``schemes.flex_family_info``): its scales (and, with an asymmetric
    scheme, zero points) are stored [L, E, G, N] at the family's finest group
    size, per-channel experts replicated over G; ``_zp`` is dropped when no
    scheme is asymmetric; ``act_gsize_*`` [L, E, G] mark it for the forward,
    which takes ``ops.gmm_w8a8_grouped``. A per-channel symmetric family
    keeps the compact [L, E, 1, N] layout with its all-zero ``_zp``.

    ``pack_w4=True`` stores w<=4 experts nibble-packed in a per-layer ragged
    buffer (``expert_*_qcat`` [L, R, N] + ``_blk`` / ``_pf`` [L, E]) consumed
    by ``ops.gmm_mixed_packed``: bitwise the same outputs from about half
    the bytes for those experts. A flex family keeps its [L, E, G, N] scales
    (and ``_zp`` with an asymmetric scheme) beside the buffer; a per-channel
    one carries no ``_zp``. A weight-only expert refuses ``pack_w4``.

    A shared expert configured at index E with integer weights in every
    layer is real-quantized too, at the finest group size its layers use:
    ``shared_*_q`` [L, K, N], ``shared_*_sc`` [L, G, N], ``shared_*_zp`` when
    a layer's scheme is asymmetric, ``act_bits_shared`` [L, 2], and the
    marker ``shared_wo`` [L, 1] when every layer is a16 (weight-only). A
    shared expert that is a16 in some layers and a<=8 in others, or keeps
    float weights in some, takes the reference's fallback: its weights are
    fake-quantized in place (``quantizer._fq_weight_kn``, bf16 stays bf16)
    beside ``act_bits_shared``, which the forward applies per token.

    Quantizes one layer, and in it one slice of a scheme's experts, at a
    time on ``device`` (default: the params' device), the results on the
    params' device, so only one slice's f32 working set exists at once.
    Scales are rounded as the reference's op-by-op mixed quantizer rounds
    them (a true division).
    """
    from .quantizer import _fq_weight_kn, act_gsize_arrays

    e = model_cfg.num_experts
    layers = dict(params["layers"])
    num_layers = layers["router"].shape[0]
    dev = layers["router"].device
    new = {}
    for name, lin in (("expert_gate_up", "gate"), ("expert_down", "down")):
        w = layers.pop(name)                          # [L, E, K, N]
        work = torch.device(device) if device is not None else w.device
        kdim, n = w.shape[-2], w.shape[-1]
        for l in range(num_layers):
            for ei in range(e):
                _check_mixed_scheme(qmodel_cfg.layer(l).experts[str(ei)].qmap()[lin],
                                    f"layer {l} expert {ei} {lin}", pack_w4)
        any_flex, g_min, any_asym = flex_family_info(qmodel_cfg, num_layers, e,
                                                     lin, kdim)
        gdim = kdim // g_min if any_flex else 1
        sc = torch.empty((num_layers, e, gdim, n), dtype=torch.float32,
                         device=w.device)
        zp = torch.zeros_like(sc)

        def layer_codes():
            """One layer's int8 codes [E, K, N] at a time; fills sc and zp."""
            for l in range(num_layers):
                lcfg = qmodel_cfg.layer(l)
                buckets: dict[str, list[int]] = {}
                for ei in range(e):
                    c = lcfg.experts[str(ei)].qmap()[lin]
                    buckets.setdefault(c.scheme_name, []).append(ei)
                q_l = torch.empty((e, kdim, n), dtype=torch.int8, device=w.device)
                for eids in buckets.values():
                    c = lcfg.experts[str(eids[0])].qmap()[lin]
                    for s0, s1 in expert_slices(len(eids), kdim, n):
                        idx = torch.tensor(eids[s0:s1], device=w.device)
                        qp = quantize_expert_weights(w[l][idx].to(work), c,
                                                     scale_by_reciprocal=False)
                        q_l[idx] = qp.q.to(w.device)
                        sc[l, idx] = _replicate_groups(qp.scale, gdim).to(w.device)
                        zp[l, idx] = _replicate_groups(qp.zp, gdim).to(w.device)
                yield q_l

        if pack_w4:
            # the flags of every layer size the buffer, so list them first
            flags = [[int(qmodel_cfg.layer(l).experts[str(ei)].qmap()[lin].w_bits <= 4)
                      for ei in range(e)] for l in range(num_layers)]
            (new[f"{name}_qcat"], new[f"{name}_blk"],
             new[f"{name}_pf"]) = pack_ragged_stack(layer_codes(), flags)
            new[f"{name}_sc"] = sc
            if any_asym:
                new[f"{name}_zp"] = zp
        else:
            q = torch.empty((num_layers, e, kdim, n), dtype=torch.int8,
                            device=w.device)
            for l, q_l in enumerate(layer_codes()):
                q[l] = q_l
            new[f"{name}_q"] = q
            new[f"{name}_sc"] = sc
            if any_asym or not any_flex:
                # an all-symmetric flex family drops zp, so the grouped
                # kernel runs without its row-sum term
                new[f"{name}_zp"] = zp
        del w

    def bits_of(lin):
        return torch.tensor(
            [[float(qmodel_cfg.layer(l).experts[str(ei)].qmap()[lin].a_bits)
              for ei in range(e)] for l in range(num_layers)],
            dtype=torch.float32, device=dev)

    new["act_bits_gateup"] = bits_of("gate")
    new["act_bits_down"] = bits_of("down")
    new.update(act_gsize_arrays(qmodel_cfg, model_cfg, num_layers, dev))

    # shared expert (config index E): real-quantized when every layer
    # configures it with integer weights and all layers are a<=8 or all a16
    shared = [qmodel_cfg.layer(l).experts.get(str(e)) for l in range(num_layers)]
    if all(c is not None for c in shared) and "shared_gate_up" in layers:
        qmaps = [c.qmap() for c in shared]
        cs = [qm[lin] for qm in qmaps for lin in ("gate", "down")]
        w_int = all(c.w_bits <= 8 for c in cs)
        all_a16 = w_int and all(c.a_bits >= 16 for c in cs)
        layers["act_bits_shared"] = torch.tensor(
            [[float(qm["gate"].a_bits), float(qm["down"].a_bits)] for qm in qmaps],
            dtype=torch.float32, device=dev)
        if w_int and (all_a16 or all(c.a_bits <= 8 for c in cs)):
            _quantize_shared(layers, qmaps, work)
            if all_a16:
                # a static marker: its presence selects the weight-only branch
                layers["shared_wo"] = torch.zeros((num_layers, 1),
                                                  dtype=torch.float32, device=dev)
        else:
            # the reference's fallback: fake-quantized float weights
            for name, lin in (("shared_gate_up", "gate"), ("shared_down", "down")):
                w = layers[name]                      # [L, K, N]
                layers[name] = torch.stack([
                    _fq_weight_kn(w[l].to(work), qmaps[l][lin]).to(w.device)
                    for l in range(num_layers)])

    layers.update(new)
    return {**params, "layers": layers}


def _quantize_shared(layers: dict, qmaps: list, work) -> None:
    """Real-quantize the shared expert of every layer in place of its float
    stacks (``shared_*_q`` / ``_sc`` / ``_zp``), at the finest group size
    its layers use, as the routed flex families are stored; on ``work``."""
    num_layers = len(qmaps)
    for name, lin in (("shared_gate_up", "gate"), ("shared_down", "down")):
        w = layers.pop(name)                          # [L, K, N]
        kdim, n = w.shape[-2], w.shape[-1]
        g_min = min(kdim if qm[lin].w_gsize == -1 else qm[lin].w_gsize
                    for qm in qmaps)
        gdim = kdim // g_min
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        sc = torch.empty((num_layers, gdim, n), dtype=torch.float32, device=w.device)
        zp = torch.empty_like(sc)
        for l in range(num_layers):
            qp = quantize_expert_weights(w[l][None].to(work), qmaps[l][lin],
                                         scale_by_reciprocal=False)
            q[l] = qp.q[0]
            sc[l] = _replicate_groups(qp.scale[0], gdim)
            zp[l] = _replicate_groups(qp.zp[0], gdim)
        layers[f"{name}_q"] = q
        layers[f"{name}_sc"] = sc
        if any(not qm[lin].w_sym for qm in qmaps):
            layers[f"{name}_zp"] = zp


def quantize_lm_head(params: dict) -> dict:
    """Per-channel int8 lm_head (decode is lm-head-bandwidth-heavy): replaces
    ``lm_head`` by ``lm_head_q`` [H, V] int8 and ``lm_head_sc`` [1, V] f32;
    ``models.model.head_logits`` quantizes the hidden states per token and
    takes the int8 product. Quantizes V in slices, so the f32 working set of
    a full vocabulary never exists at once."""
    w = params["lm_head"]
    h, v = w.shape
    q = torch.empty((h, v), dtype=torch.int8, device=w.device)
    sc = torch.empty((1, v), dtype=torch.float32, device=w.device)
    step = 16384
    for v0 in range(0, v, step):
        wf = w[:, v0:v0 + step].float()
        s = torch.clamp(wf.abs().amax(0, keepdim=True), min=1e-8) / 127.0
        q[:, v0:v0 + step] = torch.round(wf / s).to(torch.int8)
        sc[:, v0:v0 + step] = s
    out = {k: t for k, t in params.items() if k != "lm_head"}
    out["lm_head_q"] = q
    out["lm_head_sc"] = sc
    return out
