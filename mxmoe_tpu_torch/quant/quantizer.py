"""Model quantization orchestrator (port of ``mxmoe_tpu/quant/quantizer.py``):
the fake-quant evaluation path ``quantize_model_fake`` (methods rtn | gptq |
rtn-had | gptq-had; per-(layer, expert, linear) schemes from a
``QModelConfig``), and what produces servable params: ``act_gsize_arrays``,
``_fq_weight_kn``, ``_shared_cfgs``, ``make_moe_hessian_fn`` and
``quantize_model_experts_mixed_gptq``.

``quantize_model_fake`` returns float params whose expert weights are
fake-quantized, beside the per-layer ``act_bits_gateup`` / ``act_bits_down``
[E] (``act_bits_shared`` [2], ``act_bits_dense`` [2], ``act_gsize_*``) that
the float forward applies per row group (``models.layers._act_fq_per_row``),
so accuracy runs through the standard forward.

GPTQ runs layer by layer: the Hessians of a layer come from its float pass
over the calibration rows, and the rows go on to the next layer through the
layer with its experts quantized (the reference's ``llama_sequential``
order).
"""

from __future__ import annotations

import time

import torch

from ..models.configs import MoEConfig
from ..models.layers import make_rope_tables, silu_mul
from ..ops.dispatch import gather_tokens, make_dispatch, route_topk
from ..ops.gmm import gmm
from .calibrate import layer_forward_fp
from .gptq import accumulate_hessian, gptq_quantize_kn
from .packing import _to_signed_storage, pack_ragged_stack
from .rtn import fake_quant
from .schemes import QLinearConfig, QModelConfig, flex_family_info


def act_gsize_arrays(qmodel_cfg: QModelConfig, cfg, num_layers: int,
                     device="cpu") -> dict:
    """Flex markers of a mixed model: per family ``act_gsize_gateup`` /
    ``act_gsize_down`` [L, E, G] f32 (each expert's ``a_gsize``, or -1 for
    per-token activations, replicated along the last axis so the group count
    G rides the array's shape). Emitted only for families whose scheme set
    is flex (grouped or asymmetric: ``schemes.flex_family_info``)."""
    out = {}
    e = cfg.num_experts
    for lin, key, kdim in (("gate", "act_gsize_gateup", cfg.hidden_size),
                           ("down", "act_gsize_down", cfg.moe_intermediate_size)):
        any_flex, g_min, _ = flex_family_info(qmodel_cfg, num_layers, e, lin, kdim)
        if not any_flex:
            continue
        ag = torch.full((num_layers, e, kdim // g_min), -1.0, dtype=torch.float32)
        for l in range(num_layers):
            lcfg = qmodel_cfg.layer(l)
            for ei in range(e):
                c = lcfg.experts[str(ei)].qmap()[lin]
                if c.a_gsize != -1 and c.a_bits < 16:
                    if c.a_gsize != g_min:
                        raise ValueError(f"{lin}: a_gsize {c.a_gsize} != the "
                                         f"family's group size {g_min}")
                    ag[l, ei, :] = float(c.a_gsize)
        out[key] = ag.to(device)
    return out


def _fq_weight_kn(w_kn: torch.Tensor, cfg: QLinearConfig) -> torch.Tensor:
    """Fake-quant [.., K, N] weights, grouped along K per output column (op
    by op in the reference: scales by true division), in ``w_kn``'s dtype."""
    if cfg.w_bits >= 16:
        return w_kn
    w_nk = fake_quant(w_kn.transpose(-1, -2), cfg.w_bits, cfg.w_gsize, cfg.w_sym,
                      cfg.w_clip)
    return w_nk.transpose(-1, -2).to(w_kn.dtype)


def _shared_cfgs(layer_cfg, num_experts: int):
    """The shared expert's schemes (config index E), or None."""
    key = str(num_experts)
    if key in layer_cfg.experts:
        return layer_cfg.experts[key].qmap()
    return None


def make_moe_hessian_fn(cfg: MoEConfig, backend: str):
    """Per-layer GPTQ Hessians ``fn(x2d, lp) -> {name: H}`` for the routed
    experts (per expert, from their routed rows: ``expert_gate_up`` from the
    MoE input, ``expert_down`` from the SwiGLU output of the float experts)
    and the shared expert (all rows). One function for every GPTQ path, so
    they agree on what a Hessian is."""

    def hessians_for_layer(x2d: torch.Tensor, lp: dict) -> dict:
        routing = route_topk(x2d @ lp["router"], cfg.top_k, cfg.norm_topk_prob,
                             cfg.routed_scaling_factor)
        disp = make_dispatch(routing, cfg.num_experts)
        xs = gather_tokens(x2d, disp)
        h_pre = silu_mul(gmm(xs, lp["expert_gate_up"], disp.group_sizes,
                             backend=backend))
        out = {"expert_gate_up": accumulate_hessian(xs, disp.group_sizes,
                                                    cfg.num_experts),
               "expert_down": accumulate_hessian(h_pre, disp.group_sizes,
                                                 cfg.num_experts)}
        if "shared_gate_up" in lp:
            sh = silu_mul(x2d @ lp["shared_gate_up"])
            out["shared_gate_up"] = accumulate_hessian(x2d)
            out["shared_down"] = accumulate_hessian(sh)
        return out

    return hessians_for_layer


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def proxy_loss(w_fq: torch.Tensor, w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """tr(dW^T H dW) per expert for [E, K, N] weights and [E, K, K] Hessians
    (dW = w_fq - w): the layer-output error GPTQ minimizes, in float64."""
    dw = w_fq.double() - w.double()                           # [E, K, N]
    return (torch.bmm(h.double(), dw) * dw).sum((1, 2))


def quantize_model_experts_mixed_gptq(
        params: dict, cfg: MoEConfig, qmodel_cfg: QModelConfig,
        calib_tokens: torch.Tensor, backend: str = "ragged_dot",
        pack_w4: bool = False, rotation: torch.Tensor | None = None,
        hadamard: bool = False, act_order: bool = False, device=None,
        stats: dict | None = None) -> dict:
    """Real-quantize the routed (and shared) experts with GPTQ codes, in the
    layout of ``qparams.quantize_model_experts_mixed``, so the artifact
    serves through the same kernels with GPTQ's accuracy.

    The scheme domain is the RTN variant's: integer weights of at most 8
    bits, w x a (a <= 8) or weight-only (a >= 16), grouped and asymmetric
    ones included. Grouped schemes take STATIC groups (per-group params from
    the original weights), so the scales stay aligned to the original
    K-groups, with ``act_order`` too. ``hadamard=True`` fuses the norms and
    rotates the model first (gptq-had) by ``rotation`` (an orthogonal [H, H]
    matrix; default ``random_hadamard_matrix(H)`` from a generator seeded 0),
    layer by layer and IN PLACE in the params' stacks and dtype (the
    reference's host path); the result is the rotated model, served as it
    is. A shared expert configured at index E in
    every layer is real-quantized when all its layers are per-channel
    symmetric w x a, and otherwise fake-quantized by GPTQ (float weights and
    ``act_bits_shared``). Dense-first layers (ds2) are refused, as in the
    reference.

    ``device`` runs the work (default: the params' device): one layer at a
    time goes to it and the results come back to the params' device, so a
    full-depth model stays on the host beside one layer of device work.
    ``stats``, when given, is
    filled per layer with the seconds of the float pass and Hessians and of
    the sweeps, and per expert family with GPTQ's and RTN's proxy losses
    (``proxy_loss`` on the calibration Hessians)."""
    if "dense_layers" in params:
        raise NotImplementedError(
            "GPTQ real-quant does not handle dense-first layers (ds2); use the "
            "RTN real quantizer")
    home = params["layers"]["router"].device
    device = torch.device(device) if device is not None else home
    if hadamard:
        from .rotation import rotate_model_hadamard_host

        params = rotate_model_hadamard_host(params, cfg, torch.Generator().manual_seed(0),
                                            rotation, device)

    e = cfg.num_experts
    layers = params["layers"]
    num_layers = layers["router"].shape[0]
    toks = calib_tokens.to(device=params["embed"].device, dtype=torch.long)
    x = params["embed"][toks.clamp(0, params["embed"].shape[0] - 1)].to(device)
    cos, sin = make_rope_tables(cfg, torch.arange(toks.shape[1], device=device))
    hessians_for_layer = make_moe_hessian_fn(cfg, backend)

    flex_info = {
        "expert_gate_up": flex_family_info(qmodel_cfg, num_layers, e, "gate",
                                           cfg.hidden_size),
        "expert_down": flex_family_info(qmodel_cfg, num_layers, e, "down",
                                        cfg.moe_intermediate_size)}
    # the shared expert is real-quantized all or nothing, decided from the
    # whole config: grouped / asymmetric shared schemes are fake-quantized
    shared_all = "shared_gate_up" in layers and all(
        _shared_cfgs(qmodel_cfg.layer(l), e) is not None for l in range(num_layers))

    def shared_pc_sym(l):
        sc = _shared_cfgs(qmodel_cfg.layer(l), e)
        return all(q.w_bits <= 8 and q.w_sym and q.w_gsize == -1 and q.a_bits <= 8
                   for q in (sc["gate"], sc["down"]))

    shared_ok = shared_all and all(shared_pc_sym(l) for l in range(num_layers))
    shared_fake = shared_all and not shared_ok

    acc: dict[str, list] = {}
    pf_all = {"expert_gate_up": [], "expert_down": []}
    gb = torch.zeros((num_layers, e))
    db = torch.zeros((num_layers, e))
    sb = torch.zeros((num_layers, 2))
    if stats is not None:
        stats.setdefault("layers", [])
        stats.setdefault("proxy", {"gptq": [], "rtn": []})

    for l in range(num_layers):
        t0 = time.perf_counter()
        lp = {k: v[l].to(device) for k, v in layers.items()}
        _, x2d = layer_forward_fp(x, lp, cfg, cos, sin, backend)
        hs = hessians_for_layer(x2d, lp)
        if stats is not None:
            _sync(device)
        t1 = time.perf_counter()
        lcfg = qmodel_cfg.layer(l)
        qlp = dict(lp)
        for name, lin in (("expert_gate_up", "gate"), ("expert_down", "down")):
            w = lp[name]                                      # [E, K, N]
            kdim, n = w.shape[-2], w.shape[-1]
            any_flex, g_min, _ = flex_info[name]
            gdim = kdim // g_min if any_flex else 1
            buckets: dict[str, list[int]] = {}
            pf_l = [0] * e
            for ei in range(e):
                c = lcfg.experts[str(ei)].qmap()[lin]
                if c.w_bits > 8 or 8 < c.a_bits < 16:
                    raise ValueError(
                        "GPTQ real-quant supports int w<=8 w x a (a<=8) and "
                        f"weight-only (a>=16) schemes, got {c.scheme_name}")
                if pack_w4:
                    if c.a_bits > 8:
                        raise ValueError(f"pack_w4 requires pure w x a mixes, got "
                                         f"{c.scheme_name}")
                    pf_l[ei] = int(c.w_bits <= 4)
                buckets.setdefault(c.scheme_name, []).append(ei)
            pf_all[name].append(pf_l)
            q_l = torch.zeros((e, kdim, n), dtype=torch.int8, device=home)
            sc_l = torch.zeros((e, gdim, n), dtype=torch.float32, device=home)
            zp_l = torch.zeros_like(sc_l)
            fq_l = torch.zeros((e, kdim, n), dtype=torch.float32, device=device)
            for eids in buckets.values():
                c = lcfg.experts[str(eids[0])].qmap()[lin]
                idx = torch.tensor(eids, device=device)
                h_sub = hs[name][idx]
                res = gptq_quantize_kn(w[idx], h_sub, c, act_order=act_order,
                                       static_groups=c.w_gsize != -1)
                codes, scale_kn, zp_kn = _to_signed_storage(
                    res.codes, res.scale.transpose(-1, -2), res.zp.transpose(-1, -2),
                    c.w_bits, c.w_sym or c.w_bits == 1.5)
                rep = gdim // scale_kn.shape[-2]
                hidx = idx.to(home)
                q_l[hidx] = codes.to(home)
                sc_l[hidx] = scale_kn.repeat_interleave(rep, dim=-2).to(home)
                zp_l[hidx] = zp_kn.repeat_interleave(rep, dim=-2).to(home)
                fq_l[idx] = res.w_fq
                if stats is not None:
                    stats["proxy"]["gptq"].append(proxy_loss(res.w_fq, w[idx], h_sub).cpu())
                    stats["proxy"]["rtn"].append(
                        proxy_loss(_fq_weight_kn(w[idx].float(), c), w[idx], h_sub).cpu())
            acc.setdefault(f"{name}_q", []).append(q_l)
            acc.setdefault(f"{name}_sc", []).append(sc_l)
            acc.setdefault(f"{name}_zp", []).append(zp_l)
            qlp[name] = fq_l.to(w.dtype)

        for ei in range(e):
            qm = lcfg.experts[str(ei)].qmap()
            gb[l, ei] = float(qm["gate"].a_bits)
            db[l, ei] = float(qm["down"].a_bits)

        if shared_ok or shared_fake:
            sh_cfg = _shared_cfgs(lcfg, e)
            for name, lin in (("shared_gate_up", "gate"), ("shared_down", "down")):
                c = sh_cfg[lin]
                kw = ({} if shared_ok else
                      {"act_order": act_order, "static_groups": c.w_gsize != -1})
                res = gptq_quantize_kn(lp[name][None], hs[name][None], c, **kw)
                fq = res.w_fq[0].to(lp[name].dtype)
                if shared_ok:
                    acc.setdefault(f"{name}_q", []).append(
                        res.codes[0].to(torch.int8).to(home))
                    acc.setdefault(f"{name}_sc", []).append(
                        res.scale[0].transpose(-1, -2).to(home))
                else:
                    acc.setdefault(f"{name}_fake", []).append(fq.to(home))
                qlp[name] = fq
            sb[l] = torch.tensor([float(sh_cfg["gate"].a_bits),
                                  float(sh_cfg["down"].a_bits)])
        if stats is not None:
            _sync(device)
        t2 = time.perf_counter()
        # on through the QUANTIZED layer; qlp's fake weights live only for it
        x, _ = layer_forward_fp(x, qlp, cfg, cos, sin, backend)
        del lp, qlp, hs
        if stats is not None:
            _sync(device)
            stats["layers"].append({"hessian_s": t1 - t0, "sweep_s": t2 - t1,
                                    "propagate_s": time.perf_counter() - t2})

    new = dict(layers)
    for name in ("expert_gate_up", "expert_down"):
        del new[name]
        any_flex, _, any_asym = flex_info[name]
        sc_acc = torch.stack(acc[f"{name}_sc"])
        zp_acc = torch.stack(acc[f"{name}_zp"])
        if pack_w4:
            (new[f"{name}_qcat"], new[f"{name}_blk"],
             new[f"{name}_pf"]) = pack_ragged_stack(iter(acc.pop(f"{name}_q")),
                                                    pf_all[name])
            new[f"{name}_sc"] = sc_acc
            if any_asym:
                new[f"{name}_zp"] = zp_acc
        else:
            new[f"{name}_q"] = torch.stack(acc.pop(f"{name}_q"))
            new[f"{name}_sc"] = sc_acc
            if any_asym or not any_flex:
                new[f"{name}_zp"] = zp_acc
    new["act_bits_gateup"] = gb.to(home)
    new["act_bits_down"] = db.to(home)
    new.update(act_gsize_arrays(qmodel_cfg, cfg, num_layers, home))
    if shared_ok:
        for name in ("shared_gate_up", "shared_down"):
            del new[name]
            new[f"{name}_q"] = torch.stack(acc[f"{name}_q"])
            new[f"{name}_sc"] = torch.stack(acc[f"{name}_sc"])
        new["act_bits_shared"] = sb.to(home)
    elif shared_fake:
        for name in ("shared_gate_up", "shared_down"):
            new[name] = torch.stack(acc[f"{name}_fake"])
        new["act_bits_shared"] = sb.to(home)
    return {**params, "layers": new}


# ---------------------------------------------------------------------------
# fake quantization (the evaluation path)
# ---------------------------------------------------------------------------

def _scheme_buckets(layer_cfg, num_experts: int, linear: str) -> dict[str, list[int]]:
    """Expert ids per distinct scheme of one linear family."""
    buckets: dict[str, list[int]] = {}
    for e in range(num_experts):
        c = layer_cfg.experts[str(e)].qmap()[linear]
        buckets.setdefault(c.scheme_name, []).append(e)
    return buckets


def _act_bits_arrays(layer_cfg, num_experts: int, device="cpu"):
    """Per-expert activation widths (gate_up input, down input) [E] f32."""
    gb = torch.full((num_experts,), 16.0)
    db = torch.full((num_experts,), 16.0)
    for e in range(num_experts):
        qm = layer_cfg.experts[str(e)].qmap()
        if qm["gate"].a_bits != qm["up"].a_bits:
            raise ValueError(f"expert {e}: gate and up activation widths differ "
                             "(the fused gate_up product takes one)")
        gb[e] = float(qm["gate"].a_bits)
        db[e] = float(qm["down"].a_bits)
    return gb.to(device), db.to(device)


def _apply_buckets_kn(w: torch.Tensor, buckets: dict[str, list[int]], layer_cfg,
                      linear: str, hessian: torch.Tensor | None = None) -> torch.Tensor:
    """w [E, K, N]: fake-quantize each scheme bucket (RTN, or GPTQ with the
    experts' Hessians [E, K, K]) -> a new [E, K, N] in ``w``'s dtype."""
    out = w.clone()
    for eids in buckets.values():
        c = layer_cfg.experts[str(eids[0])].qmap()[linear]
        if c.w_bits >= 16:
            continue
        idx = torch.tensor(eids, device=w.device)
        if hessian is None:
            fq = _fq_weight_kn(w[idx], c)
        else:
            fq = gptq_quantize_kn(w[idx], hessian[idx], c).w_fq
        out[idx] = fq.to(w.dtype)
    return out


def _gptq_one(w: torch.Tensor, h: torch.Tensor, c: QLinearConfig) -> torch.Tensor:
    """GPTQ fake weights of one [K, N] matrix with its Hessian [K, K]."""
    return gptq_quantize_kn(w[None], h[None], c).w_fq[0].to(w.dtype)


def _quantize_layer_params(lp: dict, cfg: MoEConfig, layer_cfg,
                           hessians: dict | None = None) -> dict:
    """One MoE layer's params with its routed (and shared) experts
    fake-quantized and its act-bits arrays; gate and up are tied (the fused
    [E, H, 2N] gate_up weight takes the gate scheme), down takes its own."""
    e = cfg.num_experts
    out = dict(lp)
    for name, lin in (("expert_gate_up", "gate"), ("expert_down", "down")):
        h = None if hessians is None else hessians[name]
        out[name] = _apply_buckets_kn(lp[name], _scheme_buckets(layer_cfg, e, lin),
                                      layer_cfg, lin, h)
    sh = _shared_cfgs(layer_cfg, e)
    has_shared = sh is not None and "shared_gate_up" in lp
    if has_shared:
        for name, c in (("shared_gate_up", sh["gate"]), ("shared_down", sh["down"])):
            if c.w_bits >= 16:
                continue
            if hessians is not None and name in hessians:
                out[name] = _gptq_one(lp[name], hessians[name], c)
            else:
                out[name] = _fq_weight_kn(lp[name], c)
    out["act_bits_gateup"], out["act_bits_down"] = _act_bits_arrays(
        layer_cfg, e, lp["router"].device)
    if has_shared:
        out["act_bits_shared"] = torch.tensor(
            [float(sh["gate"].a_bits), float(sh["down"].a_bits)],
            device=lp["router"].device)
    return out


def _dense_cfgs(qmodel_cfg: QModelConfig, dl: int):
    """The schemes of ds2's dense layer ``dl`` (qconfig key ``dense-<dl>``,
    one pseudo-expert "0"), or None."""
    lc = qmodel_cfg.layers.get(f"dense-{dl}")
    if lc is None:
        return None
    return lc.experts["0"].qmap()


def _quantize_dense_layer(dlp: dict, qm: dict, hessians: dict | None = None):
    """One dense layer's MLP fake-quantized (gate / up tied through the fused
    ``mlp_gate_up``) -> (params, act_bits_dense [2])."""
    out = dict(dlp)
    for name, c in (("mlp_gate_up", qm["gate"]), ("mlp_down", qm["down"])):
        if c.w_bits >= 16:
            continue
        if hessians is not None:
            out[name] = _gptq_one(dlp[name], hessians[name], c)
        else:
            out[name] = _fq_weight_kn(dlp[name], c)
    act_bits = torch.tensor([float(qm["gate"].a_bits), float(qm["down"].a_bits)],
                            device=dlp["mlp_down"].device)
    return out, act_bits


def _stack(rows: list, home) -> torch.Tensor:
    return torch.stack([r.to(home) for r in rows])


def _quantize_dense_stack_rtn(params: dict, qmodel_cfg: QModelConfig,
                              device) -> dict:
    """RTN over the ``dense_layers`` stack; emits ``act_bits_dense`` [Ld, 2]
    where the qconfig holds a ``dense-<i>`` key."""
    if "dense_layers" not in params:
        return params
    dls = params["dense_layers"]
    n_dense = dls["input_norm"].shape[0]
    if not any(f"dense-{dl}" in qmodel_cfg.layers for dl in range(n_dense)):
        return params
    home = dls["input_norm"].device
    new: dict[str, list] = {k: [] for k in dls}
    act = []
    for dl in range(n_dense):
        dlp = {k: v[dl].to(device) for k, v in dls.items()}
        qm = _dense_cfgs(qmodel_cfg, dl)
        if qm is not None:
            dlp, ab = _quantize_dense_layer(dlp, qm)
        else:
            ab = torch.tensor([16.0, 16.0])
        for k in new:
            new[k].append(dlp[k])
        act.append(ab)
    dense = {k: _stack(v, home) for k, v in new.items()}
    dense["act_bits_dense"] = _stack(act, home)
    return {**params, "dense_layers": dense}


def _finish_layers(params: dict, cfg: MoEConfig, qmodel_cfg: QModelConfig,
                   per_layer: list) -> dict:
    """Stack the per-layer results on the params' device, with the flex
    markers."""
    home = params["layers"]["router"].device
    stacked = {k: _stack([lp[k] for lp in per_layer], home) for k in per_layer[0]}
    stacked.update(act_gsize_arrays(qmodel_cfg, cfg, len(per_layer), home))
    return {**params, "layers": stacked}


def _quantize_rtn(params: dict, cfg: MoEConfig, qmodel_cfg: QModelConfig,
                  device) -> dict:
    params = _quantize_dense_stack_rtn(params, qmodel_cfg, device)
    layers = params["layers"]
    per_layer = []
    for l in range(layers["router"].shape[0]):
        lp = {k: v[l].to(device) for k, v in layers.items()}
        qlp = _quantize_layer_params(lp, cfg, qmodel_cfg.layer(l))
        per_layer.append({k: v.to(layers["router"].device) for k, v in qlp.items()})
    return _finish_layers(params, cfg, qmodel_cfg, per_layer)


def _quantize_gptq(params: dict, cfg: MoEConfig, qmodel_cfg: QModelConfig,
                   tokens: torch.Tensor, backend: str, device) -> dict:
    """Layer-streamed GPTQ: each layer's Hessians from its float pass over
    the calibration rows, the rows propagated through the quantized layer."""
    from .calibrate import dense_layer_forward_fp

    toks = tokens.to(device=params["embed"].device, dtype=torch.long)
    x = params["embed"][toks.clamp(0, params["embed"].shape[0] - 1)].to(device)
    cos, sin = make_rope_tables(cfg, torch.arange(toks.shape[1], device=device))
    out = dict(params)
    if "dense_layers" in params:
        dls = params["dense_layers"]
        home = dls["input_norm"].device
        new: dict[str, list] = {k: [] for k in dls}
        act = []
        any_cfg = False
        for dl in range(dls["input_norm"].shape[0]):
            dlp = {k: v[dl].to(device) for k, v in dls.items()}
            _, dx2d = dense_layer_forward_fp(x, dlp, cfg, cos, sin)
            qm = _dense_cfgs(qmodel_cfg, dl)
            if qm is not None:
                any_cfg = True
                hs = {"mlp_gate_up": accumulate_hessian(dx2d),
                      "mlp_down": accumulate_hessian(silu_mul(dx2d @ dlp["mlp_gate_up"]))}
                dlp, ab = _quantize_dense_layer(dlp, qm, hessians=hs)
            else:
                ab = torch.tensor([16.0, 16.0])
            for k in new:
                new[k].append(dlp[k])
            act.append(ab)
            # on through the QUANTIZED dense layer
            x, _ = dense_layer_forward_fp(x, dlp, cfg, cos, sin)
        if any_cfg:
            out["dense_layers"] = {k: _stack(v, home) for k, v in new.items()}
            out["dense_layers"]["act_bits_dense"] = _stack(act, home)
    hessians_for_layer = make_moe_hessian_fn(cfg, backend)
    layers = params["layers"]
    home = layers["router"].device
    per_layer = []
    for l in range(layers["router"].shape[0]):
        lp = {k: v[l].to(device) for k, v in layers.items()}
        _, x2d = layer_forward_fp(x, lp, cfg, cos, sin, backend)
        qlp = _quantize_layer_params(lp, cfg, qmodel_cfg.layer(l),
                                     hessians=hessians_for_layer(x2d, lp))
        # on through the QUANTIZED layer (llama_sequential order)
        x, _ = layer_forward_fp(x, {k: qlp[k] for k in lp}, cfg, cos, sin, backend)
        per_layer.append({k: v.to(home) for k, v in qlp.items()})
    return _finish_layers(out, cfg, qmodel_cfg, per_layer)


def quantize_model_fake(params: dict, cfg: MoEConfig, qmodel_cfg: QModelConfig,
                        method: str = "rtn", calib_tokens: torch.Tensor | None = None,
                        rotation: torch.Tensor | None = None,
                        backend: str = "ragged_dot", device="cuda") -> dict:
    """Mixed-scheme fake quantization of the routed, shared and dense-layer
    linears -> float params with fake-quantized weights and the act-bits
    arrays, ready for the standard forward.

    ``method``: 'rtn' | 'gptq' | 'rtn-had' | 'gptq-had'. GPTQ needs
    ``calib_tokens`` [B, S]. '-had' first fuses the norms and rotates the
    whole model (``rotation.rotate_model_hadamard``) by ``rotation`` (an
    orthogonal [H, H]; default ``random_hadamard_matrix(H)`` from a generator
    seeded 0). The work runs one layer at a time on ``device`` (the card
    unless the caller asks for the CPU); the results stay on the params'
    device. ``backend`` is ``ops.gmm``'s for GPTQ's float passes."""
    device = torch.device(device)
    if method.endswith("-had"):
        from .rotation import rotate_model_hadamard

        params = rotate_model_hadamard(params, cfg, torch.Generator().manual_seed(0),
                                       rotation)
        method = method[:-4]
    if method == "gptq":
        if calib_tokens is None:
            raise ValueError("GPTQ needs calibration tokens")
        return _quantize_gptq(params, cfg, qmodel_cfg, calib_tokens, backend, device)
    if method != "rtn":
        raise ValueError(f"method {method!r}: rtn | gptq | rtn-had | gptq-had")
    return _quantize_rtn(params, cfg, qmodel_cfg, device)
