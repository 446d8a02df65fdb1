"""Per-linear-block quantization-loss calibration, layer_out_norm (port of
``mxmoe_tpu/quant/calibrate.py``).

For each layer: the float layer output against the output with exactly one
expert linear (gate | up | down) fake-quantized, its weights AND its input
activations, every layer fed float inputs; the loss is
``||q_out - fp_out||_F`` over the whole calibration tensor. Output:
``{layer: {expert: [gate_err, up_err, down_err]}}``, the schema the
bitwidth solver reads (the shared expert is expert index E; ds2's dense
first layers are the pseudo-layers ``dense-<i>`` with one expert "0").

A quantized linear only perturbs the rows routed to its expert, and the MoE
combine is linear in the experts' outputs, so ONE grouped-matmul pass per
(linear, scheme) gives the loss of every expert at once:

    d_down_out = gmm(dh, W_down);  err2[e] = sum over e's rows of ||w_combine * d||^2

(``moe_calib_errors``; held against a per-expert oracle in the tests). The
grouped matmuls go through ``ops.gmm``: ``backend="pallas"`` is K11 on a
card.

``calibrate_model`` streams the layers: the model stays where it is (the
host), one layer at a time goes to ``device`` (the card unless the caller
asks for the CPU). ``-had`` methods rotate each layer on the device right
after its copy, and the embeddings once after the gather, so no rotated copy
of the model exists.
"""

from __future__ import annotations

import json
import os
import time

import torch
import torch.nn.functional as F

from ..models.configs import MoEConfig
from ..models.layers import (attention_dispatch, rms_norm, shared_expert_ffn,
                             silu_mul)
from ..ops.dispatch import (combine_tokens, expert_of_rows, gather_tokens,
                            make_dispatch, route_topk)
from ..ops.gmm import gmm
from .rtn import fake_quant
from .schemes import LINEAR_NAMES, QLinearConfig


def _fq_weight(w: torch.Tensor, cfg: QLinearConfig) -> torch.Tensor:
    """Fake-quant stacked [E, K, N] weights, grouped along K per column, in
    ``w``'s dtype. The reference runs the calibration compiled, where the
    division by the constant range becomes a multiply by its reciprocal."""
    if cfg.w_bits >= 16:
        return w
    w_nk = fake_quant(w.transpose(-1, -2), cfg.w_bits, cfg.w_gsize, cfg.w_sym,
                      cfg.w_clip, scale_by_reciprocal=True)
    return w_nk.transpose(-1, -2).contiguous()


def _fq_act(x: torch.Tensor, cfg: QLinearConfig) -> torch.Tensor:
    if cfg.a_bits >= 16:
        return x
    return fake_quant(x, cfg.a_bits, cfg.a_gsize, cfg.a_sym, cfg.a_clip,
                      scale_by_reciprocal=True)


def _sum_sq(delta: torch.Tensor, mult=1.0) -> torch.Tensor:
    return ((mult * delta.float()) ** 2).sum()


def moe_calib_errors(x2d: torch.Tensor,        # [T, H] MoE-block inputs (post-norm)
                     lp: dict, cfg: MoEConfig, qcfg: QLinearConfig,
                     backend: str = "ragged_dot", fq_weights: dict | None = None,
                     only: str | None = None) -> torch.Tensor:
    """Squared layer-out error of every (expert, linear) under one scheme ->
    f32 [E (+1 shared), 3] (gate, up, down), or [E (+1), 1] for the linear
    ``only`` names (one fake-quantized weight set resident at a time).
    ``fq_weights`` supplies quantized weights (the GPTQ path): keys
    gate / up / down [E, K, N] and shared_gate / shared_up / shared_down;
    an absent key falls back to RTN."""
    e = cfg.num_experts
    n = cfg.moe_intermediate_size
    gate_up = lp["expert_gate_up"]                                  # [E, H, 2N]
    wg, wu = gate_up[..., :n].contiguous(), gate_up[..., n:].contiguous()
    wd = lp["expert_down"]                                          # [E, N, H]
    fqw = fq_weights or {}

    def fq_w(w, name):
        return fqw[name] if name in fqw else _fq_weight(w, qcfg)

    routing = route_topk(x2d @ lp["router"], cfg.top_k, cfg.norm_topk_prob,
                         cfg.routed_scaling_factor)
    disp = make_dispatch(routing, e)
    xs = gather_tokens(x2d, disp)                                   # [T*k, H]
    gs = disp.group_sizes
    w_comb = disp.combine_weights[:, None].float()
    row_expert = expert_of_rows(gs, xs.shape[0])

    def run(a, w):
        return gmm(a.contiguous(), w.contiguous(), gs, backend=backend)

    g_fp = run(xs, wg)
    u_fp = run(xs, wu)
    h_fp = F.silu(g_fp) * u_fp
    d_fp = run(h_fp, wd)
    xs_fq = _fq_act(xs, qcfg)

    def per_expert_sq(delta_rows):
        contrib = ((w_comb * delta_rows.float()) ** 2).sum(-1)
        # a sorted accumulate: the same sums in the same order every run
        return torch.zeros(e, device=contrib.device).index_put_(
            (row_expert,), contrib, accumulate=True)

    cols = []
    if only in (None, "gate"):
        # gate quantized: moves h through silu(gate), then the float down
        dh = F.silu(run(xs_fq, fq_w(wg, "gate"))) * u_fp - h_fp
        cols.append(per_expert_sq(run(dh, wd)))
    if only in (None, "up"):
        dh = F.silu(g_fp) * run(xs_fq, fq_w(wu, "up")) - h_fp
        cols.append(per_expert_sq(run(dh, wd)))
    if only in (None, "down"):
        # down quantized: its input is h_fp, fake-quantized
        cols.append(per_expert_sq(run(_fq_act(h_fp, qcfg), fq_w(wd, "down")) - d_fp))
    errs = torch.stack(cols, dim=-1)                                # [E, 3 | 1]

    if cfg.shared_expert_intermediate_size > 0:
        # the shared expert: index E, with a scheme of its own
        ns = cfg.shared_expert_intermediate_size
        sg_up = lp["shared_gate_up"]
        swg, swu = sg_up[..., :ns], sg_up[..., ns:]
        swd = lp["shared_down"]
        gate_mult = (torch.sigmoid(x2d @ lp["shared_gate"]).float()
                     if cfg.has_shared_expert_gate else 1.0)
        sg = x2d @ swg
        su = x2d @ swu
        sh = F.silu(sg) * su
        sd = sh @ swd
        x_fq = _fq_act(x2d, qcfg)

        def sfq(w, name):
            return fqw[name] if name in fqw else _fq_weight(w, qcfg)

        se = []
        if only in (None, "gate"):
            g_q = x_fq @ sfq(swg, "shared_gate")
            se.append(_sum_sq((F.silu(g_q) * su - sh) @ swd, gate_mult))
        if only in (None, "up"):
            u_q = x_fq @ sfq(swu, "shared_up")
            se.append(_sum_sq((F.silu(sg) * u_q - sh) @ swd, gate_mult))
        if only in (None, "down"):
            d_q = _fq_act(sh, qcfg) @ sfq(swd, "shared_down")
            se.append(_sum_sq(d_q - sd, gate_mult))
        errs = torch.cat([errs, torch.stack(se)[None]], dim=0)
    return errs


def dense_calib_errors(x2d: torch.Tensor,      # [T, H] dense-MLP inputs
                       dlp: dict, cfg: MoEConfig, qcfg: QLinearConfig,
                       fq_weights: dict | None = None) -> torch.Tensor:
    """Squared layer-out error [1, 3] of a dense first layer's MLP (ds2's
    pseudo-expert, calibration row ``dense-<i>``)."""
    nd = dlp["mlp_gate_up"].shape[-1] // 2
    wg, wu = dlp["mlp_gate_up"][..., :nd], dlp["mlp_gate_up"][..., nd:]
    wd = dlp["mlp_down"]
    fqw = fq_weights or {}

    def fq_w(w, name):
        return fqw[name] if name in fqw else _fq_weight(w, qcfg)

    g_fp = x2d @ wg
    u_fp = x2d @ wu
    h_fp = F.silu(g_fp) * u_fp
    d_fp = h_fp @ wd
    x_fq = _fq_act(x2d, qcfg)
    e_g = _sum_sq((F.silu(x_fq @ fq_w(wg, "gate")) * u_fp - h_fp) @ wd)
    e_u = _sum_sq((F.silu(g_fp) * (x_fq @ fq_w(wu, "up")) - h_fp) @ wd)
    e_d = _sum_sq(_fq_act(h_fp, qcfg) @ fq_w(wd, "down") - d_fp)
    return torch.stack([e_g, e_u, e_d])[None]


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


def _loss_path(save_dir: str, model_id: str, method: str, scheme: str) -> str:
    return os.path.join(save_dir, f"{model_id}-MOE-layer_out_norm-{method}-{scheme}.json")


def load_resumable(save_dir: str, model_id: str, method: str,
                   schemes: dict) -> dict[str, dict]:
    """The per-layer calibration checkpoints in ``save_dir`` -> partial
    losses {scheme: {layer: ...}} (resume)."""
    out = {}
    for name in schemes:
        path = _loss_path(save_dir, model_id, method, name)
        if os.path.exists(path):
            with open(path) as f:
                out[name] = json.load(f)
    return out


def _errors_to_dict(err2: torch.Tensor) -> dict:
    err = err2.double().sqrt().cpu()
    return {str(e): [float(v) for v in err[e]] for e in range(err.shape[0])}


def calibrate_model(params: dict, tokens: torch.Tensor, cfg: MoEConfig,
                    schemes: dict[str, QLinearConfig], save_dir: str | None = None,
                    model_id: str = "model", method: str = "rtn",
                    backend: str = "ragged_dot", resume: bool = False,
                    device="cuda", rotation: torch.Tensor | None = None,
                    one_linear: bool | None = None, verbose: bool = True) -> dict:
    """Layer-streamed calibration over all layers x schemes -> {scheme:
    {layer: {expert: [g, u, d]}}}; with ``save_dir``, one JSON per scheme
    rewritten after each layer (``<model_id>-MOE-layer_out_norm-<method>-
    <scheme>.json``), which ``resume`` reads back to skip the layers done.

    ``method``: rtn | gptq | rtn-had | gptq-had. The params stay where they
    are; each layer is copied to ``device`` (the card unless the caller asks
    for the CPU) once and every pass reuses it. '-had' fuses the norms and
    rotates each layer on the device after its copy (``rotation``, an
    orthogonal [H, H]; default ``random_hadamard_matrix(H)`` from a
    generator seeded 0) and the embedded rows once. GPTQ quantizes every
    expert linear of a layer per scheme from the float pass's Hessians;
    ``one_linear`` (default: on a card) does it one linear at a time, so one
    fake-quantized weight set is resident."""
    device = torch.device(device)
    if one_linear is None:
        one_linear = device.type == "cuda"
    base = method[:-4] if method.endswith("-had") else method
    if base not in ("rtn", "gptq"):
        raise ValueError(f"method {method!r}: rtn | gptq | rtn-had | gptq-had")
    q_rot = None
    if method.endswith("-had"):
        from .hadamard import random_hadamard_matrix
        from .rotation import _fuse_rotate_one_layer

        q_rot = (rotation if rotation is not None else
                 random_hadamard_matrix(cfg.hidden_size, torch.Generator().manual_seed(0)))
        q_rot = q_rot.to(device=device, dtype=torch.float32)

    def stage(stack, l):
        lp = {k: v[l].to(device) for k, v in stack.items()}
        return _fuse_rotate_one_layer(lp, q_rot) if q_rot is not None else lp

    from ..models.layers import make_rope_tables

    embed = params["embed"]
    toks = tokens.to(device=embed.device, dtype=torch.long)
    x = embed[toks.clamp(0, embed.shape[0] - 1)].to(device)
    if q_rot is not None:
        # the rotation acts on the hidden axis: gather then rotate
        x = (x.float() @ q_rot).to(x.dtype)
    cos, sin = make_rope_tables(cfg, torch.arange(toks.shape[1], device=device))

    losses: dict[str, dict] = {name: {} for name in schemes}
    if "dense_layers" in params:
        # ds2's dense first layers: pseudo-layers "dense-<i>", one expert "0",
        # the rows propagated through the float layer
        dls = params["dense_layers"]
        for dl in range(dls["input_norm"].shape[0]):
            dlp = stage(dls, dl)
            x, dx2d = dense_layer_forward_fp(x, dlp, cfg, cos, sin)
            for name, qc in schemes.items():
                fqw = _gptq_dense_fq_weights(dx2d, dlp, qc) if base == "gptq" else None
                err2 = dense_calib_errors(dx2d, dlp, cfg, qc, fq_weights=fqw)
                losses[name][f"dense-{dl}"] = _errors_to_dict(err2)
            del dlp
    if resume and save_dir:
        for name, d in load_resumable(save_dir, model_id, method, schemes).items():
            losses[name].update(d)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)

    layers = params["layers"]
    num_layers = layers["router"].shape[0]
    t0 = time.perf_counter()
    for l in range(num_layers):
        lp = stage(layers, l)
        x_next, x2d = layer_forward_fp(x, lp, cfg, cos, sin, backend)
        if resume and all(str(l) in losses[name] for name in schemes):
            x = x_next              # calibrated before: propagate only
            continue
        for name, qc in schemes.items():
            if base == "gptq" and one_linear:
                cols = []
                for lin in LINEAR_NAMES:
                    fqw = _gptq_layer_fq_weights(x2d, lp, qc, cfg, backend, only=lin)
                    cols.append(moe_calib_errors(x2d, lp, cfg, qc, backend,
                                                 fq_weights=fqw, only=lin))
                    del fqw
                err2 = torch.cat(cols, dim=1)
            else:
                fqw = (_gptq_layer_fq_weights(x2d, lp, qc, cfg, backend)
                       if base == "gptq" else None)
                err2 = moe_calib_errors(x2d, lp, cfg, qc, backend, fq_weights=fqw)
                del fqw
            losses[name][str(l)] = _errors_to_dict(err2)
            if save_dir:
                with open(_loss_path(save_dir, model_id, method, name), "w") as f:
                    json.dump(losses[name], f)
        x = x_next
        del lp
        if verbose:
            print(f"[calibrate +{time.perf_counter() - t0:.1f}s] layer {l + 1}/"
                  f"{num_layers} done", flush=True)
    return losses


def _gptq_dense_fq_weights(x2d: torch.Tensor, dlp: dict, qcfg: QLinearConfig) -> dict:
    """GPTQ fake weights of one dense layer's MLP linears (Hessians from
    x2d and the float SwiGLU output)."""
    from .gptq import accumulate_hessian, gptq_quantize_kn

    if qcfg.w_bits >= 16:
        return {}
    nd = dlp["mlp_gate_up"].shape[-1] // 2
    wg, wu = dlp["mlp_gate_up"][..., :nd], dlp["mlp_gate_up"][..., nd:]
    wd = dlp["mlp_down"]
    sh = F.silu(x2d @ wg) * (x2d @ wu)
    h_x = accumulate_hessian(x2d)[None]
    h_s = accumulate_hessian(sh)[None]
    return {"gate": gptq_quantize_kn(wg[None], h_x, qcfg).w_fq[0].to(wg.dtype),
            "up": gptq_quantize_kn(wu[None], h_x, qcfg).w_fq[0].to(wu.dtype),
            "down": gptq_quantize_kn(wd[None], h_s, qcfg).w_fq[0].to(wd.dtype)}


def _gptq_layer_fq_weights(x2d: torch.Tensor, lp: dict, qcfg: QLinearConfig,
                           cfg: MoEConfig, backend: str = "ragged_dot",
                           expert_chunk: int = 16,
                           only: str | None = None) -> dict:
    """GPTQ fake weights of every expert linear of one layer under one
    scheme (all, or the linear ``only`` names), in the model's dtype.

    The Hessians come from the float layer pass over the calibration rows
    (the routed experts' from their routed rows, the shared expert's from
    all of them); the sweep takes ``expert_chunk`` experts at a time, so one
    chunk's float32 working set exists at once."""
    from .gptq import accumulate_hessian, gptq_quantize_kn

    if qcfg.w_bits >= 16:
        return {}
    e = cfg.num_experts
    n = cfg.moe_intermediate_size
    gate_up, wd = lp["expert_gate_up"], lp["expert_down"]
    dtype = gate_up.dtype
    routing = route_topk(x2d @ lp["router"], cfg.top_k, cfg.norm_topk_prob,
                         cfg.routed_scaling_factor)
    disp = make_dispatch(routing, e)
    xs = gather_tokens(x2d, disp)
    gs = disp.group_sizes

    def fq_kn(w, rows):
        h = accumulate_hessian(rows, gs, e)                          # [E, K, K]
        parts = [gptq_quantize_kn(w[s:s + expert_chunk], h[s:s + expert_chunk],
                                  qcfg).w_fq.to(dtype)
                 for s in range(0, e, expert_chunk)]
        del h
        return torch.cat(parts, 0)

    out = {}
    if only in (None, "gate"):
        out["gate"] = fq_kn(gate_up[..., :n], xs)
    if only in (None, "up"):
        out["up"] = fq_kn(gate_up[..., n:], xs)
    if only in (None, "down"):
        h_fp = (F.silu(gmm(xs, gate_up[..., :n].contiguous(), gs, backend=backend))
                * gmm(xs, gate_up[..., n:].contiguous(), gs, backend=backend))
        out["down"] = fq_kn(wd, h_fp)
    if cfg.shared_expert_intermediate_size > 0 and "shared_gate_up" in lp:
        ns = cfg.shared_expert_intermediate_size
        swg, swu = lp["shared_gate_up"][..., :ns], lp["shared_gate_up"][..., ns:]
        swd = lp["shared_down"]

        def fq_shared(w, h):
            return gptq_quantize_kn(w[None], h[None], qcfg).w_fq[0].to(dtype)

        if only in (None, "gate", "up"):
            h_x = accumulate_hessian(x2d)
            if only in (None, "gate"):
                out["shared_gate"] = fq_shared(swg, h_x)
            if only in (None, "up"):
                out["shared_up"] = fq_shared(swu, h_x)
        if only in (None, "down"):
            out["shared_down"] = fq_shared(swd, accumulate_hessian(F.silu(x2d @ swg)
                                                                    * (x2d @ swu)))
    return out


def model_out_norm_errors(params: dict, tokens: torch.Tensor, cfg: MoEConfig,
                          qcfg: QLinearConfig, layer_idx: int,
                          backend: str = "ragged_dot", device="cuda"):
    """||model_out_q - model_out_fp||_F per (expert, linear) of one layer ->
    float64 numpy [E (+1 shared), 3]: the reference's alternative metric,
    one block quantized and the WHOLE model re-run (L x E x 3 forwards; no
    shortcut exists for the nonlinear downstream). On ``device``."""
    import numpy as np

    from ..models import model as model_mod
    from ..models.layers import MoEImpl

    def to(t):
        return {k: to(v) if isinstance(v, dict) else v.to(device) for k, v in t.items()}

    params = to(params)
    toks = tokens.to(device)
    impl = MoEImpl(kind="ragged", gmm_backend=backend)

    def fwd(p):
        with torch.no_grad():
            return model_mod.forward_hidden(p, toks, cfg, impl).float()

    ref = fwd(params)
    n = cfg.moe_intermediate_size
    e_tot = cfg.num_experts
    has_shared = (cfg.shared_expert_intermediate_size > 0
                  and "shared_gate_up" in params["layers"])
    errs = np.zeros((e_tot + int(has_shared), 3))

    def err_with(name, index, w):
        layers = dict(params["layers"])
        layers[name] = layers[name].clone()
        layers[name][index] = _fq_weight(w[None], qcfg)[0].to(w.dtype)
        return float(((fwd({**params, "layers": layers}) - ref) ** 2).sum().sqrt())

    gate_up = params["layers"]["expert_gate_up"]                     # [L, E, H, 2N]
    down = params["layers"]["expert_down"]
    li = layer_idx
    for e in range(e_tot):
        errs[e, 0] = err_with("expert_gate_up", (li, e, slice(None), slice(0, n)),
                              gate_up[li, e, :, :n])
        errs[e, 1] = err_with("expert_gate_up", (li, e, slice(None), slice(n, 2 * n)),
                              gate_up[li, e, :, n:])
        errs[e, 2] = err_with("expert_down", (li, e), down[li, e])
    if has_shared:
        ns = cfg.shared_expert_intermediate_size
        for bi, (name, index) in enumerate((
                ("shared_gate_up", (li, slice(None), slice(0, ns))),
                ("shared_gate_up", (li, slice(None), slice(ns, 2 * ns))),
                ("shared_down", (li,)))):
            errs[e_tot, bi] = err_with(name, index, params["layers"][name][index])
    return errs


def fisher_errors(*args, **kw):
    """The Fisher-information metric: a stub in the reference too;
    layer_out_norm is the production metric."""
    raise NotImplementedError("fisher metric is a stub (reference parity)")


def _main(argv=None):
    import argparse
    import dataclasses

    from ..models import configs
    from ..models import model as model_mod
    from .data import get_calibration_tokens
    from .schemes import parse_scheme

    ap = argparse.ArgumentParser(
        description="layer_out_norm quant-loss calibration: one JSON per scheme, "
                    "{layer: {expert: [gate, up, down]}}")
    ap.add_argument("--model", default="qwen2_moe")
    ap.add_argument("--method", default="rtn", choices=["rtn", "rtn-had", "gptq", "gptq-had"])
    ap.add_argument("--qcfg", nargs="+", default=["w8a8_g-1_sym", "w4a4_g-1_sym"])
    ap.add_argument("--ckpt", default=None,
                    help="HF safetensors dir (default: random weights, seed 0)")
    ap.add_argument("--nsamples", type=int, default=8)
    ap.add_argument("--seqlen", type=int, default=512)
    ap.add_argument("--layers", type=int, default=None, help="cut the depth")
    ap.add_argument("--save_dir", default="calib")
    ap.add_argument("--w_clip", default=None, choices=[None, "mse"],
                    help="mse: grid-searched weight clip on every scheme (the "
                         "_mse scheme suffix)")
    ap.add_argument("--backend", default="pallas", choices=["pallas", "ragged_dot"],
                    help="the grouped matmul: K11 (pallas) or the stock product")
    ap.add_argument("--device", default="cuda", help="cpu | cuda | cuda:N")
    args = ap.parse_args(argv)

    cfg = configs.config_for(args.model)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.ckpt:
        from ..models.hf_loader import params_from_safetensors

        params = params_from_safetensors(args.ckpt, cfg)
    else:
        params = model_mod.init_params(cfg, torch.Generator().manual_seed(0),
                                       dtype=torch.float32, device="cpu")
    tokens = get_calibration_tokens(args.nsamples, args.seqlen,
                                    vocab_size=cfg.vocab_size)
    schemes = {name: parse_scheme(name) for name in args.qcfg}
    if args.w_clip == "mse":
        schemes = {n: dataclasses.replace(c, w_clip="mse") for n, c in schemes.items()}
    calibrate_model(params, tokens, cfg, schemes, save_dir=args.save_dir,
                    model_id=args.model, method=args.method, backend=args.backend,
                    resume=True, device=args.device)
    print(f"calibration losses -> {args.save_dir}")


if __name__ == "__main__":
    _main()
