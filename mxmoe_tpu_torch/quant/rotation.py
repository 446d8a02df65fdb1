"""QuaRot-style rotation as weight-space transforms of the params (port of
``mxmoe_tpu/quant/rotation.py``).

Fuse the RMSNorm scales into the linears that read them
(``fuse_layer_norms``), then multiply every hidden-space projection by an
orthogonal Q (``rotate_model``): the rotated model is the original one in
exact arithmetic. ``online_hadamard_down`` / ``rotate_down_weights`` are the
online Hadamard of the down projection's input and its pre-rotated weights.

Layout ([in, out] weights, y = x @ W):
  hidden-consuming linears (wq / wk / wv, kv_a, router, expert / shared /
  dense gate_up, shared_gate, lm_head):  W' = Q^T W
  hidden-producing linears (wo, expert / shared / dense down): W' = W Q
  embedding: E' = E Q
"""

from __future__ import annotations

import torch

from ..models.configs import MoEConfig
from .hadamard import hadamard_matrix, matmul_hadU, random_hadamard_matrix

# kv_b consumes the MLA latent, not the hidden state: it is left alone
_HIDDEN_IN = ("wq", "wk", "wv", "kv_a", "router", "shared_gate")
_HIDDEN_IN_STACKED = ("expert_gate_up",)                     # [L, E, H, out]
_HIDDEN_OUT = ("wo", "shared_down", "mlp_down")              # [.., in, H]
_HIDDEN_OUT_STACKED = ("expert_down",)                       # [L, E, in, H]


def _fuse_layer_stack(layers: dict) -> dict:
    """Fold input_norm / post_attn_norm of one stacked layer dict into the
    linears that read them; the norms become ones."""
    layers = dict(layers)
    g_in, g_post = layers["input_norm"], layers["post_attn_norm"]      # [L, H]

    def scale_rows(w, g):
        return w * (g[:, :, None] if w.dim() == 3 else g[:, None, :, None])

    for name in ("wq", "wk", "wv", "kv_a"):
        if name in layers:
            layers[name] = scale_rows(layers[name], g_in)
    for name in ("router", "expert_gate_up", "shared_gate_up", "shared_gate",
                 "mlp_gate_up"):
        if name in layers:
            layers[name] = scale_rows(layers[name], g_post)
    layers["input_norm"] = torch.ones_like(g_in)
    layers["post_attn_norm"] = torch.ones_like(g_post)
    return layers


def fuse_layer_norms(params: dict) -> dict:
    """Fold the RMSNorm scales into the following linears (ds2's
    ``dense_layers`` too, final_norm into lm_head); the norms become ones."""
    out = dict(params)
    out["layers"] = _fuse_layer_stack(params["layers"])
    if "dense_layers" in params:
        out["dense_layers"] = _fuse_layer_stack(params["dense_layers"])
    out["lm_head"] = params["lm_head"] * params["final_norm"][:, None]
    out["final_norm"] = torch.ones_like(params["final_norm"])
    return out


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum in the promoted dtype (a bf16 weight times the f32 rotation
    comes out f32, as in the reference), contiguous: torch may return a
    permuted view, and the kernels (K11 on the rotated float experts) take
    contiguous operands only."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt)).contiguous()


def _rotate_layer_stack(layers: dict, q: torch.Tensor) -> dict:
    layers = dict(layers)
    for name in _HIDDEN_IN + ("shared_gate_up", "mlp_gate_up"):
        if name in layers:
            layers[name] = _einsum("hk,lhd->lkd", q, layers[name])
    for name in _HIDDEN_IN_STACKED:
        if name in layers:
            layers[name] = _einsum("hk,lehd->lekd", q, layers[name])
    for name in _HIDDEN_OUT:
        if name in layers:
            layers[name] = _einsum("lih,hk->lik", layers[name], q)
    for name in _HIDDEN_OUT_STACKED:
        if name in layers:
            layers[name] = _einsum("leih,hk->leik", layers[name], q)
    return layers


def rotate_model(params: dict, q: torch.Tensor) -> dict:
    """Rotate a norm-fused model's hidden space by the orthogonal ``q``."""
    out = dict(params)
    out["layers"] = _rotate_layer_stack(params["layers"], q)
    if "dense_layers" in params:
        out["dense_layers"] = _rotate_layer_stack(params["dense_layers"], q)
    out["embed"] = _einsum("vh,hk->vk", params["embed"], q)
    out["lm_head"] = _einsum("hk,hv->kv", q, params["lm_head"])
    return out


def _rotation(cfg: MoEConfig, gen, q, device) -> torch.Tensor:
    if q is None:
        q = random_hadamard_matrix(cfg.hidden_size, gen)
    return q.to(device=device, dtype=torch.float32)


def rotate_model_hadamard(params: dict, cfg: MoEConfig,
                          gen: torch.Generator | None = None,
                          q: torch.Tensor | None = None) -> dict:
    """``fuse_layer_norms``, then the random-Hadamard rotation: ``q`` if the
    caller gives it, else ``random_hadamard_matrix(H, gen)``. On the params'
    device; the rotated weights come out in the promoted dtype (float32 for
    bf16 params), as the reference's."""
    q = _rotation(cfg, gen, q, params["embed"].device)
    return rotate_model(fuse_layer_norms(params), q)


def _fuse_rotate_one_layer(lp: dict, q: torch.Tensor) -> dict:
    """fuse + rotate ONE (unstacked) layer in float32 on ``q``'s device;
    each tensor back in its own dtype and device."""
    lp1 = {k: v[None].to(device=q.device, dtype=torch.float32) for k, v in lp.items()}
    rot = _rotate_layer_stack(_fuse_layer_stack(lp1), q)
    return {k: rot[k][0].to(device=lp[k].device, dtype=lp[k].dtype) for k in lp}


def rotate_model_hadamard_host(params: dict, cfg: MoEConfig,
                               gen: torch.Generator | None = None,
                               q: torch.Tensor | None = None,
                               device="cuda") -> dict:
    """The same fuse + rotation, one layer at a time: each layer goes to
    ``device``, is rotated in float32 and written back IN PLACE into the
    stacks in their stored dtype, so the peak is the params plus one float32
    layer (the host-staged convert path). embed, lm_head and final_norm are
    replaced."""
    device = torch.device(device)
    q = _rotation(cfg, gen, q, device)
    out = dict(params)
    for sub in ("layers", "dense_layers"):
        if sub not in params:
            continue
        stack = params[sub]
        for l in range(stack["input_norm"].shape[0]):
            new = _fuse_rotate_one_layer({k: v[l] for k, v in stack.items()}, q)
            for k, v in new.items():
                stack[k][l] = v
    # lm_head first: it may be a view of embed
    lm, fn = params["lm_head"], params["final_norm"]
    step = 16384                    # the f32 head in slices of the vocabulary
    new_lm = torch.empty(lm.shape, dtype=lm.dtype, device=lm.device)
    for v0 in range(0, lm.shape[1], step):
        blk = lm[:, v0:v0 + step].to(device=device, dtype=torch.float32)
        blk = blk * fn.to(device=device, dtype=torch.float32)[:, None]
        new_lm[:, v0:v0 + step] = (q.T @ blk).to(lm.dtype)
    emb = params["embed"]
    new_emb = torch.empty(emb.shape, dtype=emb.dtype, device=emb.device)
    for v0 in range(0, emb.shape[0], step):
        blk = emb[v0:v0 + step].to(device=device, dtype=torch.float32)
        new_emb[v0:v0 + step] = (blk @ q).to(emb.dtype)
    out["lm_head"], out["embed"] = new_lm, new_emb
    out["final_norm"] = torch.ones_like(fn)
    return out


def online_hadamard_down(h: torch.Tensor) -> torch.Tensor:
    """h @ H_N / sqrt(N) through the FWHT (use with down weights pre-rotated
    by :func:`rotate_down_weights`)."""
    return matmul_hadU(h)


def rotate_down_weights(down: torch.Tensor) -> torch.Tensor:
    """Down weights [.., N, H] -> H_N^T W, so that (h H_N) @ W' == h @ W."""
    n = down.shape[-2]
    h = hadamard_matrix(n, dtype=torch.float32, device=down.device)
    if down.dim() == 4:
        return _einsum("nm,lenh->lemh", h.T, down)
    return _einsum("nm,lnh->lmh", h.T, down)
