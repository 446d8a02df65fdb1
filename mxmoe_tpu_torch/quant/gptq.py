"""GPTQ (Hessian-based weight quantization), batched over experts (port of
``mxmoe_tpu/quant/gptq.py``).

  * H = 2 sum x x^T over the calibration rows (``accumulate_hessian``; per
    expert over its contiguous rows of the expert-sorted activations);
  * damping by percdamp x mean(diag H), dead columns (zero diagonal) zeroed;
  * U, the upper Cholesky factor of H^-1 (H^-1 = U^T U), computed without
    forming H^-1: reverse both axes of H, factor, reverse back (H = R R^T,
    R upper), and U = R^-1 by a triangular solve against the identity;
  * the blocked column sweep: quantize column i, err = (w - q) / U[i, i],
    update the block's later columns by err x U[i, i+1:], then the columns
    after the block by one product Err @ U[block, after].

All experts of a call run at once ([E, N, K] operands, batched Cholesky and
solves). The dense products, factors and solves are the stock torch ops
(the reference takes stock XLA ops outside any Pallas kernel). Where the
reference's compiled sweep contracts a multiply-add into an FMA (the
dequantized column ``q * scale + zp`` and the in-block update ``w - err *
u``), the port computes it in float64 and rounds once; the products that
feed later columns still sum in another order than XLA's, so a rounding tie
now and then quantizes a column to the neighbouring code
(``tests/test_torch_gptq.py`` states the measured agreement).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .rtn import _mse_search, quant_ranges
from .schemes import QLinearConfig


class GPTQResult(NamedTuple):
    codes: torch.Tensor   # [E, N, K] integer codes (float32)
    scale: torch.Tensor   # [E, N, K//g]
    zp: torch.Tensor      # [E, N, K//g]
    w_fq: torch.Tensor    # [E, N, K] fake-quantized weights


# f32 elements of masked rows a chunk of experts may hold (1 GiB)
GRAM_CHUNK_ELEMS = 1 << 28


def _grouped_gram(xs: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """[E, K, K] = xs[rows of e]^T xs[rows of e] in float32 for every expert.
    On the CPU a loop over the experts' row slices. On a card the sizes are
    never read on the host: a masked batched product over chunks of experts
    (every expert multiplies all M rows, its others masked to zero: E times
    the products' work, in exact float32; ``torch._grouped_mm`` would do 1/E
    of it, but its float32 path reads the offsets on the host and its bf16
    path rounds the sums to bf16)."""
    e, (m, k) = group_sizes.numel(), xs.shape
    xf = xs.float()
    if xs.device.type == "cpu":
        out = torch.zeros((e, k, k), dtype=torch.float32)
        start = 0
        for g, size in enumerate(group_sizes.tolist()):
            rows = xf[start:start + size]
            out[g] = rows.T @ rows
            start += size
        return out
    return _masked_gram(xf, group_sizes)


def _masked_gram(xf: torch.Tensor, group_sizes: torch.Tensor,
                 chunk_elems: int = GRAM_CHUNK_ELEMS) -> torch.Tensor:
    """The card's form of ``_grouped_gram`` (float32 rows ``xf``)."""
    e, (m, k) = group_sizes.numel(), xf.shape
    ends = torch.cumsum(group_sizes.long(), 0)
    starts = ends - group_sizes.long()
    row = torch.arange(m, device=xf.device)
    out = torch.empty((e, k, k), dtype=torch.float32, device=xf.device)
    step = max(1, chunk_elems // max(m * k, 1))
    for e0 in range(0, e, step):
        e1 = min(e, e0 + step)
        mask = (row >= starts[e0:e1, None]) & (row < ends[e0:e1, None])   # [c, M]
        xm = xf * mask[..., None]                                         # [c, M, K]
        out[e0:e1] = torch.bmm(xm.transpose(1, 2), xf.expand(e1 - e0, m, k))
    return out


def accumulate_hessian(xs: torch.Tensor, group_sizes: torch.Tensor | None = None,
                       num_experts: int | None = None,
                       expert_slice: tuple[int, int] | None = None) -> torch.Tensor:
    """H[e] = 2 sum over the rows of e of x x^T.

    ``xs`` [M, K]: expert-sorted rows with ``group_sizes`` [E], or one batch
    (``group_sizes=None``) -> H [K, K]. Rows past ``sum(group_sizes)`` count
    for no expert (the reference's one-hot gives them to the last one; the
    unaligned dispatch that feeds GPTQ has none). ``expert_slice=(a, b)``:
    experts [a, b) only.

    The reference forms them as a one-hot einsum; here the CPU multiplies
    each expert's rows once and a card runs a masked batched product in
    chunks of experts, with no host read of the sizes (``_grouped_gram``)."""
    if group_sizes is None:
        xf = xs.float()
        return 2.0 * (xf.T @ xf)
    e = num_experts or group_sizes.numel()
    if group_sizes.numel() != e:
        raise ValueError(f"accumulate_hessian: {group_sizes.numel()} sizes for {e} experts")
    h = 2.0 * _grouped_gram(xs, group_sizes)
    if expert_slice is not None:
        h = h[expert_slice[0]: expert_slice[1]]
    return h


def _find_group_params(w_cols: torch.Tensor, bits: float, sym: bool,
                       clip=(1.0, 1.0), reciprocal: bool = False):
    """Min-max (or ``clip="mse"``: grid-searched) scale / zp over the last
    axis: [..., g] -> [...] each. ``reciprocal``: multiply by f32(1/upper),
    as the reference's compiled sweep does for its dynamic groups, instead of
    dividing."""
    upper, lower, eff_sym = quant_ranges(bits, sym)

    def over_upper(x):
        if reciprocal:
            return x * torch.tensor(1.0 / upper, dtype=torch.float32, device=x.device)
        # a tensor divisor: on a card, torch divides by a Python number as a
        # multiply by its reciprocal
        return x / torch.tensor(upper, dtype=torch.float32, device=x.device)

    if isinstance(clip, str):
        if clip != "mse":
            raise ValueError(f"clip {clip!r}: a (lo, hi) pair or 'mse'")
        scale, zp = _mse_search(w_cols, upper, lower, eff_sym)
    elif eff_sym:
        scale = over_upper(w_cols.abs().amax(-1))
        zp = torch.zeros_like(scale)
    else:
        gmin = w_cols.amin(-1) * clip[0]
        gmax = w_cols.amax(-1) * clip[1]
        scale = over_upper(gmax - gmin)
        zp = gmin
    return torch.clamp(scale, min=1e-10), zp


def _quant_col(w: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor,
               bits: float, sym: bool):
    """One column: codes, and their dequantized value rounded once (the
    reference's FMA)."""
    upper, lower, _ = quant_ranges(bits, sym)
    q = torch.clamp(torch.round((w - zp) / scale), lower, upper)
    return q, (q.double() * scale.double() + zp.double()).float()


def _tri_inv_chunked(r_up: torch.Tensor,
                     max_rhs_elems: int = 32 * 1024 * 1024) -> torch.Tensor:
    """Inverse of a batched upper-triangular factor [E, K, K], solved against
    the identity in column chunks when the problem exceeds
    ``max_rhs_elems`` (bounds the solver's temporaries)."""
    e, k, _ = r_up.shape
    dev, dt = r_up.device, r_up.dtype
    if e * k * k <= max_rhs_elems:
        eye = torch.eye(k, dtype=dt, device=dev).expand(e, k, k)
        return torch.linalg.solve_triangular(r_up, eye, upper=True)
    chunk = max(256, (max_rhs_elems // (e * k)) // 128 * 128)
    cols = []
    for s in range(0, k, chunk):
        c = min(chunk, k - s)
        rhs = torch.zeros((k, c), dtype=dt, device=dev)
        rhs[torch.arange(s, s + c), torch.arange(c)] = 1.0
        cols.append(torch.linalg.solve_triangular(r_up, rhs.expand(e, k, c),
                                                  upper=True))
    return torch.cat(cols, dim=-1)


def gptq_quantize(w: torch.Tensor,             # [E, N, K] (rows = output channels)
                  hessian: torch.Tensor,       # [E, K, K]
                  cfg: QLinearConfig,
                  blocksize: int = 128,
                  percdamp: float = 0.01,
                  act_order: bool = False,
                  static_groups: bool = False,
                  _perm_groups: torch.Tensor | None = None,
                  _static_params=None) -> GPTQResult:
    """Blocked GPTQ sweep for all experts at once, on ``w``'s device.

    ``act_order``: columns in descending diag(H) order per expert; codes and
    weights come back in the original order. ``static_groups``: per-group
    (scale, zp) from the original weights before the sweep, kept aligned to
    the original K-groups (with ``act_order`` too), so grouped codes stay
    servable by the grouped / packed kernels."""
    if act_order:
        return _gptq_quantize_actorder(w, hessian, cfg, blocksize, percdamp,
                                       static_groups)
    e, n, k = w.shape
    bits, sym, clip = cfg.w_bits, cfg.w_sym, cfg.w_clip
    gsize = k if cfg.w_gsize == -1 else cfg.w_gsize
    if k % gsize:
        raise ValueError(f"gptq_quantize: K={k} % gsize={gsize}")
    # blocks align with groups, so a group's scale can be taken from the
    # current (error-compensated) weights when its block starts
    blocksize = min(blocksize, k) if cfg.w_gsize == -1 else gsize
    if k % blocksize:
        # a K that no block divides (ds2's 10944-wide dense MLP): the largest
        # common divisor; the sweep is the same at any block size
        blocksize = math.gcd(k, blocksize)
    dev = w.device
    wf = w.float()
    h = hessian.float()

    # dead columns (zero diagonal) -> diagonal 1, weight 0
    diag = torch.diagonal(h, dim1=-2, dim2=-1)                 # [E, K]
    dead = (diag == 0).float()
    eye = torch.eye(k, device=dev)
    h = h + eye[None] * dead[:, None, :]
    wf = wf * (1.0 - dead[:, None, :])

    use_static = static_groups and cfg.w_gsize != -1
    if use_static and _static_params is None:
        _static_params = _find_group_params(wf.reshape(e, n, k // gsize, gsize),
                                            bits, sym, clip)

    damp = percdamp * diag.mean(-1)
    h = h + eye[None] * damp[:, None, None]
    r_up = torch.linalg.cholesky(h.flip(-1, -2)).flip(-1, -2)  # upper, H = R R^T
    hinv_u = _tri_inv_chunked(r_up)                           # U = R^-1

    if cfg.w_gsize == -1:
        scale_g, zp_g = _find_group_params(wf, bits, sym, clip)   # [E, N]
        scale_all, zp_all = scale_g[..., None], zp_g[..., None]
    elif use_static:
        scale_all, zp_all = (t.clone() for t in _static_params)
    else:
        scale_all = torch.zeros((e, n, k // gsize), device=dev)
        zp_all = torch.zeros_like(scale_all)
    q_all = torch.zeros((e, n, k), device=dev)
    eidx = torch.arange(e, device=dev)

    for s in range(0, k, blocksize):
        b = blocksize
        wblk = wf[:, :, s:s + b].clone()                          # [E, N, B]
        u_in = hinv_u[:, s:s + b, s:s + b]                        # [E, B, B]
        if cfg.w_gsize != -1 and not use_static:
            # grouped: scales from the current block, per group
            g0 = s // gsize
            sc_b, zp_b = _find_group_params(
                wblk.reshape(e, n, b // gsize, gsize), bits, sym, clip,
                reciprocal=True)
            scale_all[:, :, g0:g0 + b // gsize] = sc_b
            zp_all[:, :, g0:g0 + b // gsize] = zp_b
        errblk = torch.empty_like(wblk)
        for ci in range(b):
            wcol = wblk[:, :, ci]                                 # [E, N]
            if cfg.w_gsize == -1:
                sc, zp = scale_all[..., 0], zp_all[..., 0]
            elif _perm_groups is not None:
                # act order + static groups: the column's original group,
                # per expert
                gidx = _perm_groups[:, s + ci]                    # [E]
                sc = scale_all[eidx, :, gidx]
                zp = zp_all[eidx, :, gidx]
            else:
                gidx = (s + ci) // gsize
                sc, zp = scale_all[:, :, gidx], zp_all[:, :, gidx]
            qcol, dqcol = _quant_col(wcol, sc, zp, bits, sym)
            err = (wcol - dqcol) / u_in[:, ci, ci][:, None]        # [E, N]
            q_all[:, :, s + ci] = qcol
            errblk[:, :, ci] = err
            if ci + 1 < b:
                # the later columns of the block, each rounded once
                urow = u_in[:, ci, ci + 1:]                        # [E, B']
                wblk[:, :, ci + 1:] = (
                    wblk[:, :, ci + 1:].double()
                    - err.double()[:, :, None] * urow.double()[:, None, :]).float()
        if s + b < k:
            # the columns after the block: W[:, s+B:] -= Err @ U[s:s+B, s+B:]
            wf[:, :, s + b:] -= torch.bmm(errblk, hinv_u[:, s:s + b, s + b:])

    gdim = k // gsize
    w_fq = (q_all.reshape(e, n, gdim, gsize) * scale_all[..., None]
            + zp_all[..., None]).reshape(e, n, k)
    return GPTQResult(codes=q_all, scale=scale_all, zp=zp_all, w_fq=w_fq)


def gptq_quantize_kn(w_kn: torch.Tensor,      # [E, K, N] kernel layout
                     hessian: torch.Tensor,   # [E, K, K]
                     cfg: QLinearConfig, **kw) -> GPTQResult:
    """:func:`gptq_quantize` for the [K, N] layout (rows along N): codes and
    w_fq come back [E, K, N], scale and zp [E, N, K//g]."""
    res = gptq_quantize(w_kn.transpose(-1, -2), hessian, cfg, **kw)
    return GPTQResult(codes=res.codes.transpose(-1, -2), scale=res.scale,
                      zp=res.zp, w_fq=res.w_fq.transpose(-1, -2))


def _gptq_quantize_actorder(w, hessian, cfg, blocksize, percdamp,
                            static_groups=False):
    e, n, k = w.shape
    diag = torch.diagonal(hessian, dim1=-2, dim2=-1)          # [E, K]
    perm = torch.argsort(-diag, dim=-1, stable=True)          # descending
    inv = torch.argsort(perm, dim=-1, stable=True)

    w_p = torch.gather(w, 2, perm[:, None, :].expand(e, n, k))
    h_p = torch.gather(hessian, 1, perm[:, :, None].expand(e, k, k))
    h_p = torch.gather(h_p, 2, perm[:, None, :].expand(e, k, k))

    def unperm(x):
        return torch.gather(x, 2, inv[:, None, :].expand(e, x.shape[1], k))

    gsize = k if cfg.w_gsize == -1 else cfg.w_gsize
    if static_groups and cfg.w_gsize != -1:
        # per-group quantizers from the original (dead-zeroed) weights,
        # looked up by each sweep column's original group
        dead = (diag == 0).float()
        wf0 = w.float() * (1.0 - dead[:, None, :])
        sc0, zp0 = _find_group_params(wf0.reshape(e, n, k // gsize, gsize),
                                      cfg.w_bits, cfg.w_sym, cfg.w_clip)
        res = gptq_quantize(w_p, h_p, cfg, blocksize, percdamp, act_order=False,
                            static_groups=True, _perm_groups=perm // gsize,
                            _static_params=(sc0, zp0))
        codes_u = unperm(res.codes)
        w_fq = (codes_u.reshape(e, n, k // gsize, gsize) * sc0[..., None]
                + zp0[..., None]).reshape(e, n, k)
        return GPTQResult(codes=codes_u, scale=sc0, zp=zp0, w_fq=w_fq)

    res = gptq_quantize(w_p, h_p, cfg, blocksize, percdamp, act_order=False)
    if cfg.w_gsize == -1:
        scale, zp = res.scale, res.zp
    else:
        # grouped scales follow the permuted order: per column, unpermuted
        scale = unperm(res.scale.repeat_interleave(gsize, dim=2))
        zp = unperm(res.zp.repeat_interleave(gsize, dim=2))
    return GPTQResult(codes=unperm(res.codes), scale=scale, zp=zp,
                      w_fq=unperm(res.w_fq))
