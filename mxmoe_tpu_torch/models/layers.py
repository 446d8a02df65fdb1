"""Transformer building blocks (port of ``mxmoe_tpu/models/layers.py``:
``rms_norm``, ``silu_mul``, ``MoEImpl``, ``moe_ffn_dense``,
``moe_ffn_ragged``, ``moe_ffn_ragged_quant``, ``shared_expert_ffn``,
``moe_block``; the full forward's attention: ``rope_frequencies`` /
``apply_rope`` (half-split), ``rope_frequencies_interleaved`` /
``apply_rope_interleaved`` (DeepSeek MLA), ``attention``,
``attention_block``, ``mla_attention_block``, ``dense_mlp_block``,
``make_rope_tables``, ``attention_dispatch``, ``decoder_layer``).

Layouts are the JAX package's: matmul weights [in, out] (a projection is
``x @ w``), expert weights [E, in, out] with gate/up fused as [E, H, 2N].
A layer's params are ``{name: stacked[layer]}`` views.

``moe_ffn_ragged`` is the float path (two grouped matmuls through
``ops.gmm``: the stock grouped product, or K11 with
``gmm_backend="pallas"``); ``moe_ffn_dense`` the O(E) oracle. Branches of
``moe_ffn_ragged_quant`` (act quant -> grouped GEMM -> SwiGLU -> act quant ->
grouped GEMM), by what the layer's params hold:

- per-channel symmetric w x a, K1 act quant: uniform int8-stored (K2),
  uniform or mixed nibble-packed ``_q_packed`` (K5), per-expert mixed
  int8-stored (K2 with per-row activation bits), mixed over the ragged packed
  buffer ``_qcat`` (K4);
- uniform per-channel asymmetric w x a (K1, K9); uniform grouped w x a,
  symmetric or asymmetric (``quantize_act_grouped``, K8 without / with
  ``rhs_zp``); a flex mixed family, int8-stored (``quantize_act_rows_flex``,
  K8 with the family's ``_zp`` when it has one), or over the ragged packed
  buffer ``_qcat`` (K4f);
- a mixed layer that holds weight-only (a16) experts, int8-stored, with
  ``MoEImpl.mixed_weight_only``: K10, per channel (K1 act quant) or flex;
- uniform weight-only a16, any group size, symmetric or asymmetric:
  int8-stored (K6) or nibble-packed (K7), no act quant.

The whole expert FFN in one launch (``MoEImpl.fused_ffn``, over the aligned
dispatch): gate_up -> SwiGLU in f32 -> per-row requant -> down, for the
per-channel symmetric w x a domain, int8-stored (K12 ``gmm_ffn_w8a8``) or
over the ragged packed buffer (K13 ``gmm_ffn_mixed_packed``); every other
layer falls through to the two-launch branches above, on the aligned layout.

The shared expert runs in float, fake-quantized (float weights beside
``act_bits_shared``: its inputs quantized per token, ``_act_fq_per_row``;
what the quantizers emit for a layer-heterogeneous or grouped shared
expert), or, real-quantized, through K2 with one group (per-channel
symmetric), K8 with one group (grouped / asymmetric) or K6 with one group
(all-a16).

Fake-quantized experts (``quant.quantizer.quantize_model_fake``: float
expert weights beside ``act_bits_gateup`` / ``act_bits_down`` and, for a
flex family, ``act_gsize_*``) take the float path with each expert's rows
fake-quantized before each grouped matmul (``_act_fq_per_row``,
``_act_fq_per_row_flex``: the same codes and scales as the real flex
path); the dense layer's ``act_bits_dense`` does the same for ds2's dense
MLP. ``MoEImpl.online_had`` rotates the down projection's input online
(``quant.hadamard.matmul_hadU``; the down weights pre-rotated by
``quant.rotation.rotate_down_weights``) on the float and the two-launch
quantized paths; the whole-FFN kernels refuse it and fall through.

``attention``'s backends: ``"xla"`` is the einsum softmax; ``"flash"`` is the
reference's library flash attention, here the stock
``scaled_dot_product_attention`` (causal) on a card and the einsum on the
CPU, as the reference takes its library kernel only on its accelerator;
``"ring"`` is sequence-parallel ring attention over a process group
(``parallel.ring_attention``: ``MoEImpl.ring_attn``, built by
``parallel.sharded.make_sp_prefill_forward``, else the default group).
``MoEImpl.ep_moe`` replaces the cached forward's MoE block by the
expert-parallel one (``parallel.ep.make_ep_moe_block``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .configs import MoEConfig
from ..ops import act_quant
from ..ops.dispatch import (Routing, combine_tokens, expert_of_rows, gather_tokens,
                            make_dispatch, route_topk)
from ..ops.gmm import gmm
from ..ops.gmm_ffn import gmm_ffn_mixed_packed, gmm_ffn_w8a8
from ..ops.gmm_mixed_packed import gmm_mixed_packed
from ..ops.gmm_mixed_wo_wxa import gmm_mixed_wo_wxa
from ..ops.gmm_w4a8_packed import gmm_w4a8_packed
from ..ops.gmm_w8a8 import gmm_w8a8
from ..ops.gmm_w8a8_asym import gmm_w8a8_asym
from ..ops.gmm_w8a8_grouped import gmm_w8a8_grouped
from ..ops.gmm_weight_only import gmm_weight_only
from ..ops.gmm_weight_only_packed import gmm_weight_only_packed
from ..quant.qparams import quantize_act_grouped, quantize_act_rows_flex


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
    """How the expert FFN runs (the fields of the JAX ``MoEImpl`` that the
    serving slices read, under its names and defaults).

    kind: ``"ragged"`` (sort tokens by expert, grouped matmuls) or
      ``"dense"`` (the O(E) oracle ``moe_ffn_dense``, float weights only).
    gmm_backend: the float path's grouped matmul, as ``ops.gmm.gmm`` takes
      it: ``"ragged_dot"`` (the stock grouped product) or ``"pallas"`` (the
      hand-written kernel, K11 on a card).
    quant: the uniform QLinearConfig of the routed expert linears (params
      from quantize_model_experts_uniform), or ``"mixed"`` for per-expert
      schemes (params from quantize_model_experts_mixed, whose
      ``act_bits_*`` arrays carry the activation widths). ``None`` with
      float expert weights runs the float path.
    mixed_weight_only: the mixed layers hold weight-only (a16) experts: their
      GEMMs go through the one launch of both kinds, ``gmm_mixed_wo_wxa``,
      which keeps the a16 rows in float. The caller sets it, as in the
      reference; a mixed layer with a16 experts served without it quantizes
      those rows to 8 bits.
    dispatch_align: pad each expert's rows to this multiple (tiles never
      straddle experts; ``make_dispatch``). ``None``: unaligned.
    fused_ffn: the whole expert FFN in one launch (``gmm_ffn_w8a8`` /
      ``gmm_ffn_mixed_packed``). ``True`` forces it; ``"auto"`` fuses only
      in the decode regime (at most 2048 routed rows), as the reference
      decides; either implies a 32-row aligned dispatch when
      ``dispatch_align`` is unset. Per-channel symmetric w x a only: other
      schemes fall through to the two-launch branches.
    online_had: rotate the down projection's input by the normalized
      Hadamard transform (QuaRot's online R4; the down weights must be
      pre-rotated, ``quant.rotation.rotate_down_weights``).
    attn_backend: the full forward's attention, as ``attention`` takes it:
      ``"xla"`` (einsum softmax) or ``"flash"`` (the stock flash attention on
      a card).
    decode_attn: the cached forward's single-step attention: ``"fused"``
      (K3 / K3q: the cache write and the attention in one kernel), ``"xla"``
      (the plain way the prefill takes: ``scatter_layer_cache*`` +
      ``attention_with*_cache``) or ``"auto"``: fused, which on a CPU tensor
      is K3's plain version (the reference's rule: fused on its accelerator
      or in interpret mode; its TPU-fitted crossover table is not read).
      So ``"auto"`` and ``"fused"`` take the same path: on an H100 ``"xla"``
      won at no measured point (``bench/decode_attn_crossover.py``), and
      the two are folded together or ``"auto"`` learns a crossover once
      one is measured.
    ep_moe: the cached forward's routed MoE block under expert parallelism
      (``parallel.ep.make_ep_moe_block``, set by the mesh ``Engine``):
      ``block(x, lp, cfg) -> y`` in place of ``moe_block``.
    ring_attn: the callable ``attention(backend="ring")`` runs
      (``parallel.ring_attention.make_ring_attention_fn``).
    The JAX serving default holds for act quant: the single-pass kernel
    (``pallas_quant=True``, here K1).
    """

    kind: str = "ragged"
    gmm_backend: str = "ragged_dot"
    quant: object | None = None
    mixed_weight_only: bool = False
    dispatch_align: int | None = None
    fused_ffn: object = False
    online_had: bool = False
    attn_backend: str = "xla"
    decode_attn: str = "auto"
    ep_moe: object = None
    ring_attn: object = None

    def use_fused_decode(self) -> bool:
        """Whether a decode step takes the fused cache-write + attention."""
        if self.decode_attn not in ("auto", "fused", "xla"):
            raise ValueError(f"MoEImpl.decode_attn={self.decode_attn!r}: "
                             "'auto' | 'fused' | 'xla'")
        return self.decode_attn != "xla"


_STORAGE_KEYS = ("expert_gate_up_q", "expert_gate_up_q_packed",
                 "expert_gate_up_qcat")


def moe_ffn_dense(x2d: torch.Tensor, lp: dict, cfg: MoEConfig) -> torch.Tensor:
    """Reference-fidelity O(E) dense MoE execution (test oracle)."""
    logits = x2d @ lp["router"]
    routing = route_topk(logits, cfg.top_k, cfg.norm_topk_prob,
                         cfg.routed_scaling_factor)
    h = silu_mul(torch.einsum("th,ehn->etn", x2d, lp["expert_gate_up"]))
    out_all = torch.einsum("etn,enh->eth", h, lp["expert_down"])    # [E, T, H]
    one_hot = F.one_hot(routing.expert_ids.long(), cfg.num_experts).to(x2d.dtype)
    w = (routing.weights.to(x2d.dtype)[..., None] * one_hot).sum(1)  # [T, E]
    return torch.einsum("eth,te->th", out_all, w)


def _online_had(h: torch.Tensor, impl: MoEImpl) -> torch.Tensor:
    if not impl.online_had:
        return h
    from ..quant.hadamard import matmul_hadU

    return matmul_hadU(h)


def _expert_block_routing(routing: Routing, first: int, count: int) -> Routing:
    """The assignments to experts [first, first + count) renumbered from 0;
    every other one sent to the dead group ``count`` with weight 0. On the
    device: no host read."""
    ids = routing.expert_ids - first
    mine = (ids >= 0) & (ids < count)
    return Routing(torch.where(mine, routing.weights, torch.zeros_like(routing.weights)),
                   torch.where(mine, ids, torch.full_like(ids, count)))


def moe_ffn_ragged(x2d: torch.Tensor, lp: dict, cfg: MoEConfig,
                   impl: MoEImpl, experts: tuple[int, int] | None = None) -> torch.Tensor:
    """The float path: sort tokens by expert, two grouped matmuls, combine.
    With ``act_bits_gateup`` / ``act_bits_down`` [E] in the layer (fake-
    quantized experts) each expert's rows are fake-quantized to its
    activation width before each product (per token, or per k-group where
    the family carries ``act_gsize_*``).

    ``experts`` = (first, count): the layer's expert stack holds only experts
    [first, first + count) (a rank's block under tensor parallelism). All
    tokens are routed over every expert; the assignments to other experts
    sort into a trailing dead group that the grouped products leave out
    (their rows lie past the groups' sum) and the combine masks (weight 0),
    so the output is this block's share of the layer's sum."""
    if "expert_gate_up" not in lp:
        raise ValueError("moe_ffn_ragged: the layer carries no float expert weights "
                         "(expert_gate_up); quantized experts need MoEImpl.quant")
    logits = x2d @ lp["router"]
    routing = route_topk(logits, cfg.top_k, cfg.norm_topk_prob,
                         cfg.routed_scaling_factor)
    groups = cfg.num_experts
    if experts is not None:
        routing, groups = _expert_block_routing(routing, *experts), experts[1]
    disp = make_dispatch(routing, groups + (experts is not None),
                         align=impl.dispatch_align)
    if experts is not None:
        disp = disp._replace(group_sizes=disp.group_sizes[:groups])
    xs = gather_tokens(x2d, disp)                                   # [rows, H]
    mixed_act = "act_bits_gateup" in lp
    if mixed_act:
        row_expert = expert_of_rows(disp.group_sizes, xs.shape[0])

    def fq(acts, bits_key, ag_key):
        row_bits = lp[bits_key][row_expert]
        ag = lp.get(ag_key)                 # [E, G]: each expert's a_gsize
        if ag is None:
            return _act_fq_per_row(acts, row_bits)
        return _act_fq_per_row_flex(acts, row_bits, ag[:, 0][row_expert],
                                    acts.shape[-1] // ag.shape[-1])

    if mixed_act:
        xs = fq(xs, "act_bits_gateup", "act_gsize_gateup")
    h = silu_mul(gmm(xs, lp["expert_gate_up"], disp.group_sizes,
                     backend=impl.gmm_backend))                     # [rows, N]
    h = _online_had(h, impl)
    if mixed_act:
        h = fq(h, "act_bits_down", "act_gsize_down")
    out = gmm(h, lp["expert_down"], disp.group_sizes,
              backend=impl.gmm_backend)                             # [rows, H]
    return combine_tokens(out, disp, x2d.shape[0])


def _check_quant_domain(lp: dict, qcfg) -> bool:
    """Admit exactly the served domains; returns whether the layer is mixed
    (per-expert activation bits)."""
    if not any(k in lp for k in _STORAGE_KEYS):
        raise ValueError("moe_ffn_ragged_quant: the layer carries no quantized "
                         f"expert weights (one of {_STORAGE_KEYS})")
    if "act_bits_gateup" in lp:
        for prefix, ag_key in (("expert_gate_up", "act_gsize_gateup"),
                               ("expert_down", "act_gsize_down")):
            if ag_key not in lp and lp[f"{prefix}_sc"].shape[-2] != 1:
                raise ValueError(f"{prefix}_sc holds grouped scales but the "
                                 f"layer carries no {ag_key} marker")
        return True
    if "expert_gate_up_qcat" in lp:
        raise ValueError("a ragged packed buffer (expert_*_qcat) needs the "
                         "per-expert act_bits_gateup / act_bits_down arrays")
    if isinstance(qcfg, str):
        raise ValueError(f"MoEImpl.quant={qcfg!r} needs mixed params "
                         "(quantize_model_experts_mixed)")
    if qcfg.a_bits < 16:
        # activations are quantized symmetrically. As in the reference, the
        # grouped quantizer never reads a_sym (a parsed "_asym" name means
        # asymmetric weights there) while the per-token one refuses it
        if not qcfg.a_sym and qcfg.w_gsize == -1:
            raise NotImplementedError(
                "asymmetric per-token activations are not wired (the reference "
                "refuses them too); use a_sym=True with asymmetric weights")
        if "expert_gate_up_q_packed" in lp and not (qcfg.w_sym
                                                    and qcfg.w_gsize == -1):
            raise ValueError("packed w x a storage needs symmetric per-channel "
                             f"weights, got {qcfg.scheme_name}")
    return False


def moe_ffn_ragged_quant(x2d: torch.Tensor, lp: dict, cfg: MoEConfig,
                         impl: MoEImpl) -> torch.Tensor:
    """Real-quantized expert FFN: act quant + quantized grouped GEMMs.
    Per-expert bitwidths, group sizes and zero points are data (the weight
    scales and zp, the per-row clip range and group flag of the activations),
    so a mixed layer is one launch per GEMM."""
    qcfg = impl.quant
    mixed = _check_quant_domain(lp, qcfg)

    logits = x2d @ lp["router"]
    routing = route_topk(logits, cfg.top_k, cfg.norm_topk_prob,
                         cfg.routed_scaling_factor)
    # fused_ffn "auto" fuses in the decode regime only (few routed rows), as
    # the reference decides
    rows_est = x2d.shape[0] * cfg.top_k
    fuse_req = (impl.fused_ffn is True
                or (impl.fused_ffn == "auto" and rows_est <= 2048))
    align = impl.dispatch_align or (32 if fuse_req else None)
    disp = make_dispatch(routing, cfg.num_experts, align=align)
    xs = gather_tokens(x2d, disp)                                   # [rows, H]
    gs = disp.group_sizes
    if mixed:
        row_expert = expert_of_rows(gs, xs.shape[0])

    # the fused kernels take per-channel symmetric w x a only: a flex family
    # (either act_gsize key) or a16 experts go the two-launch way
    fused_ok = (fuse_req and align and not impl.mixed_weight_only
                and not impl.online_had
                and "act_gsize_gateup" not in lp and "act_gsize_down" not in lp
                and (mixed or (qcfg.a_bits <= 8 and qcfg.w_sym
                               and qcfg.w_gsize == -1)))
    if fused_ok and ("expert_gate_up_q" in lp
                     or (mixed and "expert_gate_up_qcat" in lp)):
        if mixed:
            aq, asc = act_quant.quantize_rows(xs, lp["act_bits_gateup"][row_expert])
            abits = lp["act_bits_down"].clamp(max=8).to(torch.int32)
        else:
            aq, asc = act_quant.quantize_rows_uniform(xs, int(qcfg.a_bits))
            abits = torch.full((cfg.num_experts,), min(int(qcfg.a_bits), 8),
                               dtype=torch.int32, device=xs.device)
        if "expert_gate_up_q" in lp:
            out = gmm_ffn_w8a8(aq, asc, lp["expert_gate_up_q"],
                               lp["expert_gate_up_sc"], lp["expert_down_q"],
                               lp["expert_down_sc"], gs, act_bits_down=abits,
                               out_dtype=x2d.dtype)
        else:
            out = gmm_ffn_mixed_packed(
                aq, asc, lp["expert_gate_up_qcat"], lp["expert_gate_up_sc"],
                lp["expert_gate_up_pf"], lp["expert_gate_up_blk"],
                lp["expert_down_qcat"], lp["expert_down_sc"],
                lp["expert_down_pf"], lp["expert_down_blk"], gs,
                act_bits_down=abits, out_dtype=x2d.dtype)
        return combine_tokens(out, disp, x2d.shape[0])

    def qgemm_mixed(acts, prefix, bits_key, ag_key):
        sc, dt = lp[f"{prefix}_sc"], acts.dtype
        row_bits = lp[bits_key][row_expert]
        if impl.mixed_weight_only:
            # 1 = a weight-only (a16) expert: its rows stay float in K10
            flags16 = (lp[bits_key] >= 16).to(torch.int32)
        if ag_key in lp:
            # flex family: bits, group size and symmetry are per-expert data
            gsize = acts.shape[-1] // sc.shape[-2]
            zp = lp.get(f"{prefix}_zp")
            aq, asc = quantize_act_rows_flex(acts, row_bits,
                                             lp[ag_key][:, 0][row_expert], gsize)
            if f"{prefix}_qcat" in lp:
                return gmm_mixed_packed(aq, asc, lp[f"{prefix}_qcat"], sc, gs,
                                        lp[f"{prefix}_pf"], lp[f"{prefix}_blk"],
                                        rhs_zp=zp, out_dtype=dt)
            if impl.mixed_weight_only:
                return gmm_mixed_wo_wxa(acts, aq, asc, lp[f"{prefix}_q"], sc,
                                        flags16, gs, rhs_zp=zp, out_dtype=dt)
            return gmm_w8a8_grouped(aq, asc, lp[f"{prefix}_q"], sc, gs,
                                    gsize=gsize, rhs_zp=zp, out_dtype=dt)
        aq, asc = act_quant.quantize_rows(acts, row_bits)
        if f"{prefix}_qcat" in lp:
            return gmm_mixed_packed(aq, asc, lp[f"{prefix}_qcat"], sc, gs,
                                    lp[f"{prefix}_pf"], lp[f"{prefix}_blk"],
                                    out_dtype=dt)
        if f"{prefix}_q_packed" in lp:
            return gmm_w4a8_packed(aq, asc, lp[f"{prefix}_q_packed"], sc, gs,
                                   out_dtype=dt)
        if impl.mixed_weight_only:
            return gmm_mixed_wo_wxa(acts, aq, asc, lp[f"{prefix}_q"], sc, flags16,
                                    gs, out_dtype=dt)
        return gmm_w8a8(aq, asc, lp[f"{prefix}_q"], sc, gs, out_dtype=dt)

    def qgemm_uniform(acts, prefix):
        sc, zp, dt = lp[f"{prefix}_sc"], lp.get(f"{prefix}_zp"), acts.dtype
        if qcfg.a_bits >= 16:
            # weight-only: float activations against codes dequantized in
            # the kernel
            if zp is None:
                zp = torch.zeros_like(sc)
            if f"{prefix}_q_packed" in lp:
                return gmm_weight_only_packed(acts, lp[f"{prefix}_q_packed"], sc,
                                              zp, gs, gsize=qcfg.w_gsize,
                                              out_dtype=dt)
            return gmm_weight_only(acts, lp[f"{prefix}_q"], sc, zp, gs,
                                   gsize=qcfg.w_gsize, out_dtype=dt)
        if qcfg.w_gsize != -1:
            # g128-class w x a: per-(token, k-group) act scales; asymmetric
            # weights add their zero-point term inside the same launch
            aq, asc = quantize_act_grouped(acts, int(qcfg.a_bits), qcfg.w_gsize)
            return gmm_w8a8_grouped(aq, asc, lp[f"{prefix}_q"], sc, gs,
                                    gsize=qcfg.w_gsize,
                                    rhs_zp=None if qcfg.w_sym else zp,
                                    out_dtype=dt)
        aq, asc = act_quant.quantize_rows_uniform(acts, int(qcfg.a_bits))
        if f"{prefix}_q_packed" in lp:
            return gmm_w4a8_packed(aq, asc, lp[f"{prefix}_q_packed"], sc, gs,
                                   out_dtype=dt)
        if not qcfg.w_sym:
            return gmm_w8a8_asym(aq, asc, lp[f"{prefix}_q"], sc, zp, gs,
                                 out_dtype=dt)
        return gmm_w8a8(aq, asc, lp[f"{prefix}_q"], sc, gs, out_dtype=dt)

    if mixed:
        h = silu_mul(qgemm_mixed(xs, "expert_gate_up", "act_bits_gateup",
                                 "act_gsize_gateup"))               # [rows, N]
        out = qgemm_mixed(_online_had(h, impl), "expert_down", "act_bits_down",
                          "act_gsize_down")
    else:
        h = silu_mul(qgemm_uniform(xs, "expert_gate_up"))
        out = qgemm_uniform(_online_had(h, impl), "expert_down")    # [rows, H]
    return combine_tokens(out, disp, x2d.shape[0])


def _act_fq_per_row(x: torch.Tensor, bits_per_row: torch.Tensor) -> torch.Tensor:
    """Per-token symmetric fake-quant with a per-row bitwidth (16 and more
    pass the row through), in ``x``'s dtype: the reference's act-quant hook
    for fake-quantized weights."""
    upper = torch.exp2(bits_per_row.float() - 1.0) - 1.0                # [M]
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(-1), min=1e-10) / upper
    q = torch.round(xf / scale[:, None]) * scale[:, None]
    return torch.where((bits_per_row >= 16)[:, None], xf, q).to(x.dtype)


def _act_fq_per_row_flex(x: torch.Tensor, bits_per_row: torch.Tensor,
                         row_gsize: torch.Tensor, gsize: int) -> torch.Tensor:
    """Flex fake-quant: a per-row bitwidth and grouping (rows of a grouped
    expert per k-group of ``gsize``, the others per token), dequantizing the
    very codes and scales of the real flex path
    (``quant.qparams.quantize_act_rows_flex``); rows of 16 bits and more
    pass through."""
    q, scale = quantize_act_rows_flex(x, bits_per_row, row_gsize, gsize)
    m, k = x.shape
    deq = (q.float().reshape(m, k // gsize, gsize) * scale[..., None]).reshape(m, k)
    return torch.where((bits_per_row >= 16)[:, None], x.float(), deq).to(x.dtype)


def _shared_expert_quant(x2d: torch.Tensor, lp: dict) -> torch.Tensor:
    """Real-quantized shared expert, each dense product a grouped GEMM with
    one group. Per-channel symmetric w x a: per-token act quant (K1) and K2
    (the int32 sum is exact, so this equals the reference's K-split int8
    dots). Grouped / asymmetric w x a: per-token act quant with the scale
    replicated over the k-groups, and K8. All-a16 (``shared_wo``): K6."""
    t = x2d.shape[0]
    dt = x2d.dtype
    one_group = torch.full((1,), t, dtype=torch.int32, device=x2d.device)

    def qdot_wo(acts, name):
        sc = lp[f"{name}_sc"]
        zp = lp.get(f"{name}_zp")
        if zp is None:
            zp = torch.zeros_like(sc)
        return gmm_weight_only(acts, lp[f"{name}_q"][None], sc[None], zp[None],
                               one_group, gsize=acts.shape[-1] // sc.shape[-2],
                               out_dtype=dt)

    if "shared_wo" in lp:
        return qdot_wo(silu_mul(qdot_wo(x2d, "shared_gate_up")), "shared_down")

    bits = lp["act_bits_shared"]                                    # [2]
    grouped = (lp["shared_gate_up_sc"].shape[-2] > 1
               or "shared_gate_up_zp" in lp or "shared_down_zp" in lp)
    per_token = torch.full((t,), -1.0, device=x2d.device)

    def qdot(acts, name, b):
        sc, zp = lp[f"{name}_sc"], lp.get(f"{name}_zp")
        if not grouped:
            aq, asc = act_quant.quantize_rows(acts, b.expand(t))
            return gmm_w8a8(aq, asc, lp[f"{name}_q"][None], sc[None], one_group,
                            out_dtype=dt)
        # act quant stays per token (the scale replicated over the groups)
        gsize = acts.shape[-1] // sc.shape[-2]
        aq, asc = quantize_act_rows_flex(acts, b.expand(t), per_token, gsize)
        return gmm_w8a8_grouped(aq, asc, lp[f"{name}_q"][None], sc[None],
                                one_group, gsize=gsize,
                                rhs_zp=None if zp is None else zp[None],
                                out_dtype=dt)

    return qdot(silu_mul(qdot(x2d, "shared_gate_up", bits[0])),
                "shared_down", bits[1])


def shared_expert_ffn(x2d: torch.Tensor, lp: dict, cfg: MoEConfig) -> torch.Tensor:
    """Shared expert (float, or real-quantized when the params carry its
    codes), with the qwen2_moe sigmoid gate."""
    if "shared_gate_up_q" in lp:
        out = _shared_expert_quant(x2d, lp)
    elif "act_bits_shared" in lp:
        # fake-quantized weights: the inputs of both products quantized per
        # token to the layer's act bits (16 passes them through)
        bits = lp["act_bits_shared"]                                # [2]
        t = x2d.shape[0]
        h = silu_mul(_act_fq_per_row(x2d, bits[0].expand(t)) @ lp["shared_gate_up"])
        out = _act_fq_per_row(h, bits[1].expand(t)) @ lp["shared_down"]
    else:
        out = silu_mul(x2d @ lp["shared_gate_up"]) @ lp["shared_down"]
    return shared_expert_gate(out, x2d, lp, cfg)


def shared_expert_gate(out: torch.Tensor, x2d: torch.Tensor, lp: dict,
                       cfg: MoEConfig) -> torch.Tensor:
    """The shared expert's output times qwen2_moe's sigmoid gate (``out``
    itself for a family without the gate)."""
    if not cfg.has_shared_expert_gate:
        return out
    gate = torch.sigmoid(x2d @ lp["shared_gate"])                   # [T, 1]
    return out * gate.to(out.dtype)


def moe_block(x: torch.Tensor, lp: dict, cfg: MoEConfig,
              impl: MoEImpl = MoEImpl()) -> torch.Tensor:
    b, s, h = x.shape
    x2d = x.reshape(-1, h)
    if impl.kind == "dense":
        y = moe_ffn_dense(x2d, lp, cfg)
    elif impl.quant is not None and any(k in lp for k in _STORAGE_KEYS):
        y = moe_ffn_ragged_quant(x2d, lp, cfg, impl)
    else:
        y = moe_ffn_ragged(x2d, lp, cfg, impl)
    if cfg.shared_expert_intermediate_size > 0:
        y = y + shared_expert_ffn(x2d, lp, cfg)
    return y.reshape(b, s, h)


# ---------------------------------------------------------------------------
# the full forward's attention and the dense layer
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, positions: torch.Tensor):
    """cos/sin tables [..., head_dim] (f32) in the HF half-rotation
    convention, for positions [S] (the full forward) or [B, S] (per-slot
    positions of the cached forward)."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=positions.device) / head_dim))
    angles = positions.float()[..., None] * inv_freq               # [.., hd/2]
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [B, S, nH, hd]; cos/sin [S, hd] or [B, S, hd] (HF rotate_half
    convention)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return x * c + rotated * s


def rope_frequencies_interleaved(rope_dim: int, theta: float,
                                 positions: torch.Tensor):
    """cos/sin [..., rope_dim/2] (f32) for the interleaved (complex)
    convention of DeepSeek-V2 MLA, for positions [S] or [B, S]."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, rope_dim, 2, dtype=torch.float32,
                                             device=positions.device) / rope_dim))
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [B, S, nH, d] rotated pairwise: (x[2i], x[2i+1]) as a complex number,
    in f32; cos/sin [S, d/2] or [B, S, d/2]."""
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    c, s = cos[..., None, :], sin[..., None, :]
    out = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def _causal_mask(s: int, t: int, device) -> torch.Tensor:
    """[S, T]: query i attends keys [0, i + T - S] (the reference's
    ``tril(ones(s, t), k=t - s)``)."""
    return torch.ones((s, t), dtype=torch.bool, device=device).tril(t - s)


def attention(q: torch.Tensor,    # [B, S, nH, hd]
              k: torch.Tensor,    # [B, T, nKV, hd]
              v: torch.Tensor,    # [B, T, nKV, hd]
              causal: bool = True, backend: str = "xla",
              ring_fn=None) -> torch.Tensor:
    """GQA attention; keys / values broadcast over the query groups ->
    [B, S, nH, hd]. ``backend`` as the module docstring says; ``"ring"``
    runs ``ring_fn(q, k, v)`` over this rank's sequence block, or, without
    one, ring attention over the default process group (raising where none
    is initialized)."""
    b, s, n_h, hd = q.shape
    n_kv = k.shape[2]
    groups = n_h // n_kv
    if backend == "ring":
        if not causal:
            raise ValueError("ring attention is causal-only")
        if ring_fn is None:
            from ..parallel.ring_attention import ring_attention as ring_fn
        return ring_fn(q, k, v)
    if backend not in ("xla", "flash"):
        raise ValueError(f"attention backend {backend!r}: 'xla' | 'flash' | 'ring'")
    if backend == "flash" and causal and q.is_cuda:
        out = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, scale=1.0 / math.sqrt(hd), enable_gqa=groups > 1)
        return out.transpose(1, 2)
    qg = q.reshape(b, s, n_kv, groups, hd)
    scores = torch.einsum("bsngh,btnh->bngst", qg, k).float()
    scores = scores / math.sqrt(hd)
    if causal:
        mask = _causal_mask(s, k.shape[1], q.device)
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bngst,btnh->bsngh", probs, v)
    return out.reshape(b, s, n_h, hd)


def attention_block(x: torch.Tensor, lp: dict, cfg: MoEConfig, cos, sin,
                    attn_backend: str = "xla", ring_fn=None) -> torch.Tensor:
    """GQA self-attention of one layer over a whole sequence [B, S, H]."""
    b, s, _ = x.shape
    q = x @ lp["wq"]
    k = x @ lp["wk"]
    v = x @ lp["wv"]
    if cfg.attention_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = apply_rope(q.reshape(b, s, cfg.num_heads, cfg.head_dim), cos, sin)
    k = apply_rope(k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim), cos, sin)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    out = attention(q, k, v, causal=True, backend=attn_backend, ring_fn=ring_fn)
    return out.reshape(b, s, -1) @ lp["wo"]


def mla_qkv(x: torch.Tensor, lp: dict, cfg: MoEConfig, rope):
    """Multi-head latent attention's q, k [B, S, nH, qk_head_dim] and v
    [B, S, nH, v_head_dim] (DeepSeek-V2, q_lora_rank None): q = x W_q split
    (nope, rope); the compressed kv = x W_kva split (c_kv -> RMSNorm -> W_kvb
    -> (k_nope, v), and k_rope, shared by the heads); ``rope(t)`` rotates the
    rope parts ([B, S, n, d_rope])."""
    b, s, _ = x.shape
    n_h = cfg.num_heads
    d_nope, d_rope, d_v = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q = (x @ lp["wq"]).reshape(b, s, n_h, d_nope + d_rope)
    ckv = x @ lp["kv_a"]
    c_kv = rms_norm(ckv[..., :cfg.kv_lora_rank], lp["kv_a_norm"], cfg.rms_norm_eps)
    kv = (c_kv @ lp["kv_b"]).reshape(b, s, n_h, d_nope + d_v)
    q_pe = rope(q[..., d_nope:])
    k_pe = rope(ckv[..., cfg.kv_lora_rank:][:, :, None, :]).expand(b, s, n_h, d_rope)
    q_full = torch.cat([q[..., :d_nope], q_pe], dim=-1)
    k_full = torch.cat([kv[..., :d_nope], k_pe], dim=-1)
    return q_full, k_full, kv[..., d_nope:]


def mla_attention_block(x: torch.Tensor, lp: dict, cfg: MoEConfig, cos,
                        sin) -> torch.Tensor:
    """Multi-head latent attention over a whole sequence (the HF
    DeepseekV2Attention semantics): interleaved RoPE on the rope parts,
    scale qk_head_dim^-1/2, causal."""
    b, s, _ = x.shape
    q, k, v = mla_qkv(x, lp, cfg, lambda t: apply_rope_interleaved(t, cos, sin))
    scores = torch.einsum("bsnd,btnd->bnst", q, k).float()
    scores = scores / math.sqrt(cfg.qk_head_dim)
    scores = scores.masked_fill(~_causal_mask(s, s, x.device), float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bnst,btnd->bsnd", probs, v)
    return out.reshape(b, s, cfg.num_heads * cfg.v_head_dim) @ lp["wo"]


def dense_mlp_block(x: torch.Tensor, lp: dict, cfg: MoEConfig) -> torch.Tensor:
    """Plain SwiGLU MLP of ds2's first dense layer(s). With
    ``act_bits_dense`` [2] (the dense pseudo-expert's scheme, qconfig key
    ``dense-<i>``) the inputs of gate_up and down are fake-quantized per
    token to those widths."""
    if "act_bits_dense" not in lp:
        return silu_mul(x @ lp["mlp_gate_up"]) @ lp["mlp_down"]
    b, s, h = x.shape
    x2d = x.reshape(-1, h)
    bits = lp["act_bits_dense"]
    t = x2d.shape[0]
    hmid = silu_mul(_act_fq_per_row(x2d, bits[0].expand(t)) @ lp["mlp_gate_up"])
    y = _act_fq_per_row(hmid, bits[1].expand(t)) @ lp["mlp_down"]
    return y.reshape(b, s, h)


def make_rope_tables(cfg: MoEConfig, positions: torch.Tensor):
    """cos/sin tables of the model family's rope convention."""
    if cfg.attention_type == "mla":
        return rope_frequencies_interleaved(cfg.qk_rope_head_dim, cfg.rope_theta,
                                            positions)
    return rope_frequencies(cfg.head_dim, cfg.rope_theta, positions)


def attention_dispatch(x, lp, cfg: MoEConfig, cos, sin, attn_backend: str = "xla",
                       ring_fn=None):
    """GQA or MLA attention, as the config says."""
    if cfg.attention_type == "mla":
        return mla_attention_block(x, lp, cfg, cos, sin)
    return attention_block(x, lp, cfg, cos, sin, attn_backend=attn_backend,
                           ring_fn=ring_fn)


def decoder_layer(x: torch.Tensor, lp: dict, cfg: MoEConfig, cos, sin,
                  impl: MoEImpl = MoEImpl(), dense_mlp: bool = False) -> torch.Tensor:
    """One pre-norm decoder layer: attention, then the MoE block (or, for
    a dense first layer, the SwiGLU MLP)."""
    h = x + attention_dispatch(rms_norm(x, lp["input_norm"], cfg.rms_norm_eps),
                               lp, cfg, cos, sin, impl.attn_backend, impl.ring_attn)
    norm_h = rms_norm(h, lp["post_attn_norm"], cfg.rms_norm_eps)
    if dense_mlp:
        return h + dense_mlp_block(norm_h, lp, cfg)
    return h + moe_block(norm_h, lp, cfg, impl)
