"""Expert-parallel MoE FFN: capacity-bucketed all-to-all on
``torch.distributed`` (port of ``mxmoe_tpu/parallel/ep.py``).

The JAX package runs the block inside ``shard_map`` with
``jax.lax.all_to_all``; here every rank is a process that calls the block on
its own row block of the tokens and its own slice of the experts, and the
exchange is ``dist.all_to_all_single`` on the expert axis's process group.
Per rank: T_l local tokens, E_l = ceil(E / ep) local experts.

  1. route locally (router weights replicated),
  2. bucket each (token, k) assignment into a per-destination-rank capacity
     slot: send buffer [ep, C, H] plus the local-expert id; assignments past
     C drop (``capacity_factor`` sets C; :func:`capacity_factor_from_freq`
     derives it from a gate trace),
  3. exchange the fixed-size buffers (capacity is static: no size exchange,
     no host sync),
  4. the receiver sorts its ep*C rows by local expert (stable) and runs the
     same grouped GEMM kernels as one-device serving; unused capacity slots
     carry the sentinel expert E_l, so they sort to the tail and sit in no
     group,
  5. exchange back; the source applies the combine weights and sums each
     token's rows in float32.

Every rank issues the same collectives in the same order, a rank with no
live rows included: it sends its empty buckets. The rows a rank hands a
``moe_ffn_ep*`` function must be the JAX ``P(axis)`` row block of the
tokens; :class:`EPMoEBlock` moves a caller's rows there and back where they
are laid out otherwise (one slot's prefill on the rank that owns it).

Transports (``EPConfig.transport``), chosen by the caller and never switched:
``"direct"`` hands the tensors to the group's backend where they are (NCCL
with CUDA tensors, gloo with CPU tensors); ``"host"`` stages every exchange
through host buffers over a gloo group, for ranks whose tensors live on a
card that NCCL will not share (two ranks on one GPU). The kernels run where
the tensors are in both. With ``return_stats`` every block also reports its
dropped assignments.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.configs import MoEConfig
from ..models.layers import shared_expert_ffn, silu_mul
from ..ops import act_quant
from ..ops.dispatch import route_topk
from ..ops.gmm import gmm
from ..ops.gmm_mixed_packed import gmm_mixed_packed
from ..ops.gmm_mixed_wo_wxa import gmm_mixed_wo_wxa
from ..ops.gmm_w8a8 import gmm_w8a8
from ..ops.gmm_w8a8_grouped import gmm_w8a8_grouped
from ..quant.qparams import quantize_act_rows_flex
from .mesh import axis_index, axis_size

TRANSPORTS = ("direct", "host")


def _cdiv(a, b):
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class EPConfig:
    axis: object = "expert"       # a mesh dim name, or a tuple (flattened)
    capacity_factor: float = 2.0
    gmm_backend: str = "ragged_dot"
    # report (y, dropped_assignments [1]) instead of y alone
    return_stats: bool = False
    # the mix holds a16 weight-only experts: ship bf16 rows over the
    # all-to-all and run the wo + w x a launch per rank (moe_ffn_ep_wo)
    wo_mix: bool = False
    transport: str = "direct"     # "direct" | "host" (module docstring)


def capacity_factor_from_freq(freq, ep: int, margin: float = 1.25) -> float:
    """The capacity factor from traced per-expert access frequencies (any
    scale): the expected share of assignments on the hottest destination
    rank (experts shard contiguously, ceil(E/ep) a rank) times ``ep``, times
    ``margin`` for the variance of a batch."""
    f = np.asarray(freq, np.float64)
    f = f / max(f.sum(), 1e-12)
    e_local = _cdiv(len(f), ep)
    shard_load = np.add.reduceat(f, np.arange(0, len(f), e_local))
    return float(ep * shard_load.max() * margin)


def padded_num_experts(e: int, n_shards: int) -> int:
    """E rounded up so each shard holds ``ceil(E/n)`` experts."""
    return _cdiv(e, n_shards) * n_shards


def pad_expert_arrays(lp: dict, num_experts: int, n_shards: int,
                      axis: int = 1) -> dict:
    """Pad expert-stacked arrays with never-routed PHANTOM experts, so a
    non-divisible E (qwen2_moe's 60 on a power-of-two mesh) shards evenly:
    every ``expert_*`` tensor whose ``axis`` dim equals E grows zeros at the
    tail (``_pf`` grows ones: one packed K/2-unit each, the convention of
    ``quant.packing.shard_ragged_mixed``). Routing never yields an id >= E,
    so phantom groups stay empty. ``_qcat`` is left to
    ``shard_ragged_mixed``; ``act_bits_*`` / ``act_gsize_*`` stay [E]."""
    e_pad = padded_num_experts(num_experts, n_shards)
    if e_pad == num_experts:
        return lp
    out = dict(lp)
    for key, t in lp.items():
        if (not key.startswith("expert_") or key.endswith("_qcat")
                or not isinstance(t, torch.Tensor) or t.dim() <= axis
                or t.shape[axis] != num_experts):
            continue
        pad = [0, 0] * (t.dim() - axis - 1) + [0, e_pad - num_experts]
        out[key] = F.pad(t, pad, value=1 if key.endswith("_pf") else 0)
    return out


class EPComm:
    """The expert axis's process group, this rank's index on it and the
    transport. Every method is a collective: each rank of the group calls it
    in the same order."""

    def __init__(self, group, size: int, index: int, transport: str):
        if transport not in TRANSPORTS:
            raise ValueError(f"EP transport {transport!r}: one of {TRANSPORTS}")
        self.group, self.size, self.index, self.transport = group, size, index, transport

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.transport == "host" else t

    def all_to_all(self, t: torch.Tensor, out_splits=None,
                   in_splits=None) -> torch.Tensor:
        """``all_to_all_single`` over dim 0: equal blocks of ``t`` [ep, ...]
        by default, else the rows ``in_splits`` to each rank, receiving
        ``out_splits`` rows from each."""
        src = self._stage(t.contiguous())
        rows = t.shape[0] if out_splits is None else sum(out_splits)
        out = torch.empty((rows, *t.shape[1:]), dtype=t.dtype, device=src.device)
        dist.all_to_all_single(out, src, out_splits, in_splits, group=self.group)
        return out.to(t.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Equal blocks of every rank concatenated over dim 0."""
        src = self._stage(t.contiguous())
        out = torch.empty((self.size * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                          device=src.device)
        dist.all_gather_into_tensor(out, src, group=self.group)
        return out.to(t.device)

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """``t`` of the group's rank ``src`` on every rank."""
        buf = self._stage(t.contiguous()).clone()
        dist.broadcast(buf, dist.get_global_rank(self.group, src), group=self.group)
        return buf.to(t.device)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        buf = self._stage(t.contiguous()).clone()
        dist.all_reduce(buf, group=self.group)
        return buf.to(t.device)


def _axis_group(mesh, axis):
    if isinstance(axis, str):
        return mesh.get_group(axis)
    names = tuple(axis)
    if names != tuple(mesh.mesh_dim_names):
        raise ValueError(f"EP over the axis tuple {names}: the tuple must be "
                         f"the mesh's dims {mesh.mesh_dim_names} in order")
    # one group over the whole mesh, ranks in its row-major order (a
    # collective call: every rank of the world makes it)
    return dist.new_group(ranks=mesh.mesh.flatten().tolist())


def ep_comm(mesh, ep_cfg: "EPConfig") -> EPComm:
    """The :class:`EPComm` of ``ep_cfg.axis`` on ``mesh``."""
    return EPComm(_axis_group(mesh, ep_cfg.axis), axis_size(mesh, ep_cfg.axis),
                  axis_index(mesh, ep_cfg.axis), ep_cfg.transport)


class _Buckets(NamedTuple):
    """This rank's routing decisions for the capacity-bucketed exchange."""

    dest: torch.Tensor       # [T_l*k] destination rank per assignment
    local_exp: torch.Tensor  # [T_l*k] expert index local to the destination
    slot_safe: torch.Tensor  # [T_l*k] capacity slot (== cap when dropped)
    valid: torch.Tensor      # [T_l*k] bool: within capacity
    flat_w: torch.Tensor     # [T_l*k] combine weights
    token_ids: torch.Tensor  # [T_l*k] source token per assignment
    cap: int


def _bucket_assignments(x_local, router, cfg: MoEConfig, ep: int,
                        capacity_factor: float) -> _Buckets:
    t_l = x_local.shape[0]
    k = cfg.top_k
    e_local = _cdiv(cfg.num_experts, ep)   # ceil: phantom-padded tail
    routing = route_topk(x_local @ router, k, cfg.norm_topk_prob,
                         cfg.routed_scaling_factor)
    flat_exp = routing.expert_ids.reshape(-1).long()
    flat_w = routing.weights.reshape(-1)
    dest = flat_exp // e_local
    local_exp = flat_exp % e_local
    cap = _cdiv(int(t_l * k * capacity_factor), ep)
    # slot of each assignment in its destination bucket: the exclusive
    # prefix over (token, k) order
    one_hot = F.one_hot(dest, ep)                             # [T_l*k, ep]
    ranks = torch.cumsum(one_hot, 0) - one_hot
    slot = ranks.gather(1, dest[:, None])[:, 0]
    valid = slot < cap
    slot_safe = torch.where(valid, slot, torch.full_like(slot, cap))
    token_ids = torch.arange(t_l, device=x_local.device).repeat_interleave(k)
    return _Buckets(dest, local_exp, slot_safe, valid, flat_w, token_ids, cap)


def _fill_send(b: _Buckets, rows: torch.Tensor, ep: int) -> torch.Tensor:
    """Scatter per-assignment payloads into the [ep, cap, ...] buffer (the
    dropped ones into the extra slot ``cap``, cut off)."""
    buf = torch.zeros((ep, b.cap + 1, *rows.shape[1:]), dtype=rows.dtype,
                      device=rows.device)
    buf[b.dest, b.slot_safe] = rows
    return buf[:, :b.cap]


def _send_local_exp(b: _Buckets, ep: int, e_local: int) -> torch.Tensor:
    """Local-expert payload; unused slots hold the sentinel ``e_local``, so
    receivers sort them to the tail and count them in no group."""
    buf = torch.full((ep, b.cap + 1), e_local, dtype=torch.int32,
                     device=b.dest.device)
    buf[b.dest, b.slot_safe] = b.local_exp.to(torch.int32)
    return buf[:, :b.cap]


class _RecvSorted(NamedTuple):
    order: torch.Tensor        # [ep*cap] stable sort permutation by local expert
    group_sizes: torch.Tensor  # [E_l] int32 rows per local expert (no padding)


def _sort_recv(recv_le: torch.Tensor, e_local: int) -> _RecvSorted:
    les = recv_le.reshape(-1).long()
    order = torch.argsort(les, stable=True)
    # the sentinel's count falls in the extra bin (bincount syncs on CUDA)
    sizes = torch.zeros(e_local + 1, dtype=torch.int32, device=les.device)
    sizes.scatter_add_(0, les, torch.ones_like(les, dtype=torch.int32))
    return _RecvSorted(order, sizes[:e_local])


def _unsort(out_sorted: torch.Tensor, srt: _RecvSorted, ep: int,
            cap: int) -> torch.Tensor:
    out = torch.empty_like(out_sorted)
    out[srt.order] = out_sorted
    return out.reshape(ep, cap, -1)


def _combine(back: torch.Tensor, b: _Buckets, t_l: int, out_dtype=None):
    """Return-trip gather and the weighted float32 sum per source token."""
    gathered = back[b.dest, b.slot_safe.clamp(0, b.cap - 1)].float()
    w = torch.where(b.valid, b.flat_w, torch.zeros_like(b.flat_w)).float()
    y = torch.zeros((t_l, back.shape[-1]), dtype=torch.float32, device=back.device)
    y.index_put_((b.token_ids,), gathered * w[:, None], accumulate=True)
    return y.to(out_dtype) if out_dtype is not None else y


def _maybe_stats(y, b: _Buckets, ep_cfg: EPConfig):
    if not ep_cfg.return_stats:
        return y
    return y, (~b.valid).sum().to(torch.int32).reshape(1)


def moe_ffn_ep(x_local: torch.Tensor, layer_params: dict, cfg: MoEConfig,
               ep_cfg: EPConfig, comm: EPComm):
    """Routed-expert FFN under expert parallelism, float experts through
    ``ops.gmm`` (``ep_cfg.gmm_backend``: the stock grouped product or K11).
    ``layer_params``: the replicated router and this rank's expert slices."""
    ep = comm.size
    e_local = _cdiv(cfg.num_experts, ep)
    t_l, h = x_local.shape
    b = _bucket_assignments(x_local, layer_params["router"], cfg, ep,
                            ep_cfg.capacity_factor)
    send_x = _fill_send(b, x_local[b.token_ids], ep)
    send_le = _send_local_exp(b, ep, e_local)
    # recv_x[s] = the rows rank s routed to this rank's experts
    recv_x = comm.all_to_all(send_x)
    recv_le = comm.all_to_all(send_le)

    srt = _sort_recv(recv_le, e_local)
    rows_sorted = recv_x.reshape(ep * b.cap, h)[srt.order]
    hh = silu_mul(gmm(rows_sorted, layer_params["expert_gate_up"], srt.group_sizes,
                      backend=ep_cfg.gmm_backend))
    out_sorted = gmm(hh, layer_params["expert_down"], srt.group_sizes,
                     backend=ep_cfg.gmm_backend)
    back = comm.all_to_all(_unsort(out_sorted, srt, ep, b.cap))
    return _maybe_stats(_combine(back, b, t_l, x_local.dtype), b, ep_cfg)


def moe_ffn_ep_quant(x_local: torch.Tensor, layer_params: dict, cfg: MoEConfig,
                     ep_cfg: EPConfig, comm: EPComm, a_bits: int = 8):
    """Expert parallelism with quantized dispatch and compute: tokens are
    quantized once at the source (K1) and the exchange ships int8 codes +
    per-token scales; receivers run K2. Weights pre-quantized
    (``expert_*_q`` / ``_sc``, per-channel symmetric)."""
    ep = comm.size
    e_local = _cdiv(cfg.num_experts, ep)
    t_l, h = x_local.shape
    b = _bucket_assignments(x_local, layer_params["router"], cfg, ep,
                            ep_cfg.capacity_factor)
    xq, xscale = act_quant.quantize_rows_uniform(x_local, a_bits)
    send_x = _fill_send(b, xq[b.token_ids], ep)
    send_s = _fill_send(b, xscale[b.token_ids, 0], ep)
    send_le = _send_local_exp(b, ep, e_local)
    recv_x = comm.all_to_all(send_x)
    recv_s = comm.all_to_all(send_s)
    recv_le = comm.all_to_all(send_le)

    srt = _sort_recv(recv_le, e_local)
    rows_s = recv_x.reshape(ep * b.cap, h)[srt.order]
    rscale_s = recv_s.reshape(ep * b.cap, 1)[srt.order]
    return _quant_ffn_back(rows_s, rscale_s, layer_params, srt, b, ep, t_l,
                           x_local.dtype, ep_cfg, comm, a_bits_down=a_bits)


def _quant_ffn_back(rows_s, rscale_s, lp, srt, b, ep, t_l, dtype, ep_cfg, comm,
                    a_bits_down: int):
    """K2 -> SwiGLU -> K1 -> K2 on the sorted received rows, then the
    exchange back and the combine (the uniform quantized forms)."""
    hh = silu_mul(gmm_w8a8(rows_s, rscale_s, lp["expert_gate_up_q"],
                           lp["expert_gate_up_sc"], srt.group_sizes))
    hq, hscale = act_quant.quantize_rows_uniform(hh, a_bits_down)
    out_s = gmm_w8a8(hq, hscale, lp["expert_down_q"], lp["expert_down_sc"],
                     srt.group_sizes)
    back = comm.all_to_all(_unsort(out_s, srt, ep, b.cap))
    return _maybe_stats(_combine(back, b, t_l, dtype), b, ep_cfg)


def _pack_nibbles_lastdim(q: torch.Tensor) -> torch.Tensor:
    """Signed int4 codes [..., H] -> int8 [..., H//2] (low nibble = even
    index): the a4 wire format."""
    lo = q[..., 0::2].to(torch.int32) & 0xF
    hi = q[..., 1::2].to(torch.int32) & 0xF
    return (((lo | (hi << 4)) ^ 0x80) - 0x80).to(torch.int8)


def _unpack_nibbles_lastdim(p: torch.Tensor) -> torch.Tensor:
    x = p.to(torch.int32)
    lo = ((x & 0xF) ^ 8) - 8
    hi = (((x >> 4) & 0xF) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1],
                                                 2 * p.shape[-1]).to(torch.int8)


def moe_ffn_ep_quant_a4(x_local: torch.Tensor, layer_params: dict,
                        cfg: MoEConfig, ep_cfg: EPConfig, comm: EPComm):
    """EP dispatch with 4-bit activations nibble-packed on the wire (half
    the int8 dispatch's bytes); receivers unpack to int8 and run K2."""
    ep = comm.size
    e_local = _cdiv(cfg.num_experts, ep)
    t_l, h = x_local.shape
    if h % 2:
        raise ValueError(f"moe_ffn_ep_quant_a4: H={h} must be even")
    b = _bucket_assignments(x_local, layer_params["router"], cfg, ep,
                            ep_cfg.capacity_factor)
    xq, xscale = act_quant.quantize_rows_uniform(x_local, 4)   # codes [-7, 7]
    send_x = _fill_send(b, _pack_nibbles_lastdim(xq)[b.token_ids], ep)
    send_s = _fill_send(b, xscale[b.token_ids, 0], ep)
    send_le = _send_local_exp(b, ep, e_local)
    recv_x = comm.all_to_all(send_x)
    recv_s = comm.all_to_all(send_s)
    recv_le = comm.all_to_all(send_le)

    srt = _sort_recv(recv_le, e_local)
    rows = _unpack_nibbles_lastdim(recv_x.reshape(ep * b.cap, h // 2))
    rows_s = rows[srt.order]
    rscale_s = recv_s.reshape(ep * b.cap, 1)[srt.order]
    return _quant_ffn_back(rows_s, rscale_s, layer_params, srt, b, ep, t_l,
                           x_local.dtype, ep_cfg, comm, a_bits_down=8)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy where its start is not 16-byte aligned, as the
    kernels take their int32 metadata: a layer's row of a rank's [L, E_l]
    ``_pf`` / ``_blk`` starts at l * 4 E_l bytes (E_l = 30 at two ranks)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def moe_ffn_ep_mixed(x_local: torch.Tensor, layer_params: dict, cfg: MoEConfig,
                     ep_cfg: EPConfig, comm: EPComm):
    """Expert parallelism for per-expert schemes (the MILP's mixes): each
    (token, k) assignment is quantized at the source to its destination
    expert's act bits (K1 with per-row bits, or the flex quantizer) and
    ships int8 codes + per-row scales ([*, G] for a flex mix); receivers run
    one launch per GEMM: K2 over int8-stored codes, K4 / K4f over this
    rank's packed ragged buffer (``shard_ragged_mixed``), K8 for a flex mix.
    ``act_bits_*`` / ``act_gsize_*`` are the replicated [E] arrays. A pure
    w x a mix only (a16 experts go through :func:`moe_ffn_ep_wo`)."""
    ep = comm.size
    e_local = _cdiv(cfg.num_experts, ep)
    t_l, h = x_local.shape
    lp = layer_params
    b = _bucket_assignments(x_local, lp["router"], cfg, ep, ep_cfg.capacity_factor)
    flat_exp = b.dest * e_local + b.local_exp                 # global ids
    flex = "act_gsize_gateup" in lp

    def _src_quant(rows_in, bits_key, ag_key, flat_ids):
        row_bits = lp[bits_key][flat_ids]
        if not flex:
            return act_quant.quantize_rows(rows_in, row_bits)
        ag = lp[ag_key]                                       # [E, G]
        return quantize_act_rows_flex(rows_in, row_bits, ag[:, 0][flat_ids],
                                      rows_in.shape[-1] // ag.shape[-1])

    rq, rscale = _src_quant(x_local[b.token_ids], "act_bits_gateup",
                            "act_gsize_gateup", flat_exp)
    send_x = _fill_send(b, rq, ep)
    send_s = _fill_send(b, rscale, ep)                        # [*, G] rides
    send_le = _send_local_exp(b, ep, e_local)
    recv_x = comm.all_to_all(send_x)
    recv_s = comm.all_to_all(send_s)
    recv_le = comm.all_to_all(send_le)

    srt = _sort_recv(recv_le, e_local)
    rows_s = recv_x.reshape(ep * b.cap, h)[srt.order]
    rscale_s = recv_s.reshape(ep * b.cap, -1)[srt.order]
    packed = "expert_gate_up_qcat" in lp

    def _mixed_gmm(acts_q, acts_sc, prefix):
        zp, sc = lp.get(f"{prefix}_zp"), lp[f"{prefix}_sc"]
        if packed:
            qcat = lp[f"{prefix}_qcat"]
            return gmm_mixed_packed(acts_q, acts_sc, qcat.reshape(-1, qcat.shape[-1]),
                                    sc, srt.group_sizes, _aligned(lp[f"{prefix}_pf"]),
                                    _aligned(lp[f"{prefix}_blk"]), rhs_zp=zp,
                                    out_dtype=x_local.dtype)
        if flex and (sc.shape[-2] > 1 or zp is not None):
            return gmm_w8a8_grouped(acts_q, acts_sc, lp[f"{prefix}_q"], sc,
                                    srt.group_sizes, gsize=acts_q.shape[-1] // sc.shape[-2],
                                    rhs_zp=zp, out_dtype=x_local.dtype)
        return gmm_w8a8(acts_q, acts_sc, lp[f"{prefix}_q"], sc, srt.group_sizes,
                        out_dtype=x_local.dtype)

    hh = silu_mul(_mixed_gmm(rows_s, rscale_s, "expert_gate_up"))
    # down-proj act bits from the local expert owning each sorted row;
    # sentinel rows read a clamped entry and never travel back
    le_sorted = recv_le.reshape(-1)[srt.order].long()
    gids_down = (comm.index * e_local + le_sorted).clamp(0, cfg.num_experts - 1)
    hq, hscale = _src_quant(hh, "act_bits_down", "act_gsize_down", gids_down)
    out_s = _mixed_gmm(hq, hscale, "expert_down")
    back = comm.all_to_all(_unsort(out_s, srt, ep, b.cap))
    return _maybe_stats(_combine(back, b, t_l, x_local.dtype), b, ep_cfg)


def moe_ffn_ep_wo(x_local: torch.Tensor, layer_params: dict, cfg: MoEConfig,
                  ep_cfg: EPConfig, comm: EPComm):
    """EP for mixes that hold a16 weight-only experts: float rows ride the
    exchange (twice the int8 wire); each receiver quantizes its rows at the
    owning local expert's act bits and runs K10 (``gmm_mixed_wo_wxa``: a16
    rows against dequantized weights, w x a rows as K8 / K2), one launch per
    GEMM. int8-stored codes only."""
    ep = comm.size
    e_local = _cdiv(cfg.num_experts, ep)
    t_l, h = x_local.shape
    lp = layer_params
    flex = "act_gsize_gateup" in lp
    b = _bucket_assignments(x_local, lp["router"], cfg, ep, ep_cfg.capacity_factor)
    send_x = _fill_send(b, x_local[b.token_ids], ep)          # float payload
    send_le = _send_local_exp(b, ep, e_local)
    recv_x = comm.all_to_all(send_x)
    recv_le = comm.all_to_all(send_le)

    srt = _sort_recv(recv_le, e_local)
    rows_bf = recv_x.reshape(ep * b.cap, h)[srt.order]
    le_sorted = recv_le.reshape(-1)[srt.order].long()
    shard0 = comm.index * e_local
    gids = (shard0 + le_sorted).clamp(0, cfg.num_experts - 1)
    local_ids = (shard0 + torch.arange(e_local, device=x_local.device)).clamp(
        0, cfg.num_experts - 1)

    def _recv_quant(rows_in, bits_key, ag_key):
        row_bits = lp[bits_key][gids]
        if not flex:
            return act_quant.quantize_rows(rows_in, row_bits)
        ag = lp[ag_key]
        return quantize_act_rows_flex(rows_in, row_bits, ag[:, 0][gids],
                                      rows_in.shape[-1] // ag.shape[-1])

    def _wo_gmm(acts, prefix, bits_key, ag_key):
        aq, asc = _recv_quant(acts, bits_key, ag_key)
        flags16 = (lp[bits_key][local_ids] >= 16).to(torch.int32)
        return gmm_mixed_wo_wxa(acts, aq, asc, lp[f"{prefix}_q"], lp[f"{prefix}_sc"],
                                flags16, srt.group_sizes, rhs_zp=lp.get(f"{prefix}_zp"),
                                out_dtype=x_local.dtype)

    hh = silu_mul(_wo_gmm(rows_bf, "expert_gate_up", "act_bits_gateup",
                          "act_gsize_gateup"))
    out_s = _wo_gmm(hh, "expert_down", "act_bits_down", "act_gsize_down")
    back = comm.all_to_all(_unsort(out_s, srt, ep, b.cap))
    return _maybe_stats(_combine(back, b, t_l, x_local.dtype), b, ep_cfg)


# -- wrappers: the shard_map wrappers' counterparts --------------------------
# Each returns fn(x_local, ...) over this rank's row block and expert slices
# (the JAX wrappers take the global arrays and shard them). With
# return_stats, fn returns (y_local, this rank's dropped assignments [1]).

def make_ep_moe_fn(cfg: MoEConfig, mesh, ep_cfg: EPConfig = EPConfig()):
    comm = ep_comm(mesh, ep_cfg)

    def fn(x_local, router, gate_up, down):
        lp = {"router": router, "expert_gate_up": gate_up, "expert_down": down}
        return moe_ffn_ep(x_local, lp, cfg, ep_cfg, comm)

    return fn


def _quant_lp(router, gq, gsc, dq, dsc) -> dict:
    return {"router": router, "expert_gate_up_q": gq, "expert_gate_up_sc": gsc,
            "expert_down_q": dq, "expert_down_sc": dsc}


def make_ep_moe_quant_fn(cfg: MoEConfig, mesh, ep_cfg: EPConfig = EPConfig(),
                         a_bits: int = 8):
    comm = ep_comm(mesh, ep_cfg)

    def fn(x_local, router, gq, gsc, dq, dsc):
        return moe_ffn_ep_quant(x_local, _quant_lp(router, gq, gsc, dq, dsc), cfg,
                                ep_cfg, comm, a_bits)

    return fn


def make_ep_moe_quant_a4_fn(cfg: MoEConfig, mesh, ep_cfg: EPConfig = EPConfig()):
    comm = ep_comm(mesh, ep_cfg)

    def fn(x_local, router, gq, gsc, dq, dsc):
        return moe_ffn_ep_quant_a4(x_local, _quant_lp(router, gq, gsc, dq, dsc),
                                   cfg, ep_cfg, comm)

    return fn


def make_ep_moe_mixed_fn(cfg: MoEConfig, mesh, ep_cfg: EPConfig = EPConfig(),
                         packed: bool = False):
    """The mixed block over explicit operands. ``packed``: each linear is
    (qcat [1, R_l, N] this rank's buffer, sc [E_l, 1, N], blk [E_l], pf
    [E_l]) from ``quant.packing.shard_ragged_mixed``; else (q, sc)."""
    comm = ep_comm(mesh, ep_cfg)

    def fn(x_local, router, *ops):
        lp = {"router": router, "act_bits_gateup": ops[-2], "act_bits_down": ops[-1]}
        names = (("qcat", "sc", "blk", "pf") if packed else ("q", "sc"))
        for i, prefix in enumerate(("expert_gate_up", "expert_down")):
            for j, name in enumerate(names):
                lp[f"{prefix}_{name}"] = ops[i * len(names) + j]
        return moe_ffn_ep_mixed(x_local, lp, cfg, ep_cfg, comm)

    return fn


def make_ep_moe_mixed_dyn(cfg: MoEConfig, mesh, ep_cfg: EPConfig = EPConfig()):
    """The mixed block over a layer's params as they are: int8-stored,
    packed ragged and flex layouts, and a16 mixes (``ep_cfg.wo_mix``) all
    take ``fn(x_local, lp)``."""
    comm = ep_comm(mesh, ep_cfg)
    body = moe_ffn_ep_wo if ep_cfg.wo_mix else moe_ffn_ep_mixed

    def fn(x_local, lp):
        return body(x_local, lp, cfg, ep_cfg, comm)

    return fn


class EPMoEBlock:
    """EP MoE as a drop-in ``moe_block`` for the cached forward (assign to
    ``MoEImpl.ep_moe``): ``block(x [B, S, H], lp, cfg) -> y``. The routed
    experts go through the all-to-all, the shared expert runs on this rank's
    own rows (replicated weights).

    Row layout: by default this rank's rows are its JAX row block (every rank
    holds as many: a decode step over equal slot shards, a full-width
    prefill). Under ``with block.rows(counts)`` the rows of all ranks form
    the global rows in rank order, ``counts[r]`` of them on rank r, and the
    block moves them to the equal row blocks and back (one slot's prefill on
    the rank that owns the slot: the others call it with no rows). With
    ``ep_cfg.return_stats`` the dropped assignments add up in ``dropped``."""

    def __init__(self, cfg: MoEConfig, mesh, quantized, ep_cfg: EPConfig):
        self.cfg, self.quantized, self.ep_cfg = cfg, quantized, ep_cfg
        self.comm = ep_comm(mesh, ep_cfg)
        self._counts = None
        self.dropped = None

    @contextlib.contextmanager
    def rows(self, counts):
        self._counts = list(counts)
        try:
            yield self
        finally:
            self._counts = None

    def _routed(self, x_local, lp):
        args = (x_local, lp, self.cfg, self.ep_cfg, self.comm)
        if self.quantized in ("mixed", "mixed-packed", "mixed-wo"):
            return (moe_ffn_ep_wo if self.ep_cfg.wo_mix else moe_ffn_ep_mixed)(*args)
        if self.quantized:
            return moe_ffn_ep_quant(*args)
        return moe_ffn_ep(*args)

    def _splits(self):
        """(rows this rank sends to each row block, rows each rank's span
        gives this rank's block)."""
        counts, ep, me = self._counts, self.comm.size, self.comm.index
        total = sum(counts)
        if total % ep:
            raise ValueError(f"EP rows {counts}: {total} do not split into {ep} blocks")
        blk = total // ep
        starts = np.cumsum([0, *counts])

        def overlap(a0, a1, b0, b1):
            return max(0, min(a1, b1) - max(a0, b0))

        send = [overlap(starts[me], starts[me + 1], j * blk, (j + 1) * blk)
                for j in range(ep)]
        recv = [overlap(starts[i], starts[i + 1], me * blk, (me + 1) * blk)
                for i in range(ep)]
        return send, recv

    def __call__(self, x: torch.Tensor, lp: dict, cfg_: MoEConfig) -> torch.Tensor:
        b, s, hdim = x.shape
        x2d = x.reshape(-1, hdim)
        if self._counts is None:
            y = self._routed(x2d, lp)
        else:
            send, recv = self._splits()
            y = self._routed(self.comm.all_to_all(x2d, recv, send), lp)
        if self.ep_cfg.return_stats:
            y, drops = y
            self.dropped = drops if self.dropped is None else self.dropped + drops
        if self._counts is not None:
            y = self.comm.all_to_all(y, send, recv)
        if cfg_.shared_expert_intermediate_size > 0 and x2d.shape[0] > 0:
            y = y + shared_expert_ffn(x2d, lp, cfg_)
        return y.reshape(b, s, hdim)


def make_ep_moe_block(cfg: MoEConfig, mesh, quantized=False,
                      ep_cfg: EPConfig = EPConfig()) -> EPMoEBlock:
    """``quantized``: False (float experts), True (uniform per-channel w8a8
    codes) or "mixed" / "mixed-packed" / "mixed-wo" (per-expert schemes)."""
    return EPMoEBlock(cfg, mesh, quantized, ep_cfg)
