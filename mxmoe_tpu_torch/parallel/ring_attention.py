"""Ring attention: causal attention with the SEQUENCE sharded over a
process group (port of ``mxmoe_tpu/parallel/ring_attention.py``; context
parallelism for long prefill).

Each rank holds a contiguous S/P block of Q, K, V. In P ring steps the K/V
block moves one hop (rank i -> i+1, ``dist.batch_isend_irecv``) while every
rank folds its queries' attention over the block it holds into an
online-softmax state, so a rank's score memory is O(S/P * S/P). Causality
at block granularity: a block from later positions contributes nothing and
is skipped, the rank's own block is masked triangularly. The merge and the
block softmax are the JAX package's, in float32.

Transports as in ``parallel.ep``: ``"direct"`` hands the blocks to the
group's backend where they are, ``"host"`` stages them through host buffers
(a gloo group beside tensors on the card).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


def _block_attention(q, k, v, scale, mask):
    """Scores of one (q-block, kv-block) pair -> (m, l, acc) contributions.
    q [B, Sq, n, hd]; k / v [B, Skv, n, hd]; mask [Sq, Skv] bool or None.
    Returns m, l [B, n, Sq] and acc [B, n, Sq, hd]."""
    s = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float()) * scale
    if mask is not None:
        s = s.masked_fill(~mask[None, None], float("-inf"))
    m = s.amax(-1)
    # a fully masked row has m = -inf: exp(-inf - -inf) is guarded
    p = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m))[..., None])
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    return m, p.sum(-1), torch.einsum("bnqk,bknh->bnqh", p, v.float())


def _merge(m1, l1, a1, m2, l2, a2):
    """Merge two online-softmax partial states."""
    m = torch.maximum(m1, m2)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    zero = torch.zeros_like(m)
    c1 = torch.where(torch.isfinite(m1), torch.exp(m1 - m_safe), zero)
    c2 = torch.where(torch.isfinite(m2), torch.exp(m2 - m_safe), zero)
    return m, l1 * c1 + l2 * c2, a1 * c1[..., None] + a2 * c2[..., None]


def _ring_shift(tensors, group, transport: str):
    """Send each tensor to the next rank of the ring, receive the previous
    rank's."""
    p, me = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % p) if group is not None else (me + 1) % p
    prv = dist.get_global_rank(group, (me - 1) % p) if group is not None else (me - 1) % p
    send = [(t.cpu() if transport == "host" else t).contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in send]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in send]
    ops += [dist.P2POp(dist.irecv, t, prv, group) for t in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(t.device) for r, t in zip(recv, tensors)]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, scale: float | None = None,
                   transport: str = "direct") -> torch.Tensor:
    """Causal attention over the sequence-sharded ``group`` (the default
    process group when None): q [B, S_l, n_h, hd] this rank's queries, k / v
    [B, S_l, n_kv, hd] -> [B, S_l, n_h, hd]."""
    if not dist.is_initialized():
        raise RuntimeError(
            "ring attention needs a torch.distributed process group: none is "
            "initialized (parallel.multihost.initialize, then "
            "parallel.sharded.make_sp_prefill_forward)")
    b, s_l, n_h, hd = q.shape
    n_kv = k.shape[2]
    if n_kv != n_h:
        k = k.repeat_interleave(n_h // n_kv, dim=2)
        v = v.repeat_interleave(n_h // n_kv, dim=2)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    p, my = dist.get_world_size(group), dist.get_rank(group)
    causal = torch.ones((s_l, s_l), dtype=torch.bool, device=q.device).tril()

    m = torch.full((b, n_h, s_l), float("-inf"), device=q.device)
    l = torch.zeros((b, n_h, s_l), device=q.device)
    acc = torch.zeros((b, n_h, s_l, hd), device=q.device)
    kr, vr = k, v
    for r in range(p):
        src = (my - r) % p          # the rank whose K/V block this rank holds
        if src <= my:               # a later block contributes nothing
            bm, bl, ba = _block_attention(q, kr, vr, scale,
                                          causal if src == my else None)
            m, l, acc = _merge(m, l, acc, bm, bl, ba)
        if r < p - 1:
            kr, vr = _ring_shift((kr, vr), group, transport)
    out = acc / torch.clamp(l, min=1e-30)[..., None]            # [B, n, Sq, hd]
    return out.transpose(1, 2).to(q.dtype)


def make_ring_attention_fn(mesh, axis: str = "seq", transport: str = "direct"):
    """``fn(q, k, v)``: ring attention over ``mesh``'s dim ``axis``, this
    rank's sequence block (the shard_map wrapper's counterpart)."""
    group = mesh.get_group(axis)

    def fn(q, k, v):
        return ring_attention(q, k, v, group=group, transport=transport)

    return fn
