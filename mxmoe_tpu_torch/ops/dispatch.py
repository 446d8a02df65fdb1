"""Token -> expert routing and ragged dispatch (port of
``mxmoe_tpu/ops/dispatch.py``).

Routing emits a stable sort permutation plus per-expert ``group_sizes``,
the layout the grouped GEMM consumes. Every function here stays on the
device: no ``.item()``/``.cpu()`` and no op that syncs on CUDA
(``torch.bincount`` does, so group sizes come from ``scatter_add_``).

Top-k tie rule: ``jax.lax.top_k`` and ``torch.topk`` may order equal
probabilities differently, so the port matches the reference on
tie-free logits only (router logits of real models are tie-free in
practice; ``tests/test_torch_quant_dispatch.py`` pins this).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Routing(NamedTuple):
    weights: torch.Tensor     # [T, k] float32 combine weights
    expert_ids: torch.Tensor  # [T, k] int32


class Dispatch(NamedTuple):
    sort_idx: torch.Tensor         # [T*k] position in expanded (token-major) order
    group_sizes: torch.Tensor      # [E] int32 rows per expert
    token_ids: torch.Tensor        # [T*k] (or padded) source token per sorted row
    combine_weights: torch.Tensor  # [T*k] (or padded) weight per sorted row
    # aligned layouts only: [T*k] position of each routed row, in sorted order
    # (the reference has no such field: its segment sum is indifferent to the
    # padding rows, torch's sorted accumulate is not; see combine_tokens)
    real_rows: torch.Tensor | None = None


def route_topk(router_logits: torch.Tensor, top_k: int, norm_topk_prob: bool,
               scaling: float = 1.0) -> Routing:
    """Softmax over all experts in float32, top-k, optional renormalize
    (``norm_topk_prob``) and ``scaling`` (HF Qwen2-MoE / Mixtral / DS2)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    weights, ids = torch.topk(probs, top_k, dim=-1)
    if norm_topk_prob:
        weights = weights / weights.sum(-1, keepdim=True)
    if scaling != 1.0:
        weights = weights * scaling
    return Routing(weights=weights, expert_ids=ids.to(torch.int32))


def make_dispatch(routing: Routing, num_experts: int,
                  align: int | None = None) -> Dispatch:
    """Stable-sort the T*k expanded rows by expert id.

    ``align``: pad every expert's row count to a multiple of ``align``;
    padding rows alias token 0 with combine weight 0 (never read back)."""
    t, k = routing.expert_ids.shape
    dev = routing.expert_ids.device
    flat_experts = routing.expert_ids.reshape(-1).long()
    flat_weights = routing.weights.reshape(-1)
    token_ids = torch.arange(t, dtype=torch.int32, device=dev).repeat_interleave(k)
    sort_idx = torch.argsort(flat_experts, stable=True)
    group_sizes = torch.zeros(num_experts, dtype=torch.int32, device=dev)
    group_sizes.scatter_add_(0, flat_experts,
                             torch.ones_like(flat_experts, dtype=torch.int32))
    tid_sorted = token_ids[sort_idx]
    w_sorted = flat_weights[sort_idx]
    if align is None or align <= 1:
        return Dispatch(sort_idx, group_sizes, tid_sorted, w_sorted)

    bm = int(align)
    padded = (group_sizes + bm - 1) // bm * bm
    m_pad = t * k + num_experts * (bm - 1)                   # static bound
    starts = torch.cumsum(group_sizes, 0) - group_sizes
    padded_starts = torch.cumsum(padded, 0) - padded
    g_of_row = flat_experts[sort_idx]                        # sorted expert ids
    rank = torch.arange(t * k, device=dev) - starts[g_of_row]
    pos = padded_starts[g_of_row] + rank
    tid_pad = torch.zeros(m_pad, dtype=torch.int32, device=dev)
    tid_pad[pos] = tid_sorted
    w_pad = torch.zeros(m_pad, dtype=flat_weights.dtype, device=dev)
    w_pad[pos] = w_sorted
    return Dispatch(sort_idx, padded.to(torch.int32), tid_pad, w_pad, pos)


def expert_of_rows(group_sizes: torch.Tensor, rows: int) -> torch.Tensor:
    """The expert of each of ``rows`` expert-sorted rows -> int64 [rows]: the
    reference's ``jnp.repeat(arange(E), group_sizes,
    total_repeat_length=rows)``, which gives every row past
    ``sum(group_sizes)`` (the aligned layout's tail) the last expert, E - 1.
    Sync-free: the sizes never reach the host."""
    ends = torch.cumsum(group_sizes.long(), 0)
    row = torch.arange(rows, device=group_sizes.device)
    return torch.bucketize(row, ends, right=True).clamp_(max=group_sizes.numel() - 1)


def gather_tokens(x: torch.Tensor, dispatch: Dispatch) -> torch.Tensor:
    """[T, H] -> [rows, H] in expert-sorted order."""
    return x[dispatch.token_ids.long()]


def combine_tokens(expert_out: torch.Tensor, dispatch: Dispatch,
                   num_tokens: int) -> torch.Tensor:
    """Weighted scatter-add of sorted expert outputs back to [T, H].

    Zero-weight rows (aligned padding) are masked with ``where``, never
    multiplied: the GEMM leaves them unwritten, and NaN*0 would poison
    the sum. A token's k contributions are added in sorted-row order:
    ``index_put_(accumulate=True)`` sorts its indices on CUDA, where
    ``index_add_`` adds with atomics in an order that changes from run to
    run (and with it the last bf16 bit). Storage forms that hold the same
    codes then give bitwise the same logits.

    An aligned layout's routed rows are gathered first (``real_rows``, a
    static T*k of them): its padding rows all alias token 0, and the sorted
    accumulate adds one index's duplicates serially (1860 of them at decode,
    60 experts padded to 32 rows: ~1.1 ms a call on an H100). The sum is the
    unaligned layout's, in the same order."""
    token_ids, weights = dispatch.token_ids, dispatch.combine_weights
    if dispatch.real_rows is not None:
        rows = dispatch.real_rows
        expert_out, token_ids, weights = expert_out[rows], token_ids[rows], weights[rows]
    w = weights[:, None].to(expert_out.dtype)
    weighted = torch.where(w != 0, expert_out * w, torch.zeros_like(expert_out))
    out = torch.zeros((num_tokens, expert_out.shape[-1]),
                      dtype=expert_out.dtype, device=expert_out.device)
    return out.index_put_((token_ids.long(),), weighted, accumulate=True)
