"""Canonical GroupGEMM workloads for benchmarking (the port's own copy of
``mxmoe_tpu/bench/workloads.py``: the data, the headline pair and the
profiler's seeded ``synthetic_workload``).

The headline workload is qwen2_moe layer 10 at 8192 tokens, top-4: the
routed token count of each of the 60 experts from a recorded WikiText-2 gate
trace, plus the shared expert. Sum of 2MNK ~ 1.134 TOP a layer (gate_up +
down). Only the shapes are data; the operands are made from a seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Routed tokens per expert (60 experts) for qwen2_moe layer 10 at 8192 tokens,
# top-4 (the shared expert's 8192 rows are kept apart)
QWEN2_MOE_L10_BS8192_ROUTED_M = [
    690, 486, 584, 788, 420, 590, 536, 676, 566, 476, 614, 724, 524, 610,
    532, 310, 530, 810, 448, 410, 546, 572, 408, 450, 574, 420, 534, 562,
    638, 502, 550, 590, 576, 564, 550, 510, 612, 604, 494, 702, 400, 602,
    480, 472, 506, 458, 600, 616, 540, 534, 386, 656, 552, 574, 474, 606,
    572, 334, 546, 572,
]


@dataclasses.dataclass(frozen=True)
class GroupGemmWorkload:
    """A grouped-GEMM problem set over E experts plus a dense shared expert.

    Routed:  lhs rows grouped per expert (group_sizes), rhs [E, K, N].
    Shared:  one dense [M_sh, K_sh] @ [K_sh, N_sh] problem (M_sh=0 -> none).
    """

    name: str
    group_sizes: tuple[int, ...]   # routed rows per expert
    k: int                         # routed reduction dim
    n: int                         # routed output dim
    shared_m: int = 0
    shared_k: int = 0
    shared_n: int = 0

    @property
    def m_total(self) -> int:
        return int(sum(self.group_sizes))

    @property
    def num_experts(self) -> int:
        return len(self.group_sizes)

    @property
    def flops(self) -> int:
        routed = 2 * self.m_total * self.k * self.n
        shared = 2 * self.shared_m * self.shared_k * self.shared_n
        return routed + shared


def qwen2_moe_l10_bs8192() -> tuple[GroupGemmWorkload, GroupGemmWorkload]:
    """(gate_up, down) workloads for the canonical layer."""
    ms = tuple(QWEN2_MOE_L10_BS8192_ROUTED_M)
    gate_up = GroupGemmWorkload(
        name="qwen2_moe-l10-bs8192-gate_up",
        group_sizes=ms, k=2048, n=2816,
        shared_m=8192, shared_k=2048, shared_n=11264,
    )
    down = GroupGemmWorkload(
        name="qwen2_moe-l10-bs8192-down",
        group_sizes=ms, k=1408, n=2048,
        shared_m=8192, shared_k=5632, shared_n=2048,
    )
    return gate_up, down


def synthetic_workload(num_experts: int, tokens: int, top_k: int, k: int, n: int,
                       seed: int = 42, alpha: float = 8.0) -> GroupGemmWorkload:
    """Dirichlet-distributed routed row counts (the profiler's sweeps),
    drawn with numpy from ``seed``: the JAX package's group sizes."""
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.full(num_experts, alpha))
    ms = np.maximum(1, np.round(probs * tokens * top_k).astype(int))
    return GroupGemmWorkload(name=f"synthetic-e{num_experts}-t{tokens}-k{top_k}",
                             group_sizes=tuple(int(m) for m in ms), k=k, n=n)


def k11_shapes(routed) -> list[tuple[str, list[int], int, int]]:
    """K11's bf16 A/B shapes (``redesign_ab --cases bf16_large``,
    ``variant_ab --kernel bf16``) -> (use, group sizes, K, N): the qwen2_moe
    and ds2 prefill chunks (256 tokens), qwen2_moe gate_up and down at the
    decode rows and just above them (M 16-128), gate_up at M 512 and 4096,
    the profiler's three scales (gate_up) and the headline pair.
    ``routed(model, tokens)`` gives the group sizes of ``tokens`` tokens
    routed over ``model``'s experts."""
    from ..models import configs
    from ..trace import profiler

    def projections(cfg):
        h, n = cfg.hidden_size, cfg.moe_intermediate_size
        return (("gate_up", h, 2 * n), ("down", n, h))

    shapes = []
    for model in ("qwen2_moe", "ds2"):
        sizes = routed(model, 256)
        shapes += [(f"{model} prefill chunk {proj}", sizes, k, n)
                   for proj, k, n in projections(configs.config_for(model))]
    qwen = configs.config_for("qwen2_moe")
    (_, h, n2), down = projections(qwen)
    for tokens in (4, 10, 17, 20, 24, 28, 32, 128, 1024):
        sizes = routed("qwen2_moe", tokens)
        shapes.append((f"qwen2_moe M {4 * tokens} gate_up", sizes, h, n2))
        if tokens <= 32:
            shapes.append((f"qwen2_moe M {4 * tokens} down", sizes, *down[1:]))
    shapes += [(f"profiler {t} tokens gate_up",
                list(synthetic_workload(qwen.num_experts, t, qwen.top_k, h,
                                        n2).group_sizes), h, n2)
               for t in profiler.SCALES]
    shapes += [(f"headline {wl.name.rsplit('-', 1)[-1]}",
                list(QWEN2_MOE_L10_BS8192_ROUTED_M), wl.k, wl.n)
               for wl in qwen2_moe_l10_bs8192()]
    return shapes
