"""Scheme -> kernel registry, shared by the profiler, the one-launch fit and
the tests (port of ``mxmoe_tpu/bench/kernels.py``): given a scheme string
and a grouped workload, deterministic operands and a launcher that calls the
scheme's kernel through its ``ops`` front end.

    scheme_kind           kernel  front end
    bf16                  K11     ops.gmm.gmm_bf16
    int8 (sym)            K2      ops.gmm_w8a8.gmm_w8a8
    int8 (asym)           K9      ops.gmm_w8a8_asym.gmm_w8a8_asym
    int8_packed           K5      ops.gmm_w4a8_packed.gmm_w4a8_packed
    weight_only           K6      ops.gmm_weight_only.gmm_weight_only
    weight_only_packed    K7      ops.gmm_weight_only_packed.gmm_weight_only_packed
    int8_grouped          K8      ops.gmm_w8a8_grouped.gmm_w8a8_grouped

A scheme string ending in ``_packed`` stores w4 nibble-packed. On a CPU
tensor a front end runs its kernel's plain version; on a CUDA tensor it
launches the kernel or raises.

Tiles. The JAX package's ``TileSpec`` / ``DEFAULT_TILES`` are Pallas block
sizes that its caller chooses; the port's kernels choose their own schedule
from the shapes (``ops.gmm_w8a8.int8_gmm_schedule``,
``ops.gmm_w8a8_grouped.grouped_gmm_schedule`` / ``weight_only_gmm_schedule``,
``ops.gmm.bf16_gmm_schedule``; K2 / K5's wgmma body above M 64, K11's at
every M). So a scheme
has ONE tile here at a given workload: ``scheme_tile`` names the schedule
its kernel takes at those shapes, with ``bm`` / ``bn`` that schedule's
output tile. The solver's assignment <-> tile fixed point then converges at
once, and its ``*_tile_cfg.json`` names these schedules.
"""

from __future__ import annotations

import dataclasses

import torch

from ..quant.schemes import QLinearConfig, parse_scheme
from .workloads import GroupGemmWorkload

@dataclasses.dataclass(frozen=True)
class TileSpec:
    """The output tile of the schedule a kernel takes (``schedule`` names
    it: the kernel and its body)."""

    bm: int
    bn: int
    schedule: str

    def __repr__(self) -> str:
        return f"{self.schedule}-bm{self.bm}-bn{self.bn}"


def scheme_kind(cfg: QLinearConfig, packed: bool = False) -> str:
    if cfg.w_bits >= 16 and cfg.a_bits >= 16:
        return "bf16"
    if cfg.a_bits >= 16:
        return "weight_only_packed" if packed else "weight_only"
    if cfg.w_gsize == -1:
        return "int8_packed" if packed else "int8"
    return "int8_grouped"


def _is_packed(scheme) -> bool:
    return isinstance(scheme, str) and scheme.endswith("_packed")


def _parse(scheme) -> tuple[QLinearConfig, str]:
    if isinstance(scheme, QLinearConfig):
        return scheme, scheme_kind(scheme)
    packed = _is_packed(scheme)
    cfg = parse_scheme(scheme[: -len("_packed")] if packed else scheme)
    return cfg, scheme_kind(cfg, packed)


def kernel_of(scheme) -> str:
    """The launch-count name of the kernel a scheme runs."""
    cfg, kind = _parse(scheme)
    if kind == "int8" and not cfg.w_sym:
        return "gmm_w8a8_asym"
    return {"bf16": "gmm_bf16", "int8": "gmm_w8a8", "int8_packed": "gmm_w4a8_packed",
            "weight_only": "gmm_weight_only",
            "weight_only_packed": "gmm_weight_only_packed",
            "int8_grouped": "gmm_w8a8_grouped"}[kind]


def _gsize(cfg: QLinearConfig, k: int) -> int:
    return k if cfg.w_gsize == -1 else cfg.w_gsize


def scheme_tile(scheme, m: int, k: int, n: int, e: int) -> TileSpec:
    """The tile of the schedule the scheme's kernel takes at [M, K] x
    [E, K, N] (aligned operands)."""
    from ..ops.gmm import bf16_gmm_schedule
    from ..ops.gmm_w8a8 import int8_gmm_schedule
    from ..ops.gmm_w8a8_asym import asym_gmm_schedule
    from ..ops.gmm_w8a8_grouped import grouped_gmm_schedule, weight_only_gmm_schedule

    cfg, kind = _parse(scheme)
    name = kernel_of(scheme)
    if kind == "bf16":
        sched = bf16_gmm_schedule()
        return TileSpec(sched.bm, sched.bn, f"{name}.{sched.body}")
    if kind in ("weight_only", "weight_only_packed"):
        sched = weight_only_gmm_schedule(m, k, n, e, _gsize(cfg, k))
    elif kind == "int8_grouped":
        sched = grouped_gmm_schedule(m, k, n, e, _gsize(cfg, k), wgmma=True)
    elif name == "gmm_w8a8_asym":
        # K9 takes K8's wgmma body B with one group above the decode rows
        sched = asym_gmm_schedule(m, k, n, e)
    else:
        # K2 and K5 take the wgmma body above the decode rows
        sched = int8_gmm_schedule(m, k, n, e, packed=kind == "int8_packed", wgmma=True)
    body = ("decode" if sched.bm == 16 else "wgmma" if sched.bm == 128 else "prefill")
    return TileSpec(sched.bm, sched.bn, f"{name}.{body}")


def build_operands(wl: GroupGemmWorkload, scheme, seed: int = 42, device="cuda") -> dict:
    """Deterministic operands for one scheme on one workload: activations
    and weights uniform in [-1, 1] from a generator seeded ``seed`` on
    ``device``, quantized as the scheme says."""
    from ..quant.packing import pack_int4_halves
    from ..quant.qparams import (quantize_act_grouped, quantize_act_per_token,
                                 quantize_expert_weights)

    device = torch.device(device)
    cfg, kind = _parse(scheme)
    m, k, n, e = wl.m_total, wl.k, wl.n, wl.num_experts
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.rand((m, k), generator=gen, device=device) * 2 - 1
    w = torch.rand((e, k, n), generator=gen, device=device) * 2 - 1
    gs = torch.tensor(wl.group_sizes, dtype=torch.int32, device=device)
    if kind == "bf16":
        return {"lhs": a.to(torch.bfloat16), "rhs": w.to(torch.bfloat16), "gs": gs}
    qp = quantize_expert_weights(w, cfg)
    del w
    rhs = pack_int4_halves(qp.q) if kind.endswith("_packed") else qp.q
    ops = {"rhs": rhs, "rhs_sc": qp.scale, "rhs_zp": qp.zp, "gs": gs}
    if kind.startswith("weight_only"):
        ops["lhs"] = a.to(torch.bfloat16)
    elif kind == "int8_grouped":
        g = cfg.a_gsize if cfg.a_gsize > 0 else cfg.w_gsize
        ops["lhs"], ops["lhs_sc"] = quantize_act_grouped(a, int(cfg.a_bits), g)
    else:
        ops["lhs"], ops["lhs_sc"] = quantize_act_per_token(a, int(cfg.a_bits))
    return ops


def make_launcher(scheme):
    """``fn(operands) -> out`` [M, N] bf16 through the scheme's kernel (which
    chooses its own schedule: the JAX package's ``tile`` and ``gsize``
    arguments have no counterpart)."""
    from ..ops.gmm import gmm_bf16
    from ..ops.gmm_w4a8_packed import gmm_w4a8_packed
    from ..ops.gmm_w8a8 import gmm_w8a8
    from ..ops.gmm_w8a8_asym import gmm_w8a8_asym
    from ..ops.gmm_w8a8_grouped import gmm_w8a8_grouped
    from ..ops.gmm_weight_only import gmm_weight_only
    from ..ops.gmm_weight_only_packed import gmm_weight_only_packed

    cfg, kind = _parse(scheme)
    name = kernel_of(scheme)

    def g_of(ops):
        return _gsize(cfg, ops["lhs"].shape[-1])

    if kind == "bf16":
        return lambda o: gmm_bf16(o["lhs"], o["rhs"], o["gs"])
    if name == "gmm_w8a8":
        return lambda o: gmm_w8a8(o["lhs"], o["lhs_sc"], o["rhs"], o["rhs_sc"], o["gs"])
    if name == "gmm_w8a8_asym":
        return lambda o: gmm_w8a8_asym(o["lhs"], o["lhs_sc"], o["rhs"], o["rhs_sc"],
                                       o["rhs_zp"], o["gs"])
    if kind == "int8_packed":
        return lambda o: gmm_w4a8_packed(o["lhs"], o["lhs_sc"], o["rhs"], o["rhs_sc"],
                                         o["gs"])
    if kind == "weight_only":
        return lambda o: gmm_weight_only(o["lhs"], o["rhs"], o["rhs_sc"], o["rhs_zp"],
                                         o["gs"], gsize=g_of(o))
    if kind == "weight_only_packed":
        return lambda o: gmm_weight_only_packed(o["lhs"], o["rhs"], o["rhs_sc"],
                                                o["rhs_zp"], o["gs"], gsize=g_of(o))
    zp = None if cfg.w_sym else "rhs_zp"
    return lambda o: gmm_w8a8_grouped(o["lhs"], o["lhs_sc"], o["rhs"], o["rhs_sc"],
                                      o["gs"], gsize=g_of(o),
                                      rhs_zp=None if zp is None else o[zp])


def reference_output(ops: dict, scheme) -> torch.Tensor:
    """The check oracle: f32 products of the dequantized operands, group by
    group -> [M, N] f32 (rows past the groups zero)."""
    from ..quant.packing import PackedTensor, dequantize_weight_kn, unpack_int4_halves

    cfg, kind = _parse(scheme)
    lhs = ops["lhs"]
    m, k = lhs.shape
    if kind == "bf16":
        a, w = lhs.float(), ops["rhs"].float()
    else:
        q = unpack_int4_halves(ops["rhs"]) if kind.endswith("_packed") else ops["rhs"]
        w = dequantize_weight_kn(PackedTensor(q, ops["rhs_sc"], ops["rhs_zp"],
                                              int(cfg.w_bits), _gsize(cfg, k), cfg.w_sym))
        if kind.startswith("weight_only"):
            a = lhs.float()
        else:
            sc = ops["lhs_sc"]
            g = k // sc.shape[-1]
            a = (lhs.float().reshape(m, -1, g) * sc[..., None]).reshape(m, k)
    out = torch.zeros((m, w.shape[-1]), dtype=torch.float32, device=lhs.device)
    r0 = 0
    for e, size in enumerate(ops["gs"].tolist()):
        out[r0:r0 + size] = a[r0:r0 + size] @ w[e]
        r0 += size
    return out
