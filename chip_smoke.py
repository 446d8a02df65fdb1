"""Chip smoke test of the PyTorch + CUDA port (mxmoe_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card (an H100
for the numbers in PERF.md) and nvcc. Phases, one JSON line each; any
failure raises and the script exits non-zero without a result line:

  1. probe    torch / CUDA / nvcc versions, nvidia-smi's name, power limit
  2. build    compile the kernels (csrc/*.cu, one nvcc per source, started
              together) from this checkout
  3. kernels  each kernel against its plain PyTorch version on the card at
              the serving shapes (qwen2_moe: H 2048, N 1408, E 60, top-4;
              decode M = 4 slots x 4, prefill M = 256 x 4), with its time
              (CUDA events, median of 25, the L2 cache overwritten before
              each timed call) beside the plain version's and
              beside its bound: the larger of the bytes it must move over
              3.35 TB/s and its operations over the card's dense peak.
              K1, K2, K4, K5 bitwise (K4 and K5 also against K2 on the
              unpacked codes, K5 against K4 on an all-packed buffer); K3 and
              K3q caches (codes and scales) bitwise and their output per
              slot within K3_REL_BOUND of the slot's scale (+1 ulp for bf16).
              K8 (without and with zero points) and K9 bitwise, K9 also
              against K8 with one group; K6 and K7 within their accumulation
              bound of a float64 product (gmm_weight_only.error_over_bound),
              K7 bitwise K6 on the unpacked codes; K8 and K6 also with one
              group of rows at the shared expert's shapes.
              Also the sorted combine's time beside the atomic index_add_'s
  4. parity   full-width qwen2_moe, 2 layers, the same params and tokens
              through forward_cached on the CPU (plain versions) and on
              CUDA (kernels): one 256-token prefill chunk + 4 decode steps;
              logits within PARITY_BOUND, greedy tokens equal. The inputs
              are chosen on the CPU run so that every compared position's
              top-2 margin exceeds PARITY_BOUND (no tie decides the gate).
              Run for uniform w8a8 + bf16 cache, mixed-packed + int8 KV
              cache, uniform w4a16_g128_asym nibble-packed, and a flex mix
              (routed w4a4_g128_asym / w8a8_g-1_sym, shared w8a8_g128_asym)
  5. storage  mixed (int8-stored) and mixed-packed params of one seed, 4
              layers, int8 KV cache: prefill + 16 decode steps give bitwise
              equal logits on the card
  6. serve    the Engine answering 4 requests over qwen2_moe with seeded
              random bf16 weights: uniform w8a8 + bf16 cache (4 layers; K1,
              K2, K3), uniform w4a8 nibble-packed (4 layers; K1, K5, K3),
              the full 24 layers with alternating w4a4 / w8a8 experts packed,
              the shared expert w8a8 and the int8 KV cache (K1, K2, K3q,
              K4), the full 24 layers uniform w4a16_g128_asym nibble-packed
              (K7, K3), and 4 layers each of uniform w4a4_g128_sym (K8),
              w8a8_g-1_asym (K1, K9), w4a16_g-1_sym int8-stored (K6) and the
              two flex mixes (K8 with zero points; shared expert through K8
              or K6 with one group). The launch counts are set to 0 before
              each serve and read after it; every kernel named must have
              launched
  7. bench    the bench_serving entry point, 4 layers: mixed-packed + int8 KV
              (K1, K2, K3q, K4 must be non-zero in its own launch counts)
              and --quant w4a16_g128_asym (K6, K3)

Then a {"kernels": [...]} line (each kernel's launches are those of one
serve, named beside them), the nvidia-smi line, and last
{"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

_DA_CU = "mxmoe_tpu_torch/csrc/decode_attention.cu"
_DA_PY = "mxmoe_tpu/serving/decode_attention.py:485"
KERNEL_SOURCES = {
    "quantize_rows": ("mxmoe_tpu_torch/csrc/act_quant.cu",
                      "mxmoe_tpu/ops/act_quant.py:43"),
    "gmm_w8a8": ("mxmoe_tpu_torch/csrc/gmm_w8a8.cu",
                 "mxmoe_tpu/ops/pallas_gmm.py:376"),
    "decode_attention_update_stacked": (_DA_CU, _DA_PY),
    "decode_attention_update_stacked_q8": (_DA_CU, _DA_PY),
    "gmm_mixed_packed": ("mxmoe_tpu_torch/csrc/gmm_mixed_packed.cu",
                         "mxmoe_tpu/ops/pallas_gmm.py:1054"),
    "gmm_w4a8_packed": ("mxmoe_tpu_torch/csrc/gmm_w4a8_packed.cu",
                        "mxmoe_tpu/ops/pallas_gmm.py:599"),
    "gmm_weight_only": ("mxmoe_tpu_torch/csrc/gmm_weight_only.cu",
                        "mxmoe_tpu/ops/pallas_gmm.py:505"),
    "gmm_weight_only_packed": ("mxmoe_tpu_torch/csrc/gmm_weight_only_packed.cu",
                               "mxmoe_tpu/ops/pallas_gmm.py:706"),
    "gmm_w8a8_grouped": ("mxmoe_tpu_torch/csrc/gmm_w8a8_grouped.cu",
                         "mxmoe_tpu/ops/pallas_gmm.py:1332"),
    "gmm_w8a8_asym": ("mxmoe_tpu_torch/csrc/gmm_w8a8_asym.cu",
                      "mxmoe_tpu/ops/pallas_gmm.py:1487"),
}
# the scale group of the grouped schemes on the main path (g128)
GSIZE = 128
# K3 / K3q output bound, held per slot b against that slot's own scale
# max|ref[b]|: |d| <= K3_REL_BOUND * max|ref[b]| for f32 outputs (online
# softmax sums in another order than the plain version's full softmax), plus
# one bf16 ulp of the reference element for bf16 outputs (both round the
# same f32 value once; a value near a rounding boundary may land one ulp
# apart). A dropped or added position moves a long slot's outputs by about
# |v| / length (~5e-4 at 2048 positions), well past both.
K3_REL_BOUND = 1e-5
# parity bound on logits: 4 bf16 ulps at max|logits| of the CPU run, at most
# 0.125 (4 ulps in [4, 8), where the runs' max|logits| ~5.2 lies), and equal
# greedy tokens. The logits are bf16 and the card's bf16 matmuls round at
# other places; runs on an H100 read max|d| = 1 ulp (0.03125)
PARITY_ULPS = 4
PARITY_BOUND = 0.125
# the card's published peaks (H100 SXM, dense): device memory rate and
# operations per second by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
# one PyTorch call that computes the same function, per kernel: none. torch
# has no per-row-bits quantizer, no grouped (per-expert) product over
# expert-sorted rows with int8 or nibble-packed operands, per-group scales,
# zero points or in-product dequantization, and no single call writes the
# cache and attends over it
LIBRARY_MS = None


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def bf16_ulp(x):
    """One bf16 ulp of each element of ``x`` (zero counts as the smallest
    normal)."""
    import torch

    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def k3_slot_errors(out, ref):
    """Per-slot max|d| / max|ref[b]|; raises where the K3 bound fails."""
    import torch

    o, r = out.float(), ref.float()
    d = (o - r).abs()
    scale = r.abs().flatten(1).amax(1).clamp_min(1e-30)
    tol = K3_REL_BOUND * scale[:, None, None]
    if out.dtype == torch.bfloat16:
        tol = tol + bf16_ulp(r)
    rel = d.flatten(1).amax(1) / scale
    if not bool((d <= tol).all()):
        raise AssertionError(f"K3 {out.dtype} output outside its per-slot bound: "
                             f"relative errors per slot {rel.tolist()}")
    return rel.tolist()


_L2_FLUSH = []


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call (CUDA events around each call). A
    buffer larger than the card's 50 MB L2 cache is overwritten before each
    timed call: on the serving path every layer brings its own weights, so a
    kernel finds them in device memory, not in the cache a repeat left."""
    import torch

    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(128 << 20, dtype=torch.int8,
                                     device=torch.device("cuda")))
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        _L2_FLUSH[0].zero_()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def probe() -> str:
    import torch

    from mxmoe_tpu_torch.utils.device import get_cuda_info

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device (torch.cuda.is_available() "
                         "is False); this script measures the card only")
    info = get_cuda_info()
    smi = smi_line()
    emit("probe", python=sys.version.split()[0], torch=info.torch_version,
         torch_cuda=info.torch_cuda, nvcc=info.nvcc, nvcc_version=info.nvcc_version,
         device=info.name, capability=info.capability, count=info.count,
         memory_bytes=info.memory_bytes, nvidia_smi=smi)
    return smi


def build() -> None:
    from mxmoe_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    path = kernels.build()
    kernels.lib()
    emit("build", nvcc_seconds=kernels.build_seconds,
         build_and_load_seconds=time.perf_counter() - t0,
         library=os.path.relpath(path, HERE))


def work_bound(nbytes: float, ops: float, ops_type: str) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[ops_type] * 1e3
    return {"bytes": int(nbytes), "ops": int(ops), "ops_type": ops_type,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def quant_rows_work(m: int, k: int, in_bytes: int) -> dict:
    """K1: the row read once, codes and scale written, ~3 f32 ops a value."""
    return work_bound(m * k * in_bytes + m * 4 + m * k + m * 4, 3 * m * k, "f32")


def gmm_work(gs, k: int, n: int, expert_bytes, out_bytes: int = 2,
             meta_bytes: int = 0, scale_rows: int = 1, lhs_row_bytes=None,
             ops_type: str = "int8") -> dict:
    """A grouped GEMM on THIS routing: only experts with rows stream their
    weights (``expert_bytes[e]``) and their ``scale_rows`` f32 [N] rows of
    scales and zero points (1 per channel; at g128 one or two per 128 codes:
    8 bytes per 128 codes and column with zp); every routed row is read
    (``lhs_row_bytes``: int8 codes and one f32 scale unless given) and
    written once."""
    import torch

    live = gs > 0
    rows = int(gs.sum())
    e = gs.numel()
    w = torch.as_tensor(expert_bytes, device=gs.device).expand(e)
    if lhs_row_bytes is None:
        lhs_row_bytes = k + 4
    nbytes = (rows * lhs_row_bytes + int(w[live].sum())
              + int(live.sum()) * scale_rows * n * 4
              + e * 4 + meta_bytes + rows * n * out_bytes)
    return work_bound(nbytes, 2 * rows * k * n, ops_type)


def decode_attn_work(lengths, valid, s_max, n_h, n_kv, dk, dv, elem_bytes,
                     cache_pos_bytes) -> dict:
    """K3 / K3q on THESE lengths: a slot attends min(len, S-1) + 1 positions,
    all read from the cache except the one it writes (``cache_pos_bytes``
    per kv head and position)."""
    nbytes = ops = 0
    for ln, ok in zip(lengths.tolist(), valid.tolist()):
        n_pos = min(max(ln, 0), s_max - 1) + 1
        wrote = bool(ok) and 0 <= ln < s_max
        nbytes += (n_pos - wrote) * n_kv * cache_pos_bytes        # cache read
        nbytes += wrote * n_kv * cache_pos_bytes                  # cache write
        nbytes += (n_h * dk + n_kv * (dk + dv) + n_h * dv) * elem_bytes
        ops += 2 * n_h * n_pos * (dk + dv)
    return work_bound(nbytes, ops, "bf16")


def _routing_group_sizes(tokens: int, cfg, gen, device):
    import torch

    from mxmoe_tpu_torch.ops.dispatch import make_dispatch, route_topk

    logits = torch.randn((tokens, cfg.num_experts), generator=gen, device=device)
    return make_dispatch(route_topk(logits, cfg.top_k, cfg.norm_topk_prob),
                         cfg.num_experts).group_sizes


def _require_equal(got, ref, what: str) -> None:
    import torch

    if not torch.equal(got, ref):
        d = (got.float() - ref.float()).abs().max().item()
        raise AssertionError(f"{what}: not bitwise, max|d|={d}")


def gmm_kernels_vs_plain(rec: dict) -> None:
    """K1, K2, K4, K5 at the decode and prefill shapes of both expert GEMMs."""
    import torch

    from mxmoe_tpu_torch.models.configs import QWEN2_MOE_A2_7B as cfg
    from mxmoe_tpu_torch.ops import act_quant, gmm_mixed_packed as gmp
    from mxmoe_tpu_torch.ops import gmm_w4a8_packed as g4p, gmm_w8a8 as gmm
    from mxmoe_tpu_torch.quant.packing import build_ragged_mixed, pack_int4_halves

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    h, n, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
    # alternating storage, as the mixed serving config: even experts w4 packed
    pflags = [int(i % 2 == 0) for i in range(e)]
    pf = torch.tensor(pflags, dtype=torch.int32, device=dev)
    pf_all = torch.ones((e,), dtype=torch.int32, device=dev)
    blk_all = torch.arange(e, dtype=torch.int32, device=dev)

    for regime, tokens in (("decode", 4), ("prefill", 256)):
        m = tokens * cfg.top_k
        gs = _routing_group_sizes(tokens, cfg, gen, dev)
        empty = int((gs == 0).sum().item())
        keep = regime == "decode"
        # K1 on both GEMM inputs, with per-row bits as a mixed layer gives them
        for k in (h, n):
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            for label, bits in (("a8", torch.full((m,), 8.0, device=dev)),
                                ("a4/a8", torch.tensor([4.0, 8.0], device=dev)
                                 .repeat(m // 2).contiguous())):
                q, s = act_quant.quantize_rows(x, bits)
                qp, sp = act_quant.quantize_rows_plain(x, bits)
                torch.cuda.synchronize()
                if not (torch.equal(q, qp) and torch.equal(s, sp)):
                    raise AssertionError(
                        f"K1 not bitwise at {regime} K={k} bits {label}: "
                        f"{(q != qp).sum().item()} codes differ")
            t = {"ms": time_ms(lambda: act_quant.quantize_rows(x, bits)),
                 "plain_ms": time_ms(lambda: act_quant.quantize_rows_plain(x, bits)),
                 **quant_rows_work(m, k, 2)}
            emit("kernels", kernel="quantize_rows", regime=regime, M=m, K=k,
                 bitwise=True, **t)
            if keep and k == h:
                rec["quantize_rows"].update(t)
        for k, nn in ((h, 2 * n), (n, h)):
            aq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                               dtype=torch.int8)
            asc = torch.rand((m, 1), generator=gen, device=dev) * 0.05
            wq = torch.randint(-127, 128, (e, k, nn), generator=gen, device=dev,
                               dtype=torch.int8)
            wsc = torch.rand((e, 1, nn), generator=gen, device=dev) * 0.01
            shape = dict(regime=regime, M=m, K=k, N=nn, empty_groups=empty)
            # K2
            out = gmm.gmm_w8a8(aq, asc, wq, wsc, gs)
            ref = gmm.gmm_w8a8_plain(aq, asc, wq, wsc, gs)
            torch.cuda.synchronize()
            _require_equal(out, ref, f"K2 vs plain at {regime} K={k}")
            t = {"ms": time_ms(lambda: gmm.gmm_w8a8(aq, asc, wq, wsc, gs)),
                 "plain_ms": time_ms(lambda: gmm.gmm_w8a8_plain(aq, asc, wq, wsc, gs)),
                 **gmm_work(gs, k, nn, k * nn)}
            emit("kernels", kernel="gmm_w8a8", bitwise=True, **shape, **t)
            if keep and k == h:
                rec["gmm_w8a8"].update(t)
            # K4: the packed experts' codes in the 4-bit range; K2 on the
            # same int8-stored codes is the second reference
            w4 = torch.randint(-8, 8, (e, k, nn), generator=gen, device=dev,
                               dtype=torch.int8)
            wq[::2] = w4[::2]
            cat, blk = build_ragged_mixed(wq, pflags)
            blk = torch.tensor(blk, dtype=torch.int32, device=dev)
            out = gmp.gmm_mixed_packed(aq, asc, cat, wsc, gs, pf, blk)
            ref = gmp.gmm_mixed_packed_plain(aq, asc, cat, wsc, gs, pf, blk)
            k2 = gmm.gmm_w8a8(aq, asc, wq, wsc, gs)
            torch.cuda.synchronize()
            _require_equal(out, ref, f"K4 vs plain at {regime} K={k}")
            _require_equal(out, k2, f"K4 vs K2 at {regime} K={k}")
            per_expert = [k * nn // 2 if f else k * nn for f in pflags]
            t = {"ms": time_ms(lambda: gmp.gmm_mixed_packed(aq, asc, cat, wsc, gs,
                                                            pf, blk)),
                 "plain_ms": time_ms(lambda: gmp.gmm_mixed_packed_plain(
                     aq, asc, cat, wsc, gs, pf, blk)),
                 **gmm_work(gs, k, nn, per_expert, meta_bytes=8 * e)}
            emit("kernels", kernel="gmm_mixed_packed", bitwise=True,
                 equals_gmm_w8a8=True, packed_experts=sum(pflags),
                 gmm_w8a8_same_codes_ms=time_ms(
                     lambda: gmm.gmm_w8a8(aq, asc, wq, wsc, gs)), **shape, **t)
            if keep and k == h:
                rec["gmm_mixed_packed"].update(t)
            del cat, wq
            # K5: every expert packed; K4 on the same bytes and K2 on the
            # unpacked codes are the other references
            packed = pack_int4_halves(w4)
            out = g4p.gmm_w4a8_packed(aq, asc, packed, wsc, gs)
            ref = g4p.gmm_w4a8_packed_plain(aq, asc, packed, wsc, gs)
            k4 = gmp.gmm_mixed_packed(aq, asc, packed.reshape(-1, nn), wsc, gs,
                                      pf_all, blk_all)
            k2 = gmm.gmm_w8a8(aq, asc, w4, wsc, gs)
            torch.cuda.synchronize()
            _require_equal(out, ref, f"K5 vs plain at {regime} K={k}")
            _require_equal(out, k4, f"K5 vs K4 at {regime} K={k}")
            _require_equal(out, k2, f"K5 vs K2 at {regime} K={k}")
            t = {"ms": time_ms(lambda: g4p.gmm_w4a8_packed(aq, asc, packed, wsc, gs)),
                 "plain_ms": time_ms(lambda: g4p.gmm_w4a8_packed_plain(
                     aq, asc, packed, wsc, gs)),
                 **gmm_work(gs, k, nn, k * nn // 2)}
            emit("kernels", kernel="gmm_w4a8_packed", bitwise=True,
                 equals_gmm_mixed_packed=True, equals_gmm_w8a8=True, **shape, **t)
            if keep and k == h:
                rec["gmm_w4a8_packed"].update(t)
            del packed, w4

    # the real-quantized shared expert: K1 with one bit width expanded over
    # the rows, then K2 with one group, for each of its two dense products
    sn = cfg.shared_expert_intermediate_size
    a8 = torch.tensor(8.0, device=dev)
    for regime, rows in (("decode", 4), ("prefill", 256)):
        one_group = torch.full((1,), rows, dtype=torch.int32, device=dev)
        for k, nn in ((h, 2 * sn), (sn, h)):
            x = torch.randn((rows, k), generator=gen, device=dev).to(torch.bfloat16)
            bits = a8.expand(rows)
            q, s = act_quant.quantize_rows(x, bits)
            qp, sp = act_quant.quantize_rows_plain(x, bits)
            torch.cuda.synchronize()
            _require_equal(q, qp, f"K1 codes (shared expert) at {regime} K={k}")
            _require_equal(s, sp, f"K1 scales (shared expert) at {regime} K={k}")
            emit("kernels", kernel="quantize_rows",
                 use="shared expert, expanded bits", regime=regime, M=rows, K=k,
                 bitwise=True,
                 ms=time_ms(lambda: act_quant.quantize_rows(x, bits)),
                 plain_ms=time_ms(lambda: act_quant.quantize_rows_plain(x, bits)),
                 **quant_rows_work(rows, k, 2))
            aq = torch.randint(-127, 128, (rows, k), generator=gen, device=dev,
                               dtype=torch.int8)
            asc = torch.rand((rows, 1), generator=gen, device=dev) * 0.05
            wq = torch.randint(-127, 128, (1, k, nn), generator=gen, device=dev,
                               dtype=torch.int8)
            wsc = torch.rand((1, 1, nn), generator=gen, device=dev) * 0.01
            out = gmm.gmm_w8a8(aq, asc, wq, wsc, one_group)
            ref = gmm.gmm_w8a8_plain(aq, asc, wq, wsc, one_group)
            torch.cuda.synchronize()
            _require_equal(out, ref, f"K2 (shared expert) at {regime} K={k}")
            emit("kernels", kernel="gmm_w8a8", use="shared expert, one group",
                 regime=regime, M=rows, K=k, N=nn, bitwise=True,
                 ms=time_ms(lambda: gmm.gmm_w8a8(aq, asc, wq, wsc, one_group)),
                 plain_ms=time_ms(lambda: gmm.gmm_w8a8_plain(aq, asc, wq, wsc,
                                                             one_group)),
                 **gmm_work(one_group, k, nn, k * nn))


def scheme_kernels_vs_plain(rec: dict) -> None:
    """K6-K9 at the decode and prefill shapes of both expert GEMMs and, with
    one group of rows, at the shared expert's shapes. K8 and K9 bitwise
    against their plain versions; K6 and K7 within
    ``gmm_weight_only.error_over_bound`` of the float64 product of the same
    bf16 weights (f32 accumulation over K terms in any order, + 1 bf16 ulp of
    the output), K7 bitwise K6 on the unpacked codes."""
    import torch

    from mxmoe_tpu_torch.models.configs import QWEN2_MOE_A2_7B as cfg
    from mxmoe_tpu_torch.ops import gmm_w8a8 as gmm, gmm_w8a8_asym as gasym
    from mxmoe_tpu_torch.ops import gmm_w8a8_grouped as ggrp
    from mxmoe_tpu_torch.ops import gmm_weight_only as gwo
    from mxmoe_tpu_torch.ops import gmm_weight_only_packed as gwop
    from mxmoe_tpu_torch.quant.packing import pack_int4_halves

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    h, n, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
    sn = cfg.shared_expert_intermediate_size

    def rand(shape, scale, shift=0.0):
        return torch.rand(shape, generator=gen, device=dev) * scale + shift

    def codes(shape, hi):
        return torch.randint(-hi, hi, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def timed(kernel, plain, work):
        return {"ms": time_ms(kernel), "plain_ms": time_ms(plain, reps=5, warmup=1),
                **work}

    def int8_kernels(gs, m, k, nn, shape, keep, shared):
        """K9 (routed shapes only) and K8 without / with rhs_zp."""
        ne, g = gs.numel(), k // GSIZE
        aq = codes((m, k), 128).clamp_(min=-127)
        wq = codes((ne, k, nn), 128).clamp_(min=-127)
        if not shared:
            asc, wsc = rand((m, 1), 0.05, 1e-3), rand((ne, 1, nn), 0.01, 1e-4)
            wzp = torch.randn((ne, 1, nn), generator=gen, device=dev) * 0.02
            out = gasym.gmm_w8a8_asym(aq, asc, wq, wsc, wzp, gs)
            ref = gasym.gmm_w8a8_asym_plain(aq, asc, wq, wsc, wzp, gs)
            k8 = ggrp.gmm_w8a8_grouped(aq, asc, wq, wsc, gs, gsize=-1, rhs_zp=wzp)
            torch.cuda.synchronize()
            _require_equal(out, ref, f"K9 vs plain at {shape}")
            _require_equal(out, k8, f"K9 vs K8 with one group at {shape}")
            t = timed(lambda: gasym.gmm_w8a8_asym(aq, asc, wq, wsc, wzp, gs),
                      lambda: gasym.gmm_w8a8_asym_plain(aq, asc, wq, wsc, wzp, gs),
                      gmm_work(gs, k, nn, k * nn, scale_rows=2))
            emit("kernels", kernel="gmm_w8a8_asym", bitwise=True,
                 equals_gmm_w8a8_grouped_one_group=True,
                 gmm_w8a8_same_codes_ms=time_ms(
                     lambda: gmm.gmm_w8a8(aq, asc, wq, wsc, gs)), **shape, **t)
            if keep:
                rec["gmm_w8a8_asym"].update(t)
        asc, wsc = rand((m, g), 0.05, 1e-3), rand((ne, g, nn), 0.01, 1e-4)
        wzp = torch.randn((ne, g, nn), generator=gen, device=dev) * 0.02
        for zp in (None, wzp):
            out = ggrp.gmm_w8a8_grouped(aq, asc, wq, wsc, gs, GSIZE, zp)
            ref = ggrp.gmm_w8a8_grouped_plain(aq, asc, wq, wsc, gs, GSIZE, zp)
            torch.cuda.synchronize()
            _require_equal(out, ref, f"K8 vs plain at {shape} zp={zp is not None}")
            t = timed(lambda: ggrp.gmm_w8a8_grouped(aq, asc, wq, wsc, gs, GSIZE, zp),
                      lambda: ggrp.gmm_w8a8_grouped_plain(aq, asc, wq, wsc, gs,
                                                          GSIZE, zp),
                      gmm_work(gs, k, nn, k * nn, lhs_row_bytes=k + 4 * g,
                               scale_rows=g * (1 if zp is None else 2)))
            emit("kernels", kernel="gmm_w8a8_grouped", bitwise=True, gsize=GSIZE,
                 rhs_zp=zp is not None, **shape, **t)
            if keep and zp is None:
                rec["gmm_w8a8_grouped"].update(t)

    def weight_only_kernels(gs, m, k, nn, shape, keep, shared, gsize=GSIZE):
        """K6 and (routed shapes only) K7, 4-bit codes, scale and zp per group."""
        ne, g = gs.numel(), (1 if gsize == -1 else k // gsize)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w4 = codes((ne, k, nn), 8)
        sc = rand((ne, g, nn), 0.02, 1e-3)
        zp = torch.randn((ne, g, nn), generator=gen, device=dev) * 0.05
        out = gwo.gmm_weight_only(x, w4, sc, zp, gs, gsize)
        torch.cuda.synchronize()
        err, ratio = gwo.error_over_bound(out, x, w4, sc, zp, gs, gsize)
        if not ratio <= 1.0:
            raise AssertionError(f"K6 outside its bound at {shape}: max|d|={err}, "
                                 f"{ratio} of the tolerance")
        scales = dict(scale_rows=2 * g, lhs_row_bytes=2 * k, ops_type="bf16")
        t = timed(lambda: gwo.gmm_weight_only(x, w4, sc, zp, gs, gsize),
                  lambda: gwo.gmm_weight_only_plain(x, w4, sc, zp, gs, gsize),
                  gmm_work(gs, k, nn, k * nn, **scales))
        emit("kernels", kernel="gmm_weight_only", gsize=gsize, max_abs_err=err,
             err_over_bound=ratio,
             bound="K * 2^-24 * sum|lhs||w| + 1 bf16 ulp, vs float64", **shape, **t)
        if keep:
            rec["gmm_weight_only"].update(max_abs_err=err, **t)
        if shared or gsize == -1:
            return
        packed = pack_int4_halves(w4)
        out_p = gwop.gmm_weight_only_packed(x, packed, sc, zp, gs, gsize)
        torch.cuda.synchronize()
        _require_equal(out_p, out, f"K7 vs K6 at {shape}")
        t = timed(lambda: gwop.gmm_weight_only_packed(x, packed, sc, zp, gs, gsize),
                  lambda: gwop.gmm_weight_only_packed_plain(x, packed, sc, zp, gs,
                                                            gsize),
                  gmm_work(gs, k, nn, k * nn // 2, **scales))
        emit("kernels", kernel="gmm_weight_only_packed", gsize=gsize,
             equals_gmm_weight_only=True, max_abs_err=err, err_over_bound=ratio,
             **shape, **t)
        if keep:
            rec["gmm_weight_only_packed"].update(max_abs_err=err, **t)

    for regime, tokens in (("decode", 4), ("prefill", 256)):
        m = tokens * cfg.top_k
        gs = _routing_group_sizes(tokens, cfg, gen, dev)
        for k, nn in ((h, 2 * n), (n, h)):
            shape = dict(regime=regime, M=m, K=k, N=nn,
                         empty_groups=int((gs == 0).sum().item()))
            keep = regime == "decode" and k == h
            int8_kernels(gs, m, k, nn, shape, keep, shared=False)
            weight_only_kernels(gs, m, k, nn, shape, keep, shared=False)
            if regime == "decode":      # the per-channel a16 serve's K6
                weight_only_kernels(gs, m, k, nn, shape, False, False, gsize=-1)
    # the grouped / asymmetric and the weight-only shared expert: one group
    for regime, rows in (("decode", 4), ("prefill", 256)):
        one_group = torch.full((1,), rows, dtype=torch.int32, device=dev)
        for k, nn in ((h, 2 * sn), (sn, h)):
            shape = dict(use="shared expert, one group", regime=regime, M=rows,
                         K=k, N=nn)
            int8_kernels(one_group, rows, k, nn, shape, False, shared=True)
            weight_only_kernels(one_group, rows, k, nn, shape, False, shared=True)


def combine_vs_index_add() -> None:
    """What the order-preserving combine costs: ``combine_tokens`` (sorted
    ``index_put_(accumulate=True)``) beside the atomic ``index_add_`` it
    replaced, on the same rows, at the decode and prefill sizes."""
    import torch

    from mxmoe_tpu_torch.models.configs import QWEN2_MOE_A2_7B as cfg
    from mxmoe_tpu_torch.ops.dispatch import (combine_tokens, make_dispatch,
                                              route_topk)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    for regime, tokens in (("decode", 4), ("prefill", 256)):
        logits = torch.randn((tokens, cfg.num_experts), generator=gen, device=dev)
        disp = make_dispatch(route_topk(logits, cfg.top_k, cfg.norm_topk_prob),
                             cfg.num_experts)
        rows = torch.randn((tokens * cfg.top_k, cfg.hidden_size), generator=gen,
                           device=dev).to(torch.bfloat16)
        weighted = rows * disp.combine_weights[:, None].to(rows.dtype)
        idx = disp.token_ids.long()

        def zeros():
            return torch.zeros((tokens, cfg.hidden_size), dtype=rows.dtype,
                               device=dev)

        def atomic():
            return zeros().index_add_(0, idx, weighted)

        def sorted_put():
            return zeros().index_put_((idx,), weighted, accumulate=True)

        out = combine_tokens(rows, disp, tokens)
        again = combine_tokens(rows, disp, tokens)
        torch.cuda.synchronize()
        _require_equal(out, again, f"combine_tokens twice at {regime}")
        err = (out.float() - atomic().float()).abs().max().item()
        emit("combine", regime=regime, tokens=tokens, rows=tokens * cfg.top_k,
             reproducible=True, max_abs_diff_vs_index_add=err,
             index_put_ms=time_ms(sorted_put), index_add_ms=time_ms(atomic))


def attention_kernels_vs_plain(rec: dict) -> None:
    """K3 and K3q at the serving cache: B=4 slots, S=2048; lengths 0, mid,
    full, and a slot with valid=0; bf16 operands (the serving path's) and
    f32 ones."""
    import torch

    from mxmoe_tpu_torch.models.configs import QWEN2_MOE_A2_7B as cfg
    from mxmoe_tpu_torch.serving import decode_attention as da

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    b, s_max, nl, layer = 4, 2048, 2, 1
    n_h, n_kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = 1.0 / hd ** 0.5
    lengths = torch.tensor([0, 700, s_max, 1500], dtype=torch.int32, device=dev)
    valid = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device=dev)

    def bf16_cache():
        return torch.randn((nl, b, n_kv, s_max, hd), generator=gen,
                           device=dev).to(torch.bfloat16)

    def int8_codes():
        return torch.randint(-127, 128, (nl, b, n_kv, s_max, hd), generator=gen,
                             device=dev, dtype=torch.int8)

    def f32_scales():
        return torch.rand((nl, b, n_kv, s_max), generator=gen, device=dev) * 0.03 + 1e-3

    forms = (
        ("decode_attention_update_stacked", "K3",
         lambda: [bf16_cache(), None, bf16_cache(), None], 2 * hd * 2),
        ("decode_attention_update_stacked_q8", "K3q",
         lambda: [int8_codes(), f32_scales(), int8_codes(), f32_scales()],
         2 * hd + 8),
    )
    for name, label, make_caches, pos_bytes in forms:
        for dtype in (torch.float32, torch.bfloat16):
            caches = make_caches()
            caches2 = [c if c is None else c.clone() for c in caches]
            q = torch.randn((b, n_h, hd), generator=gen, device=dev).to(dtype)
            kn = torch.randn((b, n_kv, hd), generator=gen, device=dev).to(dtype)
            vn = torch.randn((b, n_kv, hd), generator=gen, device=dev).to(dtype)

            def kernel():
                return da.decode_attention_update_stacked(
                    q, kn, vn, *caches, lengths, layer, valid=valid)[0]

            def plain():
                if caches2[1] is None:
                    return da.decode_attention_update_plain(
                        q, kn, vn, caches2[0], caches2[2], lengths, layer, valid,
                        scale)
                return da.decode_attention_update_q8_plain(
                    q, kn, vn, *caches2, lengths, layer, valid, scale)

            out, ref = kernel(), plain()
            torch.cuda.synchronize()
            for got, want in zip(caches, caches2):
                if got is not None and not torch.equal(got, want):
                    raise AssertionError(f"{label} cache write not bitwise ({dtype})")
            rel = k3_slot_errors(out, ref)
            err = (out.float() - ref.float()).abs().max().item()
            t = {"ms": time_ms(kernel), "plain_ms": time_ms(plain),
                 **decode_attn_work(lengths, valid, s_max, n_h, n_kv, hd, hd,
                                    q.element_size(), pos_bytes)}
            emit("kernels", kernel=name, regime="decode",
                 dtype=str(dtype).removeprefix("torch."), B=b, S=s_max,
                 lengths=lengths.tolist(), valid=valid.tolist(), cache_bitwise=True,
                 max_abs_err=err, rel_err_per_slot=rel,
                 slot_scale=ref.float().abs().flatten(1).amax(1).tolist(),
                 bound=f"{K3_REL_BOUND} * max|ref[b]|"
                       + (" + 1 bf16 ulp" if dtype == torch.bfloat16 else ""), **t)
            if dtype == torch.bfloat16:
                rec[name].update(max_abs_err=err, **t)
            del caches, caches2


def kernels_vs_plain() -> dict:
    """Each kernel vs its plain version; returns per-kernel records."""
    rec = {name: {"max_abs_err": 0.0} for name in KERNEL_SOURCES}
    gmm_kernels_vs_plain(rec)
    scheme_kernels_vs_plain(rec)
    attention_kernels_vs_plain(rec)
    combine_vs_index_add()
    return rec


def _to(params, device):
    return {k: (_to(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in params.items()}


def _top2_margin(logits):
    """Per-row gap between the two largest logits ([.., V] -> [..])."""
    top2 = logits.float().topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def _full_width_model(layers: int, seed: int):
    """qwen2_moe at its published widths, ``layers`` deep, with seeded random
    bf16 weights made on the card -> (config, float params)."""
    import torch

    from mxmoe_tpu_torch.models.configs import QWEN2_MOE_A2_7B
    from mxmoe_tpu_torch.models.model import init_params

    cfg = dataclasses.replace(QWEN2_MOE_A2_7B, num_layers=layers)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    floats = init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    return cfg, floats


def _init_cache(cfg, batch, max_len, int8_kv, device):
    from mxmoe_tpu_torch.serving.kv_cache import init_kv_cache, init_quant_kv_cache

    if int8_kv:
        return init_quant_kv_cache(cfg, batch, max_len, device=device)
    return init_kv_cache(cfg, batch, max_len, device=device)


# flex per-expert mixes, int8-stored: routed experts alternate a grouped
# asymmetric w4a4 scheme with per-channel w8a8 (K8 with zero points); the
# name picks the shared expert's scheme: grouped asymmetric w x a (K8 with
# one group) or weight-only in every layer (K6 with one group)
FLEX_ROUTED = ("w4a4_g128_asym", "w8a8_g-1_sym")
FLEX_SHARED = {"flex-shared-grouped": "w8a8_g128_asym",
               "flex-shared-a16": "w4a16_g128_asym"}


def flex_mixed_config(num_layers: int, num_experts: int, shared_scheme: str):
    from mxmoe_tpu_torch.quant.schemes import (QLayerConfig, QModelConfig,
                                               build_uniform_expert, parse_scheme)

    experts = {str(i): build_uniform_expert(parse_scheme(FLEX_ROUTED[i % 2]))
               for i in range(num_experts)}
    experts[str(num_experts)] = build_uniform_expert(parse_scheme(shared_scheme))
    return QModelConfig(layers={str(l): QLayerConfig(experts=dict(experts))
                                for l in range(num_layers)})


def prepare(floats: dict, cfg, quant: str, pack: bool = False):
    """Float params -> (quantized params, MoEImpl). ``quant``: what
    ``bench_serving --quant`` takes, or a ``FLEX_SHARED`` name; ``pack``
    nibble-packs a uniform scheme's codes (convert's pack step)."""
    from mxmoe_tpu_torch.models.convert import pack_int4_experts
    from mxmoe_tpu_torch.models.layers import MoEImpl
    from mxmoe_tpu_torch.quant.qparams import quantize_model_experts_mixed
    from mxmoe_tpu_torch.serving.bench_serving import quantize_for_serving

    if quant in FLEX_SHARED:
        qmc = flex_mixed_config(cfg.num_layers, cfg.num_experts, FLEX_SHARED[quant])
        params, impl = quantize_model_experts_mixed(floats, cfg, qmc), MoEImpl("mixed")
    else:
        params, impl = quantize_for_serving(floats, cfg, quant)
    if pack:
        params = pack_int4_experts(params, impl.quant)
    return params, impl


def slice_parity(quant: str, int8_kv: bool, pack: bool = False,
                 tries: int = 40) -> None:
    """2-layer full-width slice on the CPU (plain versions), then the same
    inputs on CUDA (kernels). The CPU run picks its inputs: a prompt, then
    for each decode step one input token per slot, such that every compared
    position's top-2 margin exceeds PARITY_BOUND."""
    import numpy as np
    import torch

    from mxmoe_tpu_torch.serving.decode import forward_cached

    cfg, floats = _full_width_model(2, seed=1)
    params, impl = prepare(floats, cfg, quant, pack)
    del floats
    cpu_params = _to(params, "cpu")
    rng = np.random.default_rng(1)
    b, chunk, steps = 2, 256, 4
    valid0 = np.asarray([chunk, 200], np.int32)
    rows = np.arange(b)

    # CPU: search the inputs. A retried forward writes the same cache
    # positions again (the cache argument keeps its lengths), so a rejected
    # try leaves nothing behind.
    cache = _init_cache(cfg, b, 512, int8_kv, "cpu")
    t0 = time.perf_counter()
    for n_prompts in range(1, tries + 1):
        prompt = rng.integers(0, cfg.vocab_size, (b, chunk)).astype(np.int32)
        lg, nxt = forward_cached(cpu_params, torch.from_numpy(prompt), cache, cfg,
                                 impl, valid_lengths=torch.from_numpy(valid0))
        last = lg.float()[rows, valid0 - 1]
        if bool((_top2_margin(last) > PARITY_BOUND).all()):
            break
    else:
        raise AssertionError(f"parity: no prompt in {tries} gave a top-2 margin "
                             f"> {PARITY_BOUND}")
    prefill_s_cpu = (time.perf_counter() - t0) / n_prompts
    cache, cpu_logits, fed, n_tries = nxt, [last], [], []
    for _ in range(steps):
        greedy = cpu_logits[-1].argmax(-1)
        chosen = greedy.clone()
        done = torch.zeros((b,), dtype=torch.bool)
        for j in range(tries):
            cand = torch.where(done, chosen, (greedy + j) % cfg.vocab_size)
            lg, nxt = forward_cached(cpu_params, cand.to(torch.int32)[:, None],
                                     cache, cfg, impl)
            ok = _top2_margin(lg[:, 0]) > PARITY_BOUND
            if bool(ok.all()):
                break
            chosen = torch.where(ok & ~done, cand, chosen)
            done |= ok
        else:
            raise AssertionError(f"parity: no decode input in {tries} gave a "
                                 f"top-2 margin > {PARITY_BOUND}")
        cache = nxt
        fed.append(cand.to(torch.int32))
        cpu_logits.append(lg.float()[:, 0])
        n_tries.append(j + 1)

    # CUDA: replay the chosen inputs
    dev = torch.device("cuda")
    cache = _init_cache(cfg, b, 512, int8_kv, dev)
    t0 = time.perf_counter()
    lg, cache = forward_cached(params, torch.as_tensor(prompt, device=dev), cache,
                               cfg, impl,
                               valid_lengths=torch.as_tensor(valid0, device=dev))
    gpu_logits = [lg.float().cpu()[rows, valid0 - 1]]
    prefill_s_cuda = time.perf_counter() - t0
    for toks in fed:
        lg, cache = forward_cached(params, toks.to(dev)[:, None], cache, cfg, impl)
        gpu_logits.append(lg.float().cpu()[:, 0])

    cpu = torch.stack(cpu_logits)             # [1 + steps, B, V]
    gpu = torch.stack(gpu_logits)
    if not (torch.isfinite(gpu).all() and gpu.shape == (1 + steps, b, cfg.vocab_size)):
        raise AssertionError("non-finite or misshapen CUDA logits")
    err = (gpu - cpu).abs().max().item()
    bound = min(PARITY_BOUND, PARITY_ULPS * bf16_ulp(cpu.abs().max()).item())
    margin = _top2_margin(cpu).min().item()
    tok_cpu, tok_gpu = cpu.argmax(-1), gpu.argmax(-1)
    equal = tok_cpu == tok_gpu
    emit("parity", quant=quant, packed=pack, int8_kv=int8_kv, layers=cfg.num_layers,
         prefill_valid=valid0.tolist(), decode_steps=steps, max_abs_err=err,
         bound=bound, max_abs_logit=cpu.abs().max().item(),
         greedy_equal=int(equal.sum()), greedy_total=equal.numel(),
         min_top2_margin=margin, prompts_tried=n_prompts, decode_inputs_tried=n_tries,
         tokens_cpu=tok_cpu.tolist(), tokens_cuda=tok_gpu.tolist(),
         prefill_s_cuda=prefill_s_cuda, prefill_s_cpu=prefill_s_cpu)
    if not margin > PARITY_BOUND:
        raise AssertionError(f"slice parity: top-2 margin {margin} <= {PARITY_BOUND}")
    if not err <= bound:
        raise AssertionError(f"slice parity: max|d logits|={err} > {bound}")
    if not bool(equal.all()):
        raise AssertionError("slice parity: greedy tokens differ")


def storage_forms_bitwise() -> None:
    """Packing w4 experts changes bytes, not outputs: int8-stored and
    nibble-packed params of one seed give bitwise equal logits on the card."""
    import numpy as np
    import torch

    from mxmoe_tpu_torch.serving.bench_serving import quantize_for_serving
    from mxmoe_tpu_torch.serving.decode import forward_cached

    cfg, floats = _full_width_model(4, seed=2)
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    b, chunk, steps = 2, 256, 16
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, chunk)).astype(np.int32),
                             device=dev)
    valid0 = torch.tensor([chunk, 200], dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)
    logits, fed = {}, []
    for quant in ("mixed", "mixed-packed"):
        params, impl = quantize_for_serving(floats, cfg, quant)
        cache = _init_cache(cfg, b, 512, True, dev)
        lg, cache = forward_cached(params, prompt, cache, cfg, impl,
                                   valid_lengths=valid0)
        out = [lg[rows, (valid0 - 1).long()]]
        for i in range(steps):
            if quant == "mixed":              # the first form's greedy tokens
                fed.append(out[-1].argmax(-1).to(torch.int32)[:, None])
            lg, cache = forward_cached(params, fed[i], cache, cfg, impl)
            out.append(lg[:, 0])
        logits[quant] = torch.stack(out)
        del params, cache
    torch.cuda.synchronize()
    same = torch.equal(logits["mixed"], logits["mixed-packed"])
    emit("storage", layers=cfg.num_layers, prefill_valid=valid0.tolist(),
         decode_steps=steps, int8_kv=True, bitwise_equal=same,
         max_abs_diff=(logits["mixed"].float()
                       - logits["mixed-packed"].float()).abs().max().item(),
         finite=bool(torch.isfinite(logits["mixed"]).all()))
    if not (same and torch.isfinite(logits["mixed"]).all()):
        raise AssertionError("mixed and mixed-packed logits differ on the card")


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _reckoned_bytes(cfg, quant: str, pack: bool, int8_kv: bool, slots: int,
                    max_len: int) -> dict:
    """Expert, shared-expert and KV-cache bytes as the storage code lays them
    out (codes, f32 scales per channel or per group of GSIZE codes, zero
    points where the form keeps them, the per-expert markers), to print
    beside the measured tensor sizes."""
    from mxmoe_tpu_torch.quant.schemes import parse_scheme

    h, n, e, nl = (cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts,
                   cfg.num_layers)
    sn = cfg.shared_expert_intermediate_size
    codes = h * 2 * n + n * h                       # one expert, 1 byte a code
    shared_codes = h * 2 * sn + sn * h
    shared_bf16 = nl * shared_codes * 2

    def scale_bytes(width, grouped):
        """One f32 array of scales (or zero points) for an expert of ``width``."""
        g_h, g_n = (h // GSIZE, width // GSIZE) if grouped else (1, 1)
        return (g_h * 2 * width + g_n * h) * 4

    if quant == "mixed-packed":                     # even experts packed
        packed = (e + 1) // 2
        experts = nl * (packed * codes // 2 + (e - packed) * codes
                        + e * scale_bytes(n, False)
                        + 2 * e * 8 + 2 * e * 4)    # + blk/pf, act bits
        shared = nl * (shared_codes + scale_bytes(sn, False) + 8)
    elif quant in FLEX_SHARED:      # scales and zp per group; act bits, gsize
        experts = nl * e * (codes + 2 * scale_bytes(n, True) + 2 * 4
                            + (h // GSIZE + n // GSIZE) * 4)
        a16 = parse_scheme(FLEX_SHARED[quant]).a_bits >= 16
        shared = nl * (shared_codes + 2 * scale_bytes(sn, True) + 8 + 4 * a16)
    else:                           # uniform: codes, scales and zp
        grouped = parse_scheme(quant).w_gsize != -1
        experts = nl * e * (codes // (2 if pack else 1)
                            + 2 * scale_bytes(n, grouped))
        shared = shared_bf16
    pos = 2 * cfg.head_dim * (1 if int8_kv else 2) + (8 if int8_kv else 0)
    return {"experts": experts, "shared_expert": shared,
            "kv_cache": nl * slots * cfg.num_kv_heads * max_len * pos}


def serve(layers: int, quant: str, int8_kv: bool, expect: tuple,
          pack: bool = False) -> dict:
    """The Engine over qwen2_moe at its published widths, ``layers`` deep,
    answering 4 requests; returns the kernels' launch counts of this serve.
    ``quant`` and ``pack`` as ``prepare`` takes them."""
    import numpy as np
    import torch

    from mxmoe_tpu_torch.ops import kernels
    from mxmoe_tpu_torch.serving.engine import Engine, EngineConfig

    t0 = time.perf_counter()
    cfg, floats = _full_width_model(layers, seed=0)
    params, impl = prepare(floats, cfg, quant, pack)
    del floats
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    nbytes = {"experts": 0, "shared_expert": 0, "other": 0}
    for k, v in params["layers"].items():
        key = ("experts" if k.startswith(("expert_", "act_bits_g", "act_bits_d",
                                          "act_gsize_"))
               else "shared_expert" if k.startswith(("shared_gate_up", "shared_down",
                                                     "act_bits_shared", "shared_wo"))
               else "other")
        nbytes[key] += _tensor_bytes([v])
    nbytes["other"] += _tensor_bytes(params[k] for k in ("embed", "final_norm", "lm_head"))
    slots, max_len, max_new = 4, 2048, 32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(params, cfg, EngineConfig(batch_slots=slots, max_len=max_len,
                                           prefill_chunk=256, int8_kv=int8_kv), impl)
    nbytes["kv_cache"] = _tensor_bytes(
        getattr(eng.cache, f.name) for f in dataclasses.fields(eng.cache)
        if f.name != "lengths")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (48, 200, 300, 512)]

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = eng.run_to_completion(chunk=16)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = dict(kernels.launches)

    toks = [results[r] for r in rids]
    decoded = sum(len(t) - 1 for t in toks)     # the first token comes from prefill
    emit("serve", layers=cfg.num_layers, quant=quant, packed=pack, int8_kv=int8_kv,
         requests=len(prompts), prompt_lens=[len(p) for p in prompts],
         max_new=max_new, tokens=toks, init_s=t_init, prefill_ms=t_prefill * 1e3,
         decode_s=t_decode, decode_tok_s=decoded / t_decode,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         measured_bytes=nbytes,
         reckoned_bytes=_reckoned_bytes(cfg, quant, pack, int8_kv, slots, max_len),
         launches=launches)
    if any(len(t) != max_new or not all(0 <= x < cfg.vocab_size for x in t)
           for t in toks):
        raise AssertionError("serve: a request came back short or out of vocab")
    missing = [k for k in expect if launches[k] <= 0]
    if missing:
        raise AssertionError(f"serve ({quant}): kernels never launched on the "
                             f"main path: {missing}")
    return launches


def bench_entry_point(quant_args: list, expect: tuple) -> None:
    """The bench_serving entry point as a user calls it, at a small depth;
    its launch counts are set to 0 before the call and read after it."""
    from mxmoe_tpu_torch.ops import kernels
    from mxmoe_tpu_torch.serving import bench_serving

    kernels.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench_serving.main(["--layers", "4", "--slots", "4", "--max-len", "1024",
                            "--prefill", "256", *quant_args])
    launches = dict(kernels.launches)
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    emit("bench", **res, launches=launches)
    missing = [k for k in expect if launches[k] <= 0]
    if missing:
        raise AssertionError(f"bench_serving {quant_args}: kernels never "
                             f"launched: {missing}")
    keys = {"model", "layers", "slots", "quant", "int8_head", "int8_kv",
            "prefill_ms", "prefill_tokens_per_s", "decode_attn", "decode_step_ms",
            "decode_tokens_per_s", "device"}
    if not (keys <= set(res) and res["decode_tokens_per_s"] > 0
            and res["prefill_ms"] > 0
            and res["int8_kv"] is ("--int8-kv" in quant_args)):
        raise AssertionError(f"bench_serving: unexpected result {res}")


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "mxmoe_tpu_torch")):
        print("chip_smoke.py: mxmoe_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    smi = probe()
    build()
    rec = kernels_vs_plain()
    for quant, int8_kv, pack in (("w8a8_g-1_sym", False, False),
                                 ("mixed-packed", True, False),
                                 ("w4a16_g128_asym", False, True),
                                 ("flex-shared-grouped", False, False)):
        torch.cuda.empty_cache()
        slice_parity(quant, int8_kv, pack)
    torch.cuda.empty_cache()
    storage_forms_bitwise()
    k1, k3, k3q = ("quantize_rows", "decode_attention_update_stacked",
                   "decode_attention_update_stacked_q8")
    # (layers, quant, int8 KV, packed, kernels that must launch); a kernel's
    # launches in the last line are those of the first serve that lists it
    # under `counts` below
    serves = {
        "uniform": (4, "w8a8_g-1_sym", False, False, (k1, "gmm_w8a8", k3)),
        "packed_w4": (4, "w4a8_g-1_sym", False, True, (k1, "gmm_w4a8_packed", k3)),
        "mixed": (24, "mixed-packed", True, False,
                  (k1, "gmm_w8a8", k3q, "gmm_mixed_packed")),
        "a16_packed": (24, "w4a16_g128_asym", False, True,
                       ("gmm_weight_only_packed", k3)),
        "grouped": (4, "w4a4_g128_sym", False, False, ("gmm_w8a8_grouped", k3)),
        "asym": (4, "w8a8_g-1_asym", False, False, (k1, "gmm_w8a8_asym", k3)),
        "a16": (4, "w4a16_g-1_sym", False, False, ("gmm_weight_only", k3)),
        "flex": (4, "flex-shared-grouped", False, False, ("gmm_w8a8_grouped", k3)),
        "flex_a16": (4, "flex-shared-a16", False, False,
                     ("gmm_w8a8_grouped", "gmm_weight_only", k3)),
    }
    ran = {}
    for name, (layers, quant, int8_kv, pack, expect) in serves.items():
        torch.cuda.empty_cache()
        ran[name] = serve(layers, quant, int8_kv, expect, pack)
    # the flex serves go through K8 only: no K1, K2 or K9 for the routed
    # experts, and the grouped shared expert adds two K8 launches a layer
    if ran["flex"]["gmm_w8a8_grouped"] != 2 * ran["grouped"]["gmm_w8a8_grouped"]:
        raise AssertionError("the grouped shared expert did not go through K8: "
                             f"{ran['flex']} against {ran['grouped']}")
    torch.cuda.empty_cache()
    bench_entry_point(["--quant", "mixed-packed", "--int8-kv"],
                      (k1, "gmm_w8a8", "gmm_mixed_packed", k3q))
    torch.cuda.empty_cache()
    bench_entry_point(["--quant", "w4a16_g128_asym"], ("gmm_weight_only", k3))
    # one path per number: a kernel's launches are those of the full-depth
    # serve that runs it, else of the 4-layer serve that does
    counts = {"mixed": (k1, "gmm_w8a8", k3q, "gmm_mixed_packed"),
              "uniform": (k3,), "packed_w4": ("gmm_w4a8_packed",),
              "a16_packed": ("gmm_weight_only_packed",),
              "grouped": ("gmm_w8a8_grouped",), "asym": ("gmm_w8a8_asym",),
              "a16": ("gmm_weight_only",)}
    launches = {}
    for name, kernel_names in counts.items():
        layers, quant, int8_kv, pack, _ = serves[name]
        label = (f"serve {quant}{' packed' if pack else ''}"
                 f"{' int8-kv' if int8_kv else ''} {layers} layers")
        for kn in kernel_names:
            launches[kn] = (ran[name][kn], label)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name][0], "launches_of": launches[name][1],
         "max_abs_err": rec[name]["max_abs_err"],
         "ms": rec[name]["ms"], "plain_ms": rec[name]["plain_ms"],
         "bound_ms": rec[name]["bound_ms"], "bound_by": rec[name]["bound_by"],
         "library_ms": LIBRARY_MS}
        for name, (src, rep) in KERNEL_SOURCES.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
