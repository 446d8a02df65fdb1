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
              each timed call) and device time (device_ms: the summed
              durations of the kernels the call launched, torch.profiler,
              median of 25) beside the plain version's and
              beside its bound: the larger of the bytes it must move over
              3.35 TB/s and its operations over the card's dense peak.
              First the redesigned bodies at the edges of their schedules:
              K2, K4, K5 and K9 at M 1, 4, 16, 17, 24, 64, 65, 256, routed
              (two empty groups) and as one group (split-K), bitwise their
              plain versions and K4 = K5 = K2 on the same codes; K8 and K4f
              (the grouped-scale GEMM's two schedules: the m16 ring kernel
              with split-K at whole groups up to M 64, the 32-row tile above)
              on the same rows at g128 with zero points, bitwise their plain
              versions and K4f = K8 (K 1408: a group spans the packed
              halves); K6, K7 and K10 (the weight-only GEMM's two schedules,
              one for the three: the m16 ring body with split-K over
              byte-tile pairs up to M 64, the 32-row tile above) on the same
              rows at g128 with zero points and per channel, K6 within its
              bound, K7 = K6 and K10's weight-only rows = K6 bitwise, its
              w x a rows = K8 / K2 bitwise; K3 / K3q at
              lengths on the warp-chunk and S-block edges, G 1 / 4 / 7, the
              write bitwise, the read-only form bitwise K3 / K3q after it.
              K1, K2, K4, K5 bitwise (K4 and K5 also against K2 on the
              unpacked codes, K5 against K4 on an all-packed buffer); K3 and
              K3q caches (codes and scales) bitwise and their output per
              slot within K3_REL_BOUND of the slot's scale (+1 ulp for bf16).
              K8 (without and with zero points) and K9 bitwise, K9 also
              against K8 with one group; K6 and K7 within their accumulation
              bound of a float64 product (gmm_weight_only.error_over_bound),
              K7 bitwise K6 on the unpacked codes; K8 and K6 also with one
              group of rows at the shared expert's shapes; each K6 / K7 /
              K10 line prints the schedule it ran (bm 16 at decode).
              K4f (the flex form of gmm_mixed_packed) bitwise its plain
              version and bitwise K8 on the unpacked codes, without and with a
              group that spans the two halves of K, without and with zero
              points; K10 (gmm_mixed_wo_wxa, both bodies; flags alternating,
              all 0, all 1): w x a experts bitwise K8 / K2 and the plain
              version, weight-only experts bitwise K6 and within K6's bound;
              K11 (gmm_bf16) within gmm.error_over_bound of a float64 product,
              timed beside the stock torch._grouped_mm (its library_ms); the
              int8 lm_head's product (K1, K2 with one group, N 151936) bitwise.
              Also the sorted combine's time beside the atomic index_add_'s.
              K12 (gmm_ffn_w8a8) over the aligned dispatch, decode and
              prefill: bitwise its plain version, within the reference's
              bounds of the two-launch path (timed beside it) and, on the
              reference test's set-up, within 2e-4 of the f32 oracle; K13
              (gmm_ffn_mixed_packed) bitwise its plain version and K12 on the
              equivalent codes (no expert, every other, every expert packed);
              K14 (gmm_w8a8_fusedquant) bitwise its plain version and K1 + K2;
              K15 (gmm_ws) at the headline workload's shapes bitwise K2 / K5.
              The read-only decode attention (decode_attention_stacked bf16 /
              int8, decode_attention, decode_attention_q8) at K3's serving
              cache, at the qwen2_moe shape and at ds2's MLA shape (dk 256
              with its zero tail, dv 128, scale 1/sqrt(192)): within
              K3_REL_BOUND per slot of the plain versions, the stacked forms
              bitwise K3 / K3q after their write of the same step, the
              per-layer forms bitwise the stacked ones; the bf16 forms timed
              beside scaled_dot_product_attention
  4. parity   full-width qwen2_moe, 2 layers, the same params and tokens
              through forward_cached on the CPU (plain versions) and on
              CUDA (kernels): one 256-token prefill chunk + 4 decode steps;
              logits within PARITY_BOUND, greedy tokens equal. The inputs
              are chosen on the CPU run so that every compared position's
              top-2 margin exceeds PARITY_BOUND (no tie decides the gate).
              Run for uniform w8a8 + bf16 cache, mixed-packed + int8 KV
              cache, uniform w4a16_g128_asym nibble-packed, a flex mix
              (routed w4a4_g128_asym / w8a8_g-1_sym, shared w8a8_g128_asym),
              flex-wo (routed w4a16_g128_asym / w8a8_g-1_sym through K10),
              flex-packed (routed w4a4_g128_asym nibble-packed / w8a8_g-1_sym
              through K4f), bf16 experts through K11, and with the whole FFN
              in one launch: mixed-packed + int8 KV (K13), uniform w8a8 (K12),
              and uniform w8a8 over the aligned dispatch unfused (K2). Then
              full-width ds2, 3 layers (the dense first layer and two MoE
              layers), mixed-packed + int8 KV (MLA through K3q at dk 256).
              On the card, forward_logits over a 256-token prompt against a
              one-chunk forward_cached prefill into a bf16 cache, within the
              parity bound, for qwen2_moe (2 layers) and ds2 (3 layers),
              mixed-packed
  5. storage  mixed (int8-stored) and mixed-packed params of one seed, 4
              layers, int8 KV cache: prefill + 16 decode steps give bitwise
              equal logits on the card; the same for the flex mix int8-stored
              (K8) and packed (K4f), and for mixed / mixed-packed with the
              fused FFN (K12 / K13). Then the float path's two arms, K11 and
              the stock grouped product, on one 4-layer model: logits within
              the parity bound of each other
  6. serve    the Engine answering 4 requests over qwen2_moe with seeded
              random bf16 weights, 4 layers each: uniform w8a8 + bf16 cache
              (K1, K2, K3), uniform w4a8 nibble-packed (K1, K5, K3),
              alternating w4a4 / w8a8 experts packed with the shared expert
              w8a8 and the int8 KV cache (K1, K2, K3q, K4), uniform
              w4a16_g128_asym nibble-packed (K7, K3), uniform w4a4_g128_sym
              (K8), w8a8_g-1_asym (K1, K9), w4a16_g-1_sym int8-stored (K6),
              the two flex mixes (K8 with zero points; shared expert through
              K8 or K6 with one group), flex-wo (K10), flex-packed with the
              int8 KV cache (K4f, K3q), the per-channel weight-only mix
              (K10's other body), bf16 experts through K11 and through the
              stock arm, uniform w8a8 with the int8 lm_head; with the fused
              FFN: uniform w8a8 (K12, no K2), "auto" (K12 at decode and at the
              256-token prefill chunks), the aligned dispatch unfused (K2, no
              K12) and the flex mix (no K12 / K13: the guard falls through).
              At the full 24 layers: mixed-packed + int8 KV with the fused
              FFN (K13, K1, K3q; shared expert K2; no K4). decode_attn="xla"
              on uniform w8a8 (no K3). ds2 at the full 27 layers, mixed-packed
              + int8 KV + int8 head (K3q, K1, K4, K2), mixtral and
              qwen2_moe_57b at full width, 4 layers, uniform w8a8 (K1, K2,
              K3 at G 4 / 7). Each serve prints its peak memory beside the
              bytes reckoned from the config. The launch counts are
              set to 0 before each serve and read after it; every kernel
              named must have launched
  7. bench    the bench_serving entry point, 4 layers: mixed-packed + int8 KV
              (K1, K2, K3q, K4 must be non-zero in its own launch counts),
              --quant w4a16_g128_asym (K6, K3), --quant none (K3),
              --quant w8a8_g-1_sym --int8-head (K1, K2, K3), mixed-packed
              + int8 KV --fused-ffn on (K13, K1, K2, K3q), and --model ds2
              mixed-packed + int8 KV with --decode-attn auto (K3q) and xla
              (no K3 / K3q)
  8. headline bench/headline.py (the counterpart of bench.py) in the
              process: the mixed one-launch and bucketed arms' outputs (K15)
              bitwise their --no-ws arms' (K2; K5 + K2), then both arms as
              the entry point runs them, each printing its JSON line; K15
              must launch

Then a {"kernels": [...]} line (each kernel's launches are those of one
serve or run, named beside them; K14 and the read-only decode attention are
reached by no serve in either package), the nvidia-smi line, and last
{"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

_DA_CU = "mxmoe_tpu_torch/csrc/decode_attention.cu"
_DA_Q8_CU = "mxmoe_tpu_torch/csrc/decode_attention_q8.cu"
_DA_PY = "mxmoe_tpu/serving/decode_attention.py:485"
KERNEL_SOURCES = {
    "quantize_rows": ("mxmoe_tpu_torch/csrc/act_quant.cu",
                      "mxmoe_tpu/ops/act_quant.py:43"),
    "gmm_w8a8": ("mxmoe_tpu_torch/csrc/gmm_w8a8.cu",
                 "mxmoe_tpu/ops/pallas_gmm.py:376"),
    "decode_attention_update_stacked": (_DA_CU, _DA_PY),
    "decode_attention_update_stacked_q8": (_DA_Q8_CU, _DA_PY),
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
    # K4f, the flex form of gmm_mixed_packed: a kernel and a launch count of
    # its own, in K4's source
    "gmm_mixed_packed_flex": ("mxmoe_tpu_torch/csrc/gmm_mixed_packed.cu",
                              "mxmoe_tpu/ops/pallas_gmm.py:930"),
    "gmm_mixed_wo_wxa": ("mxmoe_tpu_torch/csrc/gmm_mixed_wo_wxa.cu",
                         "mxmoe_tpu/ops/pallas_gmm.py:1631"),
    "gmm_bf16": ("mxmoe_tpu_torch/csrc/gmm_bf16.cu",
                 "mxmoe_tpu/ops/pallas_gmm.py:271"),
    "gmm_ffn_w8a8": ("mxmoe_tpu_torch/csrc/gmm_ffn_w8a8.cu",
                     "mxmoe_tpu/ops/pallas_gmm.py:2081"),
    "gmm_ffn_mixed_packed": ("mxmoe_tpu_torch/csrc/gmm_ffn_mixed_packed.cu",
                             "mxmoe_tpu/ops/pallas_gmm.py:2300"),
    "gmm_w8a8_fusedquant": ("mxmoe_tpu_torch/csrc/gmm_w8a8_fusedquant.cu",
                            "mxmoe_tpu/ops/pallas_gmm.py:1752"),
    "gmm_ws": ("mxmoe_tpu_torch/csrc/gmm_ws.cu", "mxmoe_tpu/ops/pallas_gmm.py:1906"),
    # the read-only decode attention: K3 / K3q's bodies without the write
    "decode_attention_stacked": (_DA_CU, "mxmoe_tpu/serving/decode_attention.py:593"),
    "decode_attention_stacked_q8": (_DA_Q8_CU,
                                    "mxmoe_tpu/serving/decode_attention.py:593"),
    "decode_attention": (_DA_CU, "mxmoe_tpu/serving/decode_attention.py:688"),
    "decode_attention_q8": (_DA_Q8_CU, "mxmoe_tpu/serving/decode_attention.py:749"),
}
READ_ONLY_ATTENTION = ("decode_attention_stacked", "decode_attention_stacked_q8",
                       "decode_attention", "decode_attention_q8")
# a serve's optional fields: MoEImpl fields, kernels that must not launch, model
SERVE_DEFAULTS = (None, (), "qwen2_moe")
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
# one PyTorch call that computes the same function, per kernel: K11
# (gmm_bf16) has one, the stock grouped product ``torch._grouped_mm`` that
# ``ops.gmm.gmm``'s "ragged_dot" arm takes; its time is measured beside K11's.
# The bf16 read-only decode attention (decode_attention_stacked,
# decode_attention) has ``scaled_dot_product_attention`` with a boolean
# [B, 1, 1, S] length mask and ``enable_gqa``, timed beside them (used nowhere
# in the port); its int8 forms have none (no library call takes per-position
# scales). For the others there is none (``library_ms`` null): torch has no per-row-bits
# quantizer, no grouped (per-expert) product over expert-sorted rows with int8
# or nibble-packed operands, per-group scales, zero points or in-product
# dequantization, and no single call writes the cache and attends over it;
# none quantizes activations inside a product (K14), runs a whole FFN with an
# in-product requant (K12, K13), or schedules a grouped int8 product (K15)


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


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median time of one call between CUDA events, the L2 cache overwritten
    before each (``bench.timing.event_ms``)."""
    from mxmoe_tpu_torch.bench.timing import event_ms

    return event_ms(fn, reps, warmup)


def device_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call: the summed durations of the kernels it
    launched (torch.profiler; ``bench.timing.device_ms``)."""
    from mxmoe_tpu_torch.bench.timing import device_ms as dev_ms

    return dev_ms(fn, reps, warmup)


def kernel_times(fn, reps: int = 25, warmup: int = 3) -> dict:
    """A kernel row's two readings: ``ms`` (CUDA events around the call,
    host work of the wrapper included) and ``device_ms``."""
    return {"ms": time_ms(fn, reps, warmup), "device_ms": device_ms(fn, reps, warmup)}


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


def _grouped_schedule(m: int, k: int, n: int, e: int) -> dict:
    """The grouped-scale GEMM's schedule (K8, K4f) at g128, for the log."""
    from mxmoe_tpu_torch.ops.gmm_w8a8_grouped import grouped_gmm_schedule

    s = grouped_gmm_schedule(m, k, n, e, GSIZE)
    return {"bm": s.bm, "grid_m": s.grid_m, "splits": s.splits,
            "k_tiles_per_split": s.k_tiles_per_split}


def _wo_schedule(m: int, k: int, n: int, e: int, gsize: int = GSIZE) -> dict:
    """The weight-only GEMMs' schedule (K6, K7, K10), for the log."""
    from mxmoe_tpu_torch.ops.gmm_w8a8_grouped import weight_only_gmm_schedule

    s = weight_only_gmm_schedule(m, k, n, e, k if gsize == -1 else gsize)
    return {"bm": s.bm, "grid_m": s.grid_m, "splits": s.splits,
            "k_tiles_per_split": s.k_tiles_per_split}


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
            t = {**kernel_times(lambda: act_quant.quantize_rows(x, bits)),
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
            t = {**kernel_times(lambda: gmm.gmm_w8a8(aq, asc, wq, wsc, gs)),
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
            t = {**kernel_times(lambda: gmp.gmm_mixed_packed(aq, asc, cat, wsc, gs,
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
            t = {**kernel_times(lambda: g4p.gmm_w4a8_packed(aq, asc, packed, wsc, gs)),
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
                 **kernel_times(lambda: act_quant.quantize_rows(x, bits)),
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
                 **kernel_times(lambda: gmm.gmm_w8a8(aq, asc, wq, wsc, one_group)),
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
        return {**kernel_times(kernel), "plain_ms": time_ms(plain, reps=5, warmup=1),
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
                 rhs_zp=zp is not None, schedule=_grouped_schedule(m, k, nn, ne),
                 **shape, **t)
            if keep and zp is None:
                rec["gmm_w8a8_grouped"].update(t, schedule=_grouped_schedule(m, k, nn,
                                                                            ne))

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
        sched = _wo_schedule(m, k, nn, ne, gsize)
        emit("kernels", kernel="gmm_weight_only", gsize=gsize, max_abs_err=err,
             err_over_bound=ratio, schedule=sched,
             bound="K * 2^-24 * sum|lhs||w| + 1 bf16 ulp, vs float64", **shape, **t)
        if keep:
            rec["gmm_weight_only"].update(max_abs_err=err, schedule=sched, **t)
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
             schedule=sched, **shape, **t)
        if keep:
            rec["gmm_weight_only_packed"].update(max_abs_err=err, schedule=sched, **t)

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


def mixed_wo_wxa_work(gs, flags, k: int, n: int, groups: int, zp: bool) -> dict:
    """K10 on THIS routing and THESE flags: every routed expert streams its
    int8 codes and its scale (and zp) rows; a weight-only expert's rows are
    read as bf16 and multiplied at the bf16 rate, a w x a expert's as int8
    codes with ``groups`` f32 scales at the int8 rate."""
    live = gs > 0
    rows_wo = int(gs[flags.bool()].sum())
    rows_wxa = int(gs.sum()) - rows_wo
    e = gs.numel()
    nbytes = (int(live.sum()) * (k * n + groups * n * 4 * (2 if zp else 1))
              + rows_wo * 2 * k + rows_wxa * (k + 4 * groups) + 2 * e * 4
              + (rows_wo + rows_wxa) * n * 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (2 * rows_wo * k * n / PEAK_OPS_PER_S["bf16"]
             + 2 * rows_wxa * k * n / PEAK_OPS_PER_S["int8"]) * 1e3
    return {"bytes": int(nbytes), "ops": 2 * (rows_wo + rows_wxa) * k * n,
            "ops_type": "bf16 + int8", "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def two_launch_kernels_vs_plain(rec: dict) -> None:
    """K4f, K10 (both bodies) and K11 at the decode and prefill shapes of both
    expert GEMMs. K4f bitwise its plain version and bitwise K8 on the unpacked
    codes (gate_up without a straddling group, down with one; without and with
    zero points; at decode also a layer with no packed expert and one with all
    packed). K10: w x a experts bitwise K8 (flex body) or K2 (per-channel
    body) and bitwise the plain version, weight-only experts bitwise K6 on
    the same codes and within ``gmm_weight_only.error_over_bound``; flags
    alternating (timed), all 0 and all 1. K11 within ``gmm.error_over_bound``
    of the float64 product, timed beside the stock ``torch._grouped_mm``. Then
    the int8 lm_head's product (K1 + K2 with one group, N = vocab) bitwise,
    timed beside the bf16 head's matmul."""
    import torch

    from mxmoe_tpu_torch.models.configs import QWEN2_MOE_A2_7B as cfg
    from mxmoe_tpu_torch.ops import act_quant, gmm as gfl, gmm_mixed_packed as gmp
    from mxmoe_tpu_torch.ops import gmm_mixed_wo_wxa as gmx, gmm_w8a8 as gmm
    from mxmoe_tpu_torch.ops import gmm_w8a8_grouped as ggrp
    from mxmoe_tpu_torch.ops import gmm_weight_only as gwo
    from mxmoe_tpu_torch.quant.packing import build_ragged_mixed

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    h, n, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts

    def rand(shape, scale, shift=0.0):
        return torch.rand(shape, generator=gen, device=dev) * scale + shift

    def codes(shape, hi):
        return torch.randint(-hi, hi, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def timed(kernel, plain, work):
        return {**kernel_times(kernel), "plain_ms": time_ms(plain, reps=5, warmup=1),
                **work}

    alternating = [int(i % 2 == 0) for i in range(e)]

    def flex_packed(gs, m, k, nn, shape, keep, storages):
        g = k // GSIZE
        aq = codes((m, k), 128).clamp_(min=-127)
        asc, wsc = rand((m, g), 0.05, 1e-3), rand((e, g, nn), 0.01, 1e-4)
        wzp = torch.randn((e, g, nn), generator=gen, device=dev) * 0.02
        w8, w4 = codes((e, k, nn), 128).clamp_(min=-127), codes((e, k, nn), 8)
        for label, pflags in storages:
            pfb = torch.tensor(pflags, dtype=torch.bool, device=dev)
            wq = torch.where(pfb[:, None, None], w4, w8)
            cat, blk = build_ragged_mixed(wq, pflags)
            pf = pfb.to(torch.int32)
            blk = torch.tensor(blk, dtype=torch.int32, device=dev)
            for zp in (None, wzp):
                out = gmp.gmm_mixed_packed(aq, asc, cat, wsc, gs, pf, blk, rhs_zp=zp)
                ref = gmp.gmm_mixed_packed_plain(aq, asc, cat, wsc, gs, pf, blk,
                                                 rhs_zp=zp)
                k8 = ggrp.gmm_w8a8_grouped(aq, asc, wq, wsc, gs, GSIZE, zp)
                torch.cuda.synchronize()
                what = f"{label} at {shape} zp={zp is not None}"
                _require_equal(out, ref, f"K4f vs plain, {what}")
                _require_equal(out, k8, f"K4f vs K8, {what}")
                per_expert = [k * nn // 2 if f else k * nn for f in pflags]
                t = timed(lambda: gmp.gmm_mixed_packed(aq, asc, cat, wsc, gs, pf, blk,
                                                       rhs_zp=zp),
                          lambda: gmp.gmm_mixed_packed_plain(aq, asc, cat, wsc, gs,
                                                             pf, blk, rhs_zp=zp),
                          gmm_work(gs, k, nn, per_expert, meta_bytes=8 * e,
                                   lhs_row_bytes=k + 4 * g,
                                   scale_rows=g * (1 if zp is None else 2)))
                emit("kernels", kernel="gmm_mixed_packed_flex", storage=label,
                     bitwise=True, equals_gmm_w8a8_grouped=True, gsize=GSIZE,
                     straddling_group=(k // 2) % GSIZE != 0, rhs_zp=zp is not None,
                     packed_experts=sum(pflags),
                     schedule=_grouped_schedule(m, k, nn, e),
                     gmm_w8a8_grouped_same_codes_ms=time_ms(
                         lambda: ggrp.gmm_w8a8_grouped(aq, asc, wq, wsc, gs, GSIZE, zp)),
                     **shape, **t)
                if keep and label == "alternating" and zp is not None:
                    rec["gmm_mixed_packed_flex"].update(
                        t, schedule=_grouped_schedule(m, k, nn, e))
            del cat, wq

    def wo_wxa(gs, m, k, nn, shape, keep, gsize, with_zp, mixes):
        g = 1 if gsize == -1 else k // gsize
        body = "per-channel" if gsize == -1 else "flex"
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        aq = codes((m, k), 128).clamp_(min=-127)
        asc = rand((m, g), 0.05, 1e-3)
        w4 = codes((e, k, nn), 8)
        wsc = rand((e, g, nn), 0.02, 1e-3)
        wzp = torch.randn((e, g, nn), generator=gen, device=dev) * 0.05
        zp = wzp if with_zp else None
        zp6 = wzp if with_zp else torch.zeros_like(wsc)
        k8 = ggrp.gmm_w8a8_grouped(aq, asc, w4, wsc, gs, gsize, zp)
        k6 = gwo.gmm_weight_only(x, w4, wsc, zp6, gs, gsize)
        k2 = gmm.gmm_w8a8(aq, asc, w4, wsc, gs) if body == "per-channel" else None
        for label, fl in mixes:
            flags = torch.tensor(fl, dtype=torch.int32, device=dev)
            out = gmx.gmm_mixed_wo_wxa(x, aq, asc, w4, wsc, flags, gs, rhs_zp=zp)
            ref = gmx.gmm_mixed_wo_wxa_plain(x, aq, asc, w4, wsc, flags, gs, rhs_zp=zp)
            torch.cuda.synchronize()
            wo = torch.repeat_interleave(flags, gs.long()).bool()
            what = f"{body} body, flags {label}, at {shape}"
            _require_equal(out[~wo], k8[~wo], f"K10 w x a rows vs K8, {what}")
            _require_equal(out[~wo], ref[~wo], f"K10 w x a rows vs plain, {what}")
            if k2 is not None:
                _require_equal(out[~wo], k2[~wo], f"K10 w x a rows vs K2, {what}")
            _require_equal(out[wo], k6[wo], f"K10 weight-only rows vs K6, {what}")
            err, ratio = 0.0, 0.0
            if bool(wo.any()):
                rows = torch.nonzero(wo)[:, 0]
                err, ratio = gwo.error_over_bound(
                    out[rows].contiguous(), x[rows].contiguous(), w4, wsc, zp6,
                    torch.where(flags.bool(), gs, torch.zeros_like(gs)), gsize)
                if not ratio <= 1.0:
                    raise AssertionError(f"K10 weight-only rows outside their bound, "
                                         f"{what}: max|d|={err}, {ratio} of it")
            t = timed(lambda: gmx.gmm_mixed_wo_wxa(x, aq, asc, w4, wsc, flags, gs,
                                                   rhs_zp=zp),
                      lambda: gmx.gmm_mixed_wo_wxa_plain(x, aq, asc, w4, wsc, flags,
                                                         gs, rhs_zp=zp),
                      mixed_wo_wxa_work(gs, flags, k, nn, g, with_zp))
            sched = _wo_schedule(m, k, nn, e, gsize)
            emit("kernels", kernel="gmm_mixed_wo_wxa", body=body, flags=label,
                 schedule=sched, weight_only_experts=sum(fl), wxa_rows_bitwise=True,
                 wo_rows_equal_gmm_weight_only=True, max_abs_err=err,
                 err_over_bound=ratio, gsize=gsize, rhs_zp=with_zp,
                 gmm_w8a8_grouped_same_codes_ms=time_ms(
                     lambda: ggrp.gmm_w8a8_grouped(aq, asc, w4, wsc, gs, gsize, zp)),
                 gmm_weight_only_same_codes_ms=time_ms(
                     lambda: gwo.gmm_weight_only(x, w4, wsc, zp6, gs, gsize)),
                 **shape, **t)
            if keep and body == "flex" and label == "alternating":
                rec["gmm_mixed_wo_wxa"].update(max_abs_err=err, schedule=sched, **t)

    def float_gmm(gs, m, k, nn, shape, keep):
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((e, k, nn), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        out = gfl.gmm_bf16(x, w, gs)
        lib = gfl.gmm(x, w, gs, backend="ragged_dot")
        torch.cuda.synchronize()
        err, ratio = gfl.error_over_bound(out, x, w, gs)
        lib_err, lib_ratio = gfl.error_over_bound(lib, x, w, gs)
        if not ratio <= 1.0:
            raise AssertionError(f"K11 outside its bound at {shape}: max|d|={err}, "
                                 f"{ratio} of the tolerance")
        t = timed(lambda: gfl.gmm_bf16(x, w, gs),
                  lambda: gfl.gmm_bf16_plain(x, w, gs),
                  gmm_work(gs, k, nn, 2 * k * nn, scale_rows=0, lhs_row_bytes=2 * k,
                           ops_type="bf16"))
        t["library_ms"] = time_ms(lambda: gfl.gmm(x, w, gs, backend="ragged_dot"))
        t["library_device_ms"] = device_ms(lambda: gfl.gmm(x, w, gs,
                                                           backend="ragged_dot"))
        emit("kernels", kernel="gmm_bf16", max_abs_err=err, err_over_bound=ratio,
             bound="(K + 1) * 2^-24 * sum|lhs||rhs| + 1 bf16 ulp, vs float64",
             library="torch._grouped_mm" if gfl.has_grouped_mm() else "masked products",
             library_max_abs_err=lib_err, library_err_over_bound=lib_ratio,
             **shape, **t)
        if keep:
            rec["gmm_bf16"].update(max_abs_err=err, **t)

    all0, all1 = [0] * e, [1] * e
    for regime, tokens in (("decode", 4), ("prefill", 256)):
        m = tokens * cfg.top_k
        gs = _routing_group_sizes(tokens, cfg, gen, dev)
        decode = regime == "decode"
        for k, nn in ((h, 2 * n), (n, h)):
            shape = dict(regime=regime, M=m, K=k, N=nn,
                         empty_groups=int((gs == 0).sum().item()))
            keep = decode and k == h
            storages = [("alternating", alternating)]
            if keep:
                storages += [("none packed", all0), ("all packed", all1)]
            flex_packed(gs, m, k, nn, shape, keep, storages)
            mixes = [("alternating", alternating)]
            if decode:
                mixes += [("all w x a", all0), ("all weight-only", all1)]
            wo_wxa(gs, m, k, nn, shape, keep, GSIZE, True, mixes)
            wo_wxa(gs, m, k, nn, shape, keep, -1, False, mixes)
            float_gmm(gs, m, k, nn, shape, keep)

    # the int8 lm_head: K1 + K2 with one group over the whole vocabulary
    v = cfg.vocab_size
    wq = codes((1, h, v), 128).clamp_(min=-127)
    wsc = rand((1, 1, v), 0.001, 1e-5)
    wbf = (wq[0].float() * wsc[0]).to(torch.bfloat16)
    for rows in (4, 256):
        x = torch.randn((rows, h), generator=gen, device=dev).to(torch.bfloat16)
        one_group = torch.full((1,), rows, dtype=torch.int32, device=dev)
        aq, asc = act_quant.quantize_rows_uniform(x, 8)
        out = gmm.gmm_w8a8(aq, asc, wq, wsc, one_group)
        ref = gmm.gmm_w8a8_plain(aq, asc, wq, wsc, one_group)
        torch.cuda.synchronize()
        _require_equal(out, ref, f"K2 (int8 lm_head) at M={rows}")
        emit("kernels", kernel="gmm_w8a8", use="int8 lm_head, one group", M=rows,
             K=h, N=v, bitwise=True,
             **kernel_times(lambda: gmm.gmm_w8a8(aq, asc, wq, wsc, one_group)),
             plain_ms=time_ms(lambda: gmm.gmm_w8a8_plain(aq, asc, wq, wsc, one_group),
                              reps=5, warmup=1),
             quantize_rows_ms=time_ms(lambda: act_quant.quantize_rows_uniform(x, 8)),
             bf16_head_matmul_ms=time_ms(lambda: x @ wbf),
             **gmm_work(one_group, h, v, h * v))


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
            t = {**kernel_times(kernel), "plain_ms": time_ms(plain),
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


def read_attn_work(lengths, s_max, n_h, n_kv, dk, dv, elem_bytes,
                   cache_pos_bytes) -> dict:
    """The read-only decode attention on THESE lengths: a slot reads
    min(len, S-1) + 1 cached positions (``cache_pos_bytes`` per kv head and
    position, K and V and any scales), q in and the output out; nothing is
    written to the cache."""
    nbytes = ops = 0
    for ln in lengths.tolist():
        n_pos = min(max(ln, 0), s_max - 1) + 1
        nbytes += n_pos * n_kv * cache_pos_bytes + n_h * (dk + dv) * elem_bytes
        ops += 2 * n_h * n_pos * (dk + dv)
    return work_bound(nbytes, ops, "bf16")


def read_only_attention_vs_plain(rec: dict) -> None:
    """decode_attention_stacked (bf16 / int8 cache), decode_attention and
    decode_attention_q8 at K3's serving cache (B 4, S 2048, lengths 0, 700,
    S, 1500; bf16 q), at two shapes: qwen2_moe (n_h = n_kv = 16, dk = dv =
    128) and ds2's MLA (n_h = n_kv = 16, dk 256 whose last 64 lanes are the
    zero padding, dv 128, scale 1/sqrt(192)). Each form within K3_REL_BOUND
    per slot (+ 1 bf16 ulp) of its plain version; the stacked forms run on the
    cache K3 / K3q has just written for the same step with the same q, and
    equal K3 / K3q's output bitwise (one body: K3 takes the new position from
    shared memory, the read-only form from the cache it was written to); the
    per-layer forms equal the stacked one on that layer bitwise. The bf16
    forms are timed beside ``scaled_dot_product_attention`` (boolean length
    mask, ``enable_gqa``). The ds2 shape's numbers go to the kernels line."""
    import torch
    import torch.nn.functional as F

    from mxmoe_tpu_torch.serving import decode_attention as da

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    b, s_max, nl, layer = 4, 2048, 2, 1
    lengths = torch.tensor([0, 700, s_max, 1500], dtype=torch.int32, device=dev)
    valid = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device=dev)
    pos = torch.arange(s_max, device=dev)
    mask = (pos[None, :] <= lengths.clamp(max=s_max - 1)[:, None])[:, None, None, :]
    shapes = {"qwen2_moe": (16, 16, 128, 128, 128),
              "ds2_mla": (16, 16, 256, 128, 192)}    # n_h, n_kv, dk, dv, qk dim
    for shape, (n_h, n_kv, dk, dv, d_qk) in shapes.items():
        scale = 1.0 / d_qk ** 0.5

        def zero_tail(t):                  # MLA: the padded lanes hold zeros
            t[..., d_qk:] = 0
            return t

        def randn(*shape_):
            return torch.randn(shape_, generator=gen, device=dev).to(torch.bfloat16)

        def codes(d):
            return torch.randint(-127, 128, (nl, b, n_kv, s_max, d), generator=gen,
                                 device=dev, dtype=torch.int8)

        def scales():
            return torch.rand((nl, b, n_kv, s_max), generator=gen, device=dev) * 0.03 + 1e-3

        q = zero_tail(randn(b, n_h, dk))
        kn, vn = zero_tail(randn(b, n_kv, dk)), randn(b, n_kv, dv)
        for quant in (False, True):
            if quant:
                caches = [zero_tail(codes(dk)), scales(), codes(dv), scales()]
                pos_bytes = dk + dv + 8
            else:
                caches = [zero_tail(randn(nl, b, n_kv, s_max, dk)), None,
                          randn(nl, b, n_kv, s_max, dv), None]
                pos_bytes = 2 * (dk + dv)
            upd, _ = da.decode_attention_update_stacked(q, kn, vn, *caches, lengths,
                                                        layer, valid=valid,
                                                        scale=scale)
            layer_caches = [c if c is None else c[layer] for c in caches]
            stacked_name = "decode_attention_stacked" + ("_q8" if quant else "")
            per_layer_name = "decode_attention_q8" if quant else "decode_attention"

            def stacked():
                return da.decode_attention_stacked(q, *caches, lengths, layer,
                                                   scale=scale)[0]

            def stacked_plain():
                return da.decode_attention_stacked_plain(q, *caches, lengths, layer,
                                                         scale)

            if quant:
                def per_layer():
                    return da.decode_attention_q8(q, *layer_caches, lengths,
                                                  scale=scale)
            else:
                def per_layer():
                    return da.decode_attention(q, layer_caches[0], layer_caches[2],
                                               lengths, scale=scale)

            out, ref, out_l = stacked(), stacked_plain(), per_layer()
            torch.cuda.synchronize()
            bitwise_update = torch.equal(out, upd)
            bitwise_layer = torch.equal(out_l, out)
            lib = {}
            if not quant:
                kk, vv = layer_caches[0], layer_caches[2]

                def library():
                    return F.scaled_dot_product_attention(
                        q[:, :, None, :], kk, vv, attn_mask=mask, scale=scale,
                        enable_gqa=n_h != n_kv)

                lib = {"library_ms": time_ms(library),
                       "library_device_ms": device_ms(library),
                       "library_max_abs_diff": (library()[:, :, 0].float()
                                                - ref.float()).abs().max().item()}
            work = read_attn_work(lengths, s_max, n_h, n_kv, dk, dv, q.element_size(),
                                  pos_bytes)
            # the per-layer forms' plain version is the stacked one's on that layer
            for name, kernel, plain, got in ((stacked_name, stacked, stacked_plain, out),
                                             (per_layer_name, per_layer,
                                              stacked_plain, out_l)):
                rel = k3_slot_errors(got, ref)
                t = {"max_abs_err": (got.float() - ref.float()).abs().max().item(),
                     **kernel_times(kernel), "plain_ms": time_ms(plain), **work,
                     "library_ms": lib.get("library_ms"),
                     "library_device_ms": lib.get("library_device_ms")}
                emit("kernels", kernel=name, shape=shape, regime="decode",
                     dtype="bfloat16", B=b, S=s_max, n_h=n_h, n_kv=n_kv, dk=dk, dv=dv,
                     scale=scale, lengths=lengths.tolist(), rel_err_per_slot=rel,
                     bitwise_k3_after_its_write=bitwise_update,
                     per_layer_bitwise_stacked=bitwise_layer,
                     library_max_abs_diff=lib.get("library_max_abs_diff"),
                     bound=f"{K3_REL_BOUND} * max|ref[b]| + 1 bf16 ulp", **t)
                if shape == "ds2_mla":
                    rec[name].update(t)
            if not (bitwise_update and bitwise_layer):
                raise AssertionError(
                    f"{stacked_name} ({shape}): not bitwise K3 after its write "
                    f"({bitwise_update}) or the per-layer form ({bitwise_layer})")
            del caches, layer_caches


def ffn_work(gs, k: int, n: int, h: int, expert_bytes, out_bytes: int = 2) -> dict:
    """K12 / K13 on THIS layout: every row the kernel is given (the aligned
    dispatch's padding rows included) is read as int8 codes and a scale and
    written once; each live expert streams its gate_up and down codes
    (``expert_bytes[e]``) and its scale rows; the hq intermediate never has
    to leave the chip, so it is not counted. Operations: both int8 GEMMs."""
    import torch

    live = gs > 0
    rows = int(gs.sum())
    e = gs.numel()
    w = torch.as_tensor(expert_bytes, device=gs.device).expand(e)
    nbytes = (rows * (k + 4) + int(w[live].sum()) + int(live.sum()) * (2 * n + h) * 4
              + 2 * e * 4 + rows * h * out_bytes)
    return work_bound(nbytes, 2 * rows * (k * 2 * n + n * h), "int8")


def _reference_ffn_setup(seed: int = 7):
    """The reference test's K12 set-up (tests/test_pallas_gmm.py:766-783: 5
    experts, K = N = H = 256, sizes 64/0/32/64/32, down bits 4/8/8/4/6), made
    from a numpy seed exactly as tests/test_torch_gmm_ffn.py makes it."""
    import numpy as np
    import torch

    from mxmoe_tpu_torch.quant.qparams import quantize_act_per_row_bits

    e, k, nh, hout, m = 5, 256, 256, 256, 224
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)

    def qw(w):
        sc = (np.abs(w).max(axis=1, keepdims=True) / np.float32(127.0)).astype(np.float32)
        return np.round(w / sc).astype(np.int8), sc

    wgu_q, wgu_sc = qw((rng.standard_normal((e, k, 2 * nh)) * 0.05).astype(np.float32))
    wd_q, wd_sc = qw((rng.standard_normal((e, nh, hout)) * 0.05).astype(np.float32))
    aq, asc = quantize_act_per_row_bits(torch.from_numpy(x), torch.full((m,), 8.0))
    dev = torch.device("cuda")
    t = [torch.as_tensor(v).to(dev) for v in (wgu_q, wgu_sc, wd_q, wd_sc)]
    return ([aq.to(dev), asc.to(dev)] + t,
            torch.tensor([64, 0, 32, 64, 32], dtype=torch.int32, device=dev),
            torch.tensor([4, 8, 8, 4, 6], dtype=torch.int32, device=dev))


def ffn_row_count_edges(aq, asc, wgu, sgu, wd, sd, bits) -> None:
    """K12 and K13 (no / every other / every expert packed) bitwise their
    plain versions and each other, each launch counted once, at qwen2_moe's
    widths with 1, 16, 17, 32, 33 and 64 rows an expert (an empty expert
    among them), unaligned: the cluster body's one- and two-fragment tiles
    and tiles that straddle two experts."""
    import torch

    from mxmoe_tpu_torch.ops import gmm_ffn, kernels
    from mxmoe_tpu_torch.quant.packing import build_ragged_mixed

    counts = [1, 16, 0, 17, 32, 33, 64]
    e, rows = len(counts), sum(counts)
    dev = aq.device
    gs = torch.tensor(counts, dtype=torch.int32, device=dev)
    a, sa = aq[:rows + 8].contiguous(), asc[:rows + 8].contiguous()
    wg, sg, w2, s2, b = wgu[:e], sgu[:e], wd[:e], sd[:e], bits[:e].contiguous()
    for label, pf in (("none packed", [0] * e),
                      ("alternating", [int(i % 2 == 0) for i in range(e)]),
                      ("all packed", [1] * e)):
        pfb = torch.tensor(pf, dtype=torch.bool, device=dev)[:, None, None]
        wg4, w24 = torch.where(pfb, wg.clamp(-8, 7), wg), torch.where(pfb, w2.clamp(-8, 7), w2)
        gu_cat, gu_blk = build_ragged_mixed(wg4, pf)
        d_cat, d_blk = build_ragged_mixed(w24, pf)
        i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
        args = (a, sa, gu_cat, sg, i32(pf), i32(gu_blk), d_cat, s2, i32(pf), i32(d_blk), gs, b)
        n12, n13 = kernels.launches["gmm_ffn_w8a8"], kernels.launches["gmm_ffn_mixed_packed"]
        k12 = gmm_ffn.gmm_ffn_w8a8(a, sa, wg4, sg, w24, s2, gs, b)
        k13 = gmm_ffn.gmm_ffn_mixed_packed(*args)
        once = (kernels.launches["gmm_ffn_w8a8"] == n12 + 1
                and kernels.launches["gmm_ffn_mixed_packed"] == n13 + 1)
        p12 = gmm_ffn.gmm_ffn_w8a8_plain(a, sa, wg4, sg, w24, s2, gs, b)
        p13 = gmm_ffn.gmm_ffn_mixed_packed_plain(*args)
        torch.cuda.synchronize()
        _require_equal(k12[:rows], p12[:rows], f"K12 vs plain at row-count edges, {label}")
        _require_equal(k13[:rows], p13[:rows], f"K13 vs plain at row-count edges, {label}")
        _require_equal(k13[:rows], k12[:rows], f"K13 vs K12 at row-count edges, {label}")
        if not once:
            raise AssertionError("K12 / K13 at the row-count edges: a call did not count "
                                 "exactly one launch")
        emit("kernels", kernel="gmm_ffn_w8a8 / gmm_ffn_mixed_packed", use="row-count edges",
             rows_per_expert=counts, storage=label, bitwise=True, equals_gmm_ffn_w8a8=True)


def fused_kernels_vs_plain(rec: dict) -> None:
    """K12-K15. K12 (gmm_ffn_w8a8) and K13 (gmm_ffn_mixed_packed) at the
    decode and prefill shapes over the aligned dispatch (32 rows): K12
    bitwise its plain version and, with f32 output, within the reference's
    bounds of the two-launch path (K2 -> bf16 -> SwiGLU -> K1 -> K2: mean
    |d| < 1e-2, p99 < 8e-2, max < 0.3), timed beside it; on the reference
    test's set-up also within 2e-4 of the f32 oracle. K13 bitwise its plain
    version and K12 on the equivalent int8 codes (no expert packed, every
    other, all), timed beside its two-launch path (K4 + SwiGLU + K1 + K4).
    K12 and K13 also at row counts on the edges of the cluster body's m16 /
    m32 fragments (1, 16, 17, 32, 33, 64 rows an expert, unaligned: tiles
    straddle experts), bitwise as above; both timed by device time beside
    their two-launch paths. K14 (gmm_w8a8_fusedquant) at the gate_up shape
    bitwise its plain version and K1 + K2, timed beside them. K15 (gmm_ws)
    at the headline workload's shapes, rows padded to 128: bitwise K2
    (int8) and K5 (packed), timed beside them."""
    import torch

    from mxmoe_tpu_torch.bench import workloads
    from mxmoe_tpu_torch.models.configs import QWEN2_MOE_A2_7B as cfg
    from mxmoe_tpu_torch.models.layers import silu_mul
    from mxmoe_tpu_torch.ops import act_quant, gmm as gfl, gmm_ffn
    from mxmoe_tpu_torch.ops import gmm_mixed_packed as gmp
    from mxmoe_tpu_torch.ops import gmm_w4a8_packed as g4p, gmm_w8a8 as gmm
    from mxmoe_tpu_torch.ops import gmm_w8a8_fusedquant as gfq, gmm_ws
    from mxmoe_tpu_torch.ops.dispatch import expert_of_rows, make_dispatch, route_topk
    from mxmoe_tpu_torch.quant.packing import build_ragged_mixed, pack_int4_halves

    torch.backends.cuda.matmul.allow_tf32 = False      # the oracle's f32 products
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    h, n, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
    f32 = torch.float32

    def timed(kernel, plain, work, reps=5):
        return {**kernel_times(kernel), "plain_ms": time_ms(plain, reps=reps, warmup=1),
                **work}

    # the reference test's set-up: K12 against the f32 oracle
    (aq, asc, wgu, sgu, wd, sd), gs, bits = _reference_ffn_setup()
    rows = int(gs.sum())
    out = gmm_ffn.gmm_ffn_w8a8(aq, asc, wgu, sgu, wd, sd, gs, bits, f32)
    row_bits = bits[expert_of_rows(gs, aq.shape[0])].float()
    gu = gfl.gmm_bf16_plain(aq.float() * asc, wgu.float() * sgu, gs, f32)
    hf = gu[:, :256] * torch.sigmoid(gu[:, :256]) * gu[:, 256:]
    hq, hsc = act_quant.quantize_rows_plain(hf, row_bits)
    oracle = gfl.gmm_bf16_plain(hq.float() * hsc, wd.float() * sd, gs, f32)
    torch.cuda.synchronize()
    err = (out - oracle)[:rows].abs()
    if not bool((err <= 2e-4 + 2e-4 * oracle[:rows].abs()).all()):
        raise AssertionError(f"K12 outside 2e-4 of the f32 oracle: max|d|={err.max()}")
    emit("kernels", kernel="gmm_ffn_w8a8", use="reference test set-up vs f32 oracle",
         M=aq.shape[0], K=256, N=256, H=256, max_abs_err=err.max().item(),
         bound="rtol 2e-4, atol 2e-4")

    # qwen2_moe widths: per-channel int8 weights of seeded normal floats
    def quant_w(shape):
        w = torch.randn(shape, generator=gen, device=dev) * 0.02
        sc = w.abs().amax(1, keepdim=True) / 127.0
        return torch.round(w / sc).to(torch.int8), sc

    wgu, sgu = quant_w((e, h, 2 * n))
    wd, sd = quant_w((e, n, h))
    bits = torch.tensor([(4, 6, 8)[i % 3] for i in range(e)], dtype=torch.int32,
                        device=dev)
    alternating = [int(i % 2 == 0) for i in range(e)]
    for regime, tokens in (("decode", 4), ("prefill", 256)):
        logits = torch.randn((tokens, e), generator=gen, device=dev)
        routing = route_topk(logits, cfg.top_k, cfg.norm_topk_prob)
        disp = make_dispatch(routing, e, align=32)
        gs, m = disp.group_sizes, disp.token_ids.numel()
        rows = int(gs.sum())
        x = torch.randn((m, h), generator=gen, device=dev).to(torch.bfloat16)
        aq, asc = act_quant.quantize_rows_uniform(x, 8)
        row_bits = bits[expert_of_rows(gs, m)].float()
        shape = dict(regime=regime, M=m, routed_rows=tokens * cfg.top_k, rows=rows,
                     live_experts=int((gs > 0).sum()), K=h, N=n, H=h)
        decode = regime == "decode"

        # K12
        out = gmm_ffn.gmm_ffn_w8a8(aq, asc, wgu, sgu, wd, sd, gs, bits)
        ref = gmm_ffn.gmm_ffn_w8a8_plain(aq, asc, wgu, sgu, wd, sd, gs, bits)
        out32 = gmm_ffn.gmm_ffn_w8a8(aq, asc, wgu, sgu, wd, sd, gs, bits, f32)

        def two_launch(out_dtype=torch.bfloat16):
            hh = silu_mul(gmm.gmm_w8a8(aq, asc, wgu, sgu, gs))
            q2, s2 = act_quant.quantize_rows(hh, row_bits)
            return gmm.gmm_w8a8(q2, s2, wd, sd, gs, out_dtype=out_dtype)

        d = (out32 - two_launch(f32))[:rows].abs().flatten()
        torch.cuda.synchronize()
        _require_equal(out[:rows], ref[:rows], f"K12 vs plain at {regime}")
        gap = {"mean": d.mean().item(), "p99": torch.quantile(d[:1 << 24], 0.99).item(),
               "max": d.max().item()}
        if not (gap["mean"] < 1e-2 and gap["p99"] < 8e-2 and gap["max"] < 0.3):
            raise AssertionError(f"K12 vs the two-launch path at {regime}: {gap}")
        t = timed(lambda: gmm_ffn.gmm_ffn_w8a8(aq, asc, wgu, sgu, wd, sd, gs, bits),
                  lambda: gmm_ffn.gmm_ffn_w8a8_plain(aq, asc, wgu, sgu, wd, sd, gs, bits),
                  ffn_work(gs, h, n, h, h * 2 * n + n * h))
        emit("kernels", kernel="gmm_ffn_w8a8", bitwise=True, down_bits="4/6/8",
             resident_clusters=gmm_ffn.resident_clusters(n, h),
             vs_two_launch=gap, two_launch_ms=time_ms(two_launch),
             two_launch_device_ms=device_ms(two_launch), **shape, **t)
        if decode:
            rec["gmm_ffn_w8a8"].update(t)

        # K13 on the equivalent codes: packed experts' codes in the 4-bit range
        storages = [("alternating", alternating)]
        if decode:
            storages += [("none packed", [0] * e), ("all packed", [1] * e)]
        for label, pf in storages:
            pfb = torch.tensor(pf, dtype=torch.bool, device=dev)[:, None, None]
            wgu4 = torch.where(pfb, wgu.clamp(-8, 7), wgu)
            wd4 = torch.where(pfb, wd.clamp(-8, 7), wd)
            gu_cat, gu_blk = build_ragged_mixed(wgu4, pf)
            d_cat, d_blk = build_ragged_mixed(wd4, pf)
            i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
            meta = (i32(pf), i32(gu_blk), i32(pf), i32(d_blk))
            args = (aq, asc, gu_cat, sgu, meta[0], meta[1], d_cat, sd, meta[2],
                    meta[3], gs, bits)
            out = gmm_ffn.gmm_ffn_mixed_packed(*args)
            ref = gmm_ffn.gmm_ffn_mixed_packed_plain(*args)
            k12 = gmm_ffn.gmm_ffn_w8a8(aq, asc, wgu4, sgu, wd4, sd, gs, bits)
            torch.cuda.synchronize()
            _require_equal(out[:rows], ref[:rows], f"K13 vs plain, {label} at {regime}")
            _require_equal(out[:rows], k12[:rows], f"K13 vs K12, {label} at {regime}")
            per_expert = [(h * 2 * n + n * h) // (2 if f else 1) for f in pf]
            t = timed(lambda: gmm_ffn.gmm_ffn_mixed_packed(*args),
                      lambda: gmm_ffn.gmm_ffn_mixed_packed_plain(*args),
                      ffn_work(gs, h, n, h, per_expert))

            def two_launch_k4():
                hh = silu_mul(gmp.gmm_mixed_packed(aq, asc, gu_cat, sgu, gs, meta[0],
                                                   meta[1]))
                q2, s2 = act_quant.quantize_rows(hh, row_bits)
                return gmp.gmm_mixed_packed(q2, s2, d_cat, sd, gs, meta[2], meta[3])

            emit("kernels", kernel="gmm_ffn_mixed_packed", storage=label, bitwise=True,
                 equals_gmm_ffn_w8a8=True, packed_experts=sum(pf),
                 resident_clusters=gmm_ffn.resident_clusters(n, h, ragged=True),
                 gmm_ffn_w8a8_same_codes_ms=time_ms(
                     lambda: gmm_ffn.gmm_ffn_w8a8(aq, asc, wgu4, sgu, wd4, sd, gs, bits)),
                 two_launch_ms=time_ms(two_launch_k4),
                 two_launch_device_ms=device_ms(two_launch_k4), **shape, **t)
            if decode and label == "alternating":
                rec["gmm_ffn_mixed_packed"].update(t)
            del gu_cat, d_cat, wgu4, wd4

        if decode:
            ffn_row_count_edges(aq, asc, wgu, sgu, wd, sd, bits)

        # K14 at the gate_up shape, on the unaligned dispatch
        gs_u = make_dispatch(routing, e).group_sizes
        mu = tokens * cfg.top_k
        xu = torch.randn((mu, h), generator=gen, device=dev).to(torch.bfloat16)
        out = gfq.gmm_w8a8_fusedquant(xu, wgu, sgu, gs_u)
        ref = gfq.gmm_w8a8_fusedquant_plain(xu, wgu, sgu, gs_u)

        def k1_k2():
            q1, s1 = act_quant.quantize_rows_uniform(xu, 8)
            return gmm.gmm_w8a8(q1, s1, wgu, sgu, gs_u)

        k12_ref = k1_k2()
        torch.cuda.synchronize()
        _require_equal(out, ref, f"K14 vs plain at {regime}")
        _require_equal(out, k12_ref, f"K14 vs K1 + K2 at {regime}")
        t = timed(lambda: gfq.gmm_w8a8_fusedquant(xu, wgu, sgu, gs_u),
                  lambda: gfq.gmm_w8a8_fusedquant_plain(xu, wgu, sgu, gs_u),
                  gmm_work(gs_u, h, 2 * n, h * 2 * n, lhs_row_bytes=2 * h))
        emit("kernels", kernel="gmm_w8a8_fusedquant", bitwise=True,
             equals_quantize_rows_gmm_w8a8=True, k1_k2_ms=time_ms(k1_k2),
             regime=regime, M=mu, K=h, N=2 * n, **t)
        if decode:
            rec["gmm_w8a8_fusedquant"].update(t)

    # K15 at the headline workload's shapes, every expert's rows padded to 128
    for wl in workloads.qwen2_moe_l10_bs8192():
        sizes = [(s + 127) // 128 * 128 for s in wl.group_sizes]
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        m, k, nn = sum(sizes), wl.k, wl.n
        aq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        asc = torch.rand((m, 1), generator=gen, device=dev) * 0.05
        wq = torch.randint(-127, 128, (e, k, nn), generator=gen, device=dev,
                           dtype=torch.int8)
        wsc = torch.rand((e, 1, nn), generator=gen, device=dev) * 0.01
        shape = dict(use="headline workload", workload=wl.name, M=m, K=k, N=nn)
        out = gmm_ws.gmm_w8a8_ws(aq, asc, wq, wsc, sizes)
        k2 = gmm.gmm_w8a8(aq, asc, wq, wsc, gs)
        ref = gmm_ws.gmm_w8a8_ws_plain(aq, asc, wq, wsc, sizes)
        torch.cuda.synchronize()
        _require_equal(out, k2, f"K15 vs K2 at {wl.name}")
        _require_equal(out, ref, f"K15 vs plain at {wl.name}")
        t = timed(lambda: gmm_ws.gmm_w8a8_ws(aq, asc, wq, wsc, sizes),
                  lambda: gmm_ws.gmm_w8a8_ws_plain(aq, asc, wq, wsc, sizes),
                  gmm_work(gs, k, nn, k * nn), reps=3)
        emit("kernels", kernel="gmm_ws", form="int8", bitwise=True, equals_gmm_w8a8=True,
             gmm_w8a8_same_codes_ms=time_ms(lambda: gmm.gmm_w8a8(aq, asc, wq, wsc, gs)),
             **shape, **t)
        if k == h:
            rec["gmm_ws"].update(t)
        del wq
        w4 = torch.randint(-8, 8, (e, k, nn), generator=gen, device=dev, dtype=torch.int8)
        packed = pack_int4_halves(w4)
        del w4
        out = gmm_ws.gmm_w4a8_packed_ws(aq, asc, packed, wsc, sizes)
        k5 = g4p.gmm_w4a8_packed(aq, asc, packed, wsc, gs)
        torch.cuda.synchronize()
        _require_equal(out, k5, f"K15 packed vs K5 at {wl.name}")
        t = timed(lambda: gmm_ws.gmm_w4a8_packed_ws(aq, asc, packed, wsc, sizes),
                  lambda: gmm_ws.gmm_w4a8_packed_ws_plain(aq, asc, packed, wsc, sizes),
                  gmm_work(gs, k, nn, k * nn // 2), reps=3)
        emit("kernels", kernel="gmm_ws", form="packed", bitwise=True,
             equals_gmm_w4a8_packed=True,
             gmm_w4a8_packed_same_codes_ms=time_ms(
                 lambda: g4p.gmm_w4a8_packed(aq, asc, packed, wsc, gs)), **shape, **t)
        del packed, aq


def schedule_edges() -> None:
    """The redesigned bodies at the edges of their schedules. The int8
    grouped GEMM (K2, K4, K5, K9) at M 1, 4, 16, 17, 24, 64, 65, 256, routed
    over 12 groups (two empty) and as one group (split-K): each bitwise its
    plain version, K4 and K5 bitwise K2 on the same codes. The grouped-scale
    GEMM (K8, K4f) on the same rows and codes at g128 with zero points: each
    bitwise its plain version, K4f bitwise K8 on the same codes. The
    weight-only GEMM (K6, K7, K10: one schedule) on the same rows, 4-bit
    codes, at g128 with zero points and per channel: K6 within
    ``gmm_weight_only.error_over_bound`` of the float64 product, K7 bitwise
    K6, K10 (experts alternating) weight-only rows bitwise K6 and w x a rows
    bitwise K8 (and K2 per channel). K3 / K3q at
    lengths on the warp-chunk and S-block edges, G 1 / 4 / 7: the write
    bitwise, the output within K3_REL_BOUND per slot (+ 1 bf16 ulp), the
    read-only form bitwise K3 / K3q after their write."""
    import torch

    from mxmoe_tpu_torch.ops import gmm_mixed_packed as gmp, gmm_w4a8_packed as g4p
    from mxmoe_tpu_torch.ops import gmm_w8a8 as gmm, gmm_w8a8_asym as gas
    from mxmoe_tpu_torch.ops import gmm_w8a8_grouped as ggrp
    from mxmoe_tpu_torch.ops import gmm_mixed_wo_wxa as gmx, gmm_weight_only as gwo
    from mxmoe_tpu_torch.ops import gmm_weight_only_packed as gwop
    from mxmoe_tpu_torch.quant.packing import build_ragged_mixed, pack_int4_halves
    from mxmoe_tpu_torch.serving import decode_attention as da

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    cases, grouped_cases, wo_cases = [], [], []
    for m in (1, 4, 16, 17, 24, 64, 65, 256):
        for layout in ("routed", "one_group"):
            if layout == "routed":
                counts = torch.bincount(torch.randint(0, 12, (m,), generator=gen,
                                                      device=dev), minlength=12)
                counts[1] = counts[5] = 0
                counts[0] += m - int(counts.sum())
                k, n = 1408, 2048
            else:
                counts, k, n = torch.tensor([m], device=dev), 2048, 1024
            gs = counts.to(torch.int32)
            e = gs.numel()
            sched = gmm.int8_gmm_schedule(m, k, n, e)
            aq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                               dtype=torch.int8)
            asc = torch.rand((m, 1), generator=gen, device=dev) * 0.05
            w8 = torch.randint(-127, 128, (e, k, n), generator=gen, device=dev,
                               dtype=torch.int8)
            w4 = torch.randint(-8, 8, (e, k, n), generator=gen, device=dev,
                               dtype=torch.int8)
            wsc = torch.rand((e, 1, n), generator=gen, device=dev) * 0.01
            zp = torch.rand((e, 1, n), generator=gen, device=dev) * 0.2 - 0.1
            pflags = [i % 2 for i in range(e)]
            mixed = w8.clone()
            mixed[1::2] = w4[1::2]
            cat, blk = build_ragged_mixed(mixed, pflags)
            pf = torch.tensor(pflags, dtype=torch.int32, device=dev)
            blk = torch.tensor(blk, dtype=torch.int32, device=dev)
            packed = pack_int4_halves(w4)
            k2 = gmm.gmm_w8a8(aq, asc, w8, wsc, gs)
            checks = (
                ("K2", k2, gmm.gmm_w8a8_plain(aq, asc, w8, wsc, gs)),
                ("K9", gas.gmm_w8a8_asym(aq, asc, w8, wsc, zp, gs),
                 gas.gmm_w8a8_asym_plain(aq, asc, w8, wsc, zp, gs)),
                ("K5", g4p.gmm_w4a8_packed(aq, asc, packed, wsc, gs),
                 g4p.gmm_w4a8_packed_plain(aq, asc, packed, wsc, gs)),
                ("K5 = K2", g4p.gmm_w4a8_packed(aq, asc, packed, wsc, gs),
                 gmm.gmm_w8a8(aq, asc, w4, wsc, gs)),
                ("K4", gmp.gmm_mixed_packed(aq, asc, cat, wsc, gs, pf, blk),
                 gmp.gmm_mixed_packed_plain(aq, asc, cat, wsc, gs, pf, blk)),
                ("K4 = K2", gmp.gmm_mixed_packed(aq, asc, cat, wsc, gs, pf, blk),
                 gmm.gmm_w8a8(aq, asc, mixed, wsc, gs)))
            # the grouped-scale GEMM on the same rows and codes, g128 + zp
            g = k // GSIZE
            gsc = torch.rand((m, g), generator=gen, device=dev) * 0.05
            gwsc = torch.rand((e, g, n), generator=gen, device=dev) * 0.01
            gzp = torch.randn((e, g, n), generator=gen, device=dev) * 0.02
            k4f = gmp.gmm_mixed_packed(aq, gsc, cat, gwsc, gs, pf, blk, rhs_zp=gzp)
            checks += (
                ("K8", ggrp.gmm_w8a8_grouped(aq, gsc, w8, gwsc, gs, GSIZE, gzp),
                 ggrp.gmm_w8a8_grouped_plain(aq, gsc, w8, gwsc, gs, GSIZE, gzp)),
                ("K4f", k4f, gmp.gmm_mixed_packed_plain(aq, gsc, cat, gwsc, gs, pf,
                                                        blk, rhs_zp=gzp)),
                ("K4f = K8", k4f,
                 ggrp.gmm_w8a8_grouped(aq, gsc, mixed, gwsc, gs, GSIZE, gzp)))
            # the weight-only GEMM on the same rows and 4-bit codes: K6, K7
            # and K10 (experts alternating) on one schedule
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            fl = torch.tensor(pflags, dtype=torch.int32, device=dev)
            wo_rows = torch.repeat_interleave(fl, gs.long()).bool()
            for gsize, wsc_w, zp_w, sa_w in ((GSIZE, gwsc, gzp, gsc),
                                             (-1, wsc, None, asc)):
                zp6 = torch.zeros_like(wsc_w) if zp_w is None else zp_w
                k6 = gwo.gmm_weight_only(x, w4, wsc_w, zp6, gs, gsize)
                k10 = gmx.gmm_mixed_wo_wxa(x, aq, sa_w, w4, wsc_w, fl, gs, rhs_zp=zp_w)
                wxa = (gmm.gmm_w8a8(aq, sa_w, w4, wsc_w, gs) if zp_w is None else
                       ggrp.gmm_w8a8_grouped(aq, sa_w, w4, wsc_w, gs, gsize, zp_w))
                checks += (
                    (f"K7 = K6, gsize {gsize}",
                     gwop.gmm_weight_only_packed(x, packed, wsc_w, zp6, gs, gsize), k6),
                    (f"K10 weight-only rows = K6, gsize {gsize}", k10[wo_rows],
                     k6[wo_rows]),
                    (f"K10 w x a rows = {'K2' if zp_w is None else 'K8'}, gsize "
                     f"{gsize}", k10[~wo_rows], wxa[~wo_rows]))
                torch.cuda.synchronize()
                _, ratio = gwo.error_over_bound(k6, x, w4, wsc_w, zp6, gs, gsize)
                if not ratio <= 1.0:
                    raise AssertionError(f"K6 outside its bound at M {m} {layout} "
                                         f"gsize {gsize}: {ratio} of it")
                wo_cases.append({"M": m, "layout": layout, "K": k, "gsize": gsize,
                                 "err_over_bound": ratio,
                                 **_wo_schedule(m, k, n, e, gsize)})
            torch.cuda.synchronize()
            for what, got, ref in checks:
                _require_equal(got, ref, f"{what} at M {m} {layout}")
            cases.append({"M": m, "layout": layout, "bm": sched.bm,
                          "splits": sched.splits, "blocks": sched.blocks})
            gsched = ggrp.grouped_gmm_schedule(m, k, n, e, GSIZE)
            grouped_cases.append({"M": m, "layout": layout, "K": k, "bm": gsched.bm,
                                  "grid_m": gsched.grid_m, "splits": gsched.splits,
                                  "blocks": gsched.blocks})
    emit("schedule_edges", kernel="int8 grouped GEMM (K2, K4, K5, K9)",
         bitwise=True, cases=cases)
    emit("schedule_edges", kernel="grouped-scale GEMM (K8, K4f)", gsize=GSIZE,
         rhs_zp=True, bitwise=True, k4f_equals_k8=True, cases=grouped_cases)
    emit("schedule_edges", kernel="weight-only GEMM (K6, K7, K10)",
         k7_equals_k6=True, k10_weight_only_rows_equal_k6=True,
         k10_wxa_rows_equal_k8_or_k2=True, cases=wo_cases)

    n_kv, s_max, dv, layer = 2, 600, 128, 0
    lens = [0, 15, 16, 31, 32, 33, 63, 64, 65, 255, 256, 257, 511, 599, 600]
    b = len(lens)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    valid = torch.ones((b,), dtype=torch.int32, device=dev)
    valid[3] = 0
    for groups, dk in ((1, 256), (4, 128), (7, 128)):
        for quant in (False, True):
            if quant:
                caches = [torch.randint(-127, 128, (2, b, n_kv, s_max, d), generator=gen,
                                        device=dev, dtype=torch.int8) if d else
                          torch.rand((2, b, n_kv, s_max), generator=gen, device=dev)
                          * 0.03 + 1e-3 for d in (dk, 0, dv, 0)]
            else:
                caches = [torch.randn((2, b, n_kv, s_max, d), generator=gen, device=dev)
                          .to(torch.bfloat16) if d else None for d in (dk, 0, dv, 0)]
            caches2 = [None if c is None else c.clone() for c in caches]
            q = torch.randn((b, n_kv * groups, dk), generator=gen, device=dev).to(torch.bfloat16)
            kn = torch.randn((b, n_kv, dk), generator=gen, device=dev).to(torch.bfloat16)
            vn = torch.randn((b, n_kv, dv), generator=gen, device=dev).to(torch.bfloat16)
            scale = 1.0 / dk ** 0.5
            out, _ = da.decode_attention_update_stacked(q, kn, vn, *caches, lengths,
                                                        layer, valid=valid, scale=scale)
            if quant:
                ref = da.decode_attention_update_q8_plain(q, kn, vn, *caches2, lengths,
                                                          layer, valid, scale)
            else:
                ref = da.decode_attention_update_plain(q, kn, vn, caches2[0], caches2[2],
                                                       lengths, layer, valid, scale)
            ro, _ = da.decode_attention_stacked(q, *caches, lengths, layer, scale=scale)
            torch.cuda.synchronize()
            for got, want in zip(caches, caches2):
                if got is not None and not torch.equal(got, want):
                    raise AssertionError(f"K3 write not bitwise (G {groups}, {quant})")
            rel = k3_slot_errors(out, ref)
            _require_equal(ro, out, f"read-only vs K3 (G {groups}, int8 {quant})")
            emit("schedule_edges", kernel="K3q" if quant else "K3", G=groups, dk=dk,
                 lengths=lens, cache_bitwise=True, read_only_bitwise=True,
                 rel_err_max=max(rel))


def kernels_vs_plain() -> dict:
    """Each kernel vs its plain version; returns per-kernel records."""
    rec = {name: {"max_abs_err": 0.0} for name in KERNEL_SOURCES}
    schedule_edges()
    gmm_kernels_vs_plain(rec)
    scheme_kernels_vs_plain(rec)
    two_launch_kernels_vs_plain(rec)
    attention_kernels_vs_plain(rec)
    read_only_attention_vs_plain(rec)
    fused_kernels_vs_plain(rec)
    combine_vs_index_add()
    return rec


def _to(params, device):
    return {k: (_to(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in params.items()}


def _top2_margin(logits):
    """Per-row gap between the two largest logits ([.., V] -> [..])."""
    top2 = logits.float().topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def _full_width_model(layers: int, seed: int, model: str = "qwen2_moe"):
    """``model`` (qwen2_moe, ds2, mixtral, qwen2_moe_57b) at its published
    widths, ``layers`` deep (ds2's dense first layer counts), with seeded
    random bf16 weights made on the card -> (config, float params)."""
    import torch

    from mxmoe_tpu_torch.models.configs import config_for
    from mxmoe_tpu_torch.models.model import init_params

    cfg = dataclasses.replace(config_for(model), num_layers=layers)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    floats = init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    return cfg, floats


def _served_model(layers: int, seed: int, model: str, quant: str, pack: bool,
                  int8_head: bool, impl_kw: dict | None):
    """What ``serve`` runs: ``model`` at its published widths, ``layers``
    deep, its seeded random bf16 weights drawn and quantized one MoE layer at
    a time (``bench_serving.init_for_serving``, each layer through
    ``prepare``, so the float model never exists whole) -> (config, params,
    MoEImpl)."""
    import torch

    from mxmoe_tpu_torch.models.configs import config_for
    from mxmoe_tpu_torch.quant.qparams import quantize_lm_head
    from mxmoe_tpu_torch.serving.bench_serving import init_for_serving

    cfg = dataclasses.replace(config_for(model), num_layers=layers)
    dev = torch.device("cuda")
    params, impl = init_for_serving(
        cfg, torch.Generator(device=dev).manual_seed(seed),
        functools.partial(prepare, quant=quant, pack=pack, impl_kw=impl_kw), dev)
    if int8_head:
        params = quantize_lm_head(params)
    return cfg, params, impl


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


# the two-launch branches come as ``bench_serving.MIXES`` names (shared expert
# per-channel w8a8):
#   flex-wo      grouped asymmetric weight-only beside w8a8, one launch (K10,
#                flex body): the scheme pair of the reference's fused kernel
#   mixed-wo     per-channel weight-only beside w8a8 (K10, per-channel body)
#   flex-packed  grouped asymmetric w4a4 nibble-packed beside w8a8 in the ragged
#                buffer (K4f); flex: the same codes int8-stored (K8)
# float experts: through K11 (``gmm_backend="pallas"``) or the stock product
FLOAT_ARMS = {"bf16-k11": "pallas", "none": "ragged_dot"}


def flex_mixed_config(num_layers: int, num_experts: int, shared_scheme: str):
    from mxmoe_tpu_torch.quant.schemes import (QLayerConfig, QModelConfig,
                                               build_uniform_expert, parse_scheme)

    experts = {str(i): build_uniform_expert(parse_scheme(FLEX_ROUTED[i % 2]))
               for i in range(num_experts)}
    experts[str(num_experts)] = build_uniform_expert(parse_scheme(shared_scheme))
    return QModelConfig(layers={str(l): QLayerConfig(experts=dict(experts))
                                for l in range(num_layers)})


def prepare(floats: dict, cfg, quant: str, pack: bool = False,
            int8_head: bool = False, impl_kw: dict | None = None):
    """Float params -> (quantized params, MoEImpl). ``quant``: what
    ``bench_serving --quant`` takes, or a ``FLEX_SHARED`` or ``FLOAT_ARMS``
    name; ``pack`` nibble-packs a uniform scheme's codes
    (convert's pack step); ``int8_head`` quantizes the lm_head; ``impl_kw``
    sets MoEImpl fields (``fused_ffn``, ``dispatch_align``)."""
    from mxmoe_tpu_torch.models.convert import pack_int4_experts
    from mxmoe_tpu_torch.models.layers import MoEImpl
    from mxmoe_tpu_torch.quant.qparams import (quantize_lm_head,
                                               quantize_model_experts_mixed)
    from mxmoe_tpu_torch.serving.bench_serving import quantize_for_serving

    if quant in FLEX_SHARED:
        qmc = flex_mixed_config(cfg.num_moe_layers, cfg.num_experts, FLEX_SHARED[quant])
        params = quantize_model_experts_mixed(floats, cfg, qmc)
        impl = MoEImpl(quant="mixed")
    elif quant in FLOAT_ARMS:
        params, impl = floats, MoEImpl(gmm_backend=FLOAT_ARMS[quant])
    else:
        params, impl = quantize_for_serving(floats, cfg, quant)
    if pack:
        params = pack_int4_experts(params, impl.quant)
    if int8_head:
        params = quantize_lm_head(params)
    return params, dataclasses.replace(impl, **(impl_kw or {}))


def slice_parity(quant: str, int8_kv: bool, pack: bool = False,
                 impl_kw: dict | None = None, tries: int = 40,
                 model: str = "qwen2_moe", layers: int = 2) -> None:
    """A full-width slice of ``model``, ``layers`` deep, on the CPU (plain
    versions), then the same inputs on CUDA (kernels). The CPU run picks its
    inputs: a prompt, then for each decode step one input token per slot,
    such that every compared position's top-2 margin exceeds PARITY_BOUND.
    ``impl_kw`` as ``prepare`` takes it."""
    import numpy as np
    import torch

    from mxmoe_tpu_torch.serving.decode import forward_cached

    cfg, floats = _full_width_model(layers, seed=1, model=model)
    params, impl = prepare(floats, cfg, quant, pack, impl_kw=impl_kw)
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
    emit("parity", model=model, quant=quant, packed=pack, int8_kv=int8_kv,
         layers=cfg.num_layers,
         fused_ffn=impl.fused_ffn, dispatch_align=impl.dispatch_align,
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


def forward_logits_vs_prefill(model: str, layers: int, quant: str = "mixed-packed",
                              seed: int = 4) -> None:
    """On the card, the full forward (``forward_logits`` over a 256-token
    prompt) against a one-chunk ``forward_cached`` prefill of the same prompt
    into an empty bf16 cache: logits within the parity bound (PARITY_ULPS
    bf16 ulps at max|logits|, at most PARITY_BOUND)."""
    import numpy as np
    import torch

    from mxmoe_tpu_torch.models.model import forward_logits
    from mxmoe_tpu_torch.serving.decode import forward_cached

    cfg, floats = _full_width_model(layers, seed=seed, model=model)
    params, impl = prepare(floats, cfg, quant)
    del floats
    dev = torch.device("cuda")
    prompt = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 256)).astype(np.int32), device=dev)
    full = forward_logits(params, prompt, cfg, impl).float()
    cached, _ = forward_cached(params, prompt, _init_cache(cfg, 2, 512, False, dev),
                               cfg, impl)
    cached = cached.float()
    torch.cuda.synchronize()
    err = (full - cached).abs().max().item()
    bound = min(PARITY_BOUND, PARITY_ULPS * bf16_ulp(cached.abs().max()).item())
    finite = bool(torch.isfinite(full).all())
    greedy = (full.argmax(-1) == cached.argmax(-1)).float().mean().item()
    emit("forward_logits", model=model, layers=cfg.num_layers, quant=quant,
         tokens=list(prompt.shape), max_abs_diff_vs_prefill=err, bound=bound,
         max_abs_logit=cached.abs().max().item(), greedy_agree_share=greedy,
         finite=finite)
    if not (finite and full.shape == (2, 256, cfg.vocab_size) and err <= bound):
        raise AssertionError(f"forward_logits ({model}): {err} from the cached "
                             f"prefill > {bound}, or non-finite / misshapen")


def storage_forms_bitwise(stored: str = "mixed", packed: str = "mixed-packed",
                          impl_kw: dict | None = None) -> None:
    """Packing w4 experts changes bytes, not outputs: int8-stored and
    nibble-packed params of one seed give bitwise equal logits on the card
    (``stored`` / ``packed``: what ``prepare`` takes; per channel K2 against
    K4, flex K8 against K4f; with ``impl_kw={"fused_ffn": True}`` K12
    against K13)."""
    import numpy as np
    import torch

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
    for quant in (stored, packed):
        params, impl = prepare(floats, cfg, quant, impl_kw=impl_kw)
        cache = _init_cache(cfg, b, 512, True, dev)
        lg, cache = forward_cached(params, prompt, cache, cfg, impl,
                                   valid_lengths=valid0)
        out = [lg[rows, (valid0 - 1).long()]]
        for i in range(steps):
            if quant == stored:               # the first form's greedy tokens
                fed.append(out[-1].argmax(-1).to(torch.int32)[:, None])
            lg, cache = forward_cached(params, fed[i], cache, cfg, impl)
            out.append(lg[:, 0])
        logits[quant] = torch.stack(out)
        del params, cache
    torch.cuda.synchronize()
    same = torch.equal(logits[stored], logits[packed])
    emit("storage", stored=stored, packed=packed, layers=cfg.num_layers,
         fused_ffn=impl.fused_ffn,
         prefill_valid=valid0.tolist(), decode_steps=steps, int8_kv=True,
         bitwise_equal=same,
         max_abs_diff=(logits[stored].float()
                       - logits[packed].float()).abs().max().item(),
         finite=bool(torch.isfinite(logits[stored]).all()))
    if not (same and torch.isfinite(logits[stored]).all()):
        raise AssertionError(f"{stored} and {packed} logits differ on the card")


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _reckoned_bytes(cfg, quant: str, pack: bool, int8_kv: bool, slots: int,
                    max_len: int, int8_head: bool = False) -> dict:
    """The bytes of each part of the served model as the storage code lays
    them out, reckoned from the config: routed experts and the shared expert
    of the MoE layers (codes, f32 scales per channel or per group of GSIZE
    codes, zero points where the form keeps them, the per-expert markers), the
    bf16 attention of every layer (GQA or MLA), ds2's bf16 dense MLP, the
    embedding, the head (bf16 or int8 + f32 scales), norms and routers, the
    KV cache (MLA: one
    K / V per head, K at the padded width), and their total; to print beside
    the measured tensor sizes and the peak."""
    from mxmoe_tpu_torch.quant.schemes import parse_scheme
    from mxmoe_tpu_torch.serving.bench_serving import MIXES

    from mxmoe_tpu_torch.serving.kv_cache import mla_cache_k_dim

    h, n, e, nl = (cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts,
                   cfg.num_moe_layers)
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
    elif quant in MIXES:            # shared expert per-channel w8a8
        _, pack_w4, _ = MIXES[quant]
        flex = quant.startswith("flex")
        packed = (e + 1) // 2 if pack_w4 else 0     # even experts are the w4 ones
        experts = nl * (packed * codes // 2 + (e - packed) * codes
                        + e * 2 * scale_bytes(n, flex)          # scales and zp
                        + e * 2 * 4                             # act bits
                        + flex * e * (h // GSIZE + n // GSIZE) * 4   # act gsize
                        + pack_w4 * 2 * e * 8)                  # blk / pf
        shared = nl * (shared_codes + scale_bytes(sn, False) + 8)
    elif quant in FLOAT_ARMS:
        experts, shared = nl * e * codes * 2, shared_bf16
    else:                           # uniform: codes, scales and zp
        grouped = parse_scheme(quant).w_gsize != -1
        experts = nl * e * (codes // (2 if pack else 1)
                            + 2 * scale_bytes(n, grouped))
        shared = shared_bf16
    if cfg.attention_type == "mla":
        n_h, r, d_v = cfg.num_heads, cfg.kv_lora_rank, cfg.v_head_dim
        attn = (h * n_h * cfg.qk_head_dim + h * (r + cfg.qk_rope_head_dim) + r
                + r * n_h * (cfg.qk_nope_head_dim + d_v) + n_h * d_v * h)
        n_kv, k_dim, v_dim = n_h, mla_cache_k_dim(cfg), d_v
    else:
        attn = (2 * h * cfg.q_dim + 2 * h * cfg.kv_dim
                + cfg.attention_bias * (cfg.q_dim + 2 * cfg.kv_dim))
        n_kv, k_dim, v_dim = cfg.num_kv_heads, cfg.head_dim, cfg.head_dim
    pos = (k_dim + v_dim) * (1 if int8_kv else 2) + (8 if int8_kv else 0)
    out = {"experts": experts, "shared_expert": shared,
           "attention": cfg.num_layers * attn * 2,
           "dense_mlp": cfg.first_dense_layers * 3 * h * cfg.dense_intermediate_size * 2,
           "embed": cfg.vocab_size * h * 2,
           "head": h * cfg.vocab_size * (1 if int8_head else 2)
                   + cfg.vocab_size * 4 * int8_head,
           # norms (two a layer and the final one), routers, shared-expert gates
           "other": 2 * (2 * cfg.num_layers * h + h + nl * h * e
                         + nl * h * (cfg.has_shared_expert_gate and sn > 0)),
           "kv_cache": cfg.num_layers * slots * n_kv * max_len * pos}
    out["total"] = sum(out.values())
    return out


def serve(layers: int, quant: str, int8_kv: bool, expect: tuple,
          pack: bool = False, int8_head: bool = False,
          impl_kw: dict | None = None, absent: tuple = (),
          model: str = "qwen2_moe") -> dict:
    """The Engine over ``model`` at its published widths, ``layers`` deep
    (set up one MoE layer at a time: ``_served_model``), answering 4
    requests; returns the kernels' launch counts of this serve.
    ``quant``, ``pack``, ``int8_head`` and ``impl_kw`` as ``prepare`` takes
    them; the kernels in ``expect`` must launch, those in ``absent`` not."""
    import numpy as np
    import torch

    from mxmoe_tpu_torch.ops import kernels
    from mxmoe_tpu_torch.serving.engine import Engine, EngineConfig

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, params, impl = _served_model(layers, 0, model, quant, pack, int8_head,
                                      impl_kw)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    nbytes = {"experts": 0, "shared_expert": 0, "attention": 0, "dense_mlp": 0,
              "embed": _tensor_bytes([params["embed"]]), "head": 0, "other": 0}
    attn_keys = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "kv_a", "kv_a_norm", "kv_b")
    for stack in (params["layers"], params.get("dense_layers", {})):
        for k, v in stack.items():
            key = ("experts" if k.startswith(("expert_", "act_bits_g", "act_bits_d",
                                              "act_gsize_"))
                   else "shared_expert" if k.startswith(("shared_gate_up",
                                                         "shared_down",
                                                         "act_bits_shared",
                                                         "shared_wo"))
                   else "attention" if k in attn_keys
                   else "dense_mlp" if k.startswith("mlp_")
                   else "other")
            nbytes[key] += _tensor_bytes([v])
    for k, v in params.items():
        if k.startswith("lm_head"):
            nbytes["head"] += _tensor_bytes([v])
        elif k == "final_norm":
            nbytes["other"] += _tensor_bytes([v])
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
    nbytes["total"] = sum(nbytes.values())
    emit("serve", model=model, layers=cfg.num_layers, quant=quant, packed=pack,
         int8_kv=int8_kv, decode_attn=impl.decode_attn,
         int8_head=int8_head, mixed_weight_only=impl.mixed_weight_only,
         fused_ffn=impl.fused_ffn, dispatch_align=impl.dispatch_align,
         gmm_backend=impl.gmm_backend, requests=len(prompts), prompt_lens=[len(p) for p in prompts],
         max_new=max_new, tokens=toks, init_s=t_init, prefill_ms=t_prefill * 1e3,
         decode_s=t_decode, decode_tok_s=decoded / t_decode,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         init_max_memory_allocated=init_peak, measured_bytes=nbytes,
         reckoned_bytes=_reckoned_bytes(cfg, quant, pack, int8_kv, slots, max_len,
                                        int8_head),
         launches=launches)
    if any(len(t) != max_new or not all(0 <= x < cfg.vocab_size for x in t)
           for t in toks):
        raise AssertionError("serve: a request came back short or out of vocab")
    missing = [k for k in expect if launches[k] <= 0]
    if missing:
        raise AssertionError(f"serve ({quant}): kernels never launched on the "
                             f"main path: {missing}")
    stray = [k for k in absent if launches[k]]
    if stray:
        raise AssertionError(f"serve ({quant}, {impl_kw}): kernels launched that "
                             f"this path must not take: {stray}")
    del eng, params
    return launches


def float_arms_agree() -> None:
    """The two arms of the float path, K11 and the stock grouped product, on
    one 4-layer full-width model and the same tokens (a 256-token prefill
    chunk, then 4 decode steps fed the K11 arm's greedy tokens): each arm's
    grouped products stand within their accumulation bound of the exact
    product (kernels phase), so the bf16 logits agree within the parity bound
    of the CUDA-vs-CPU runs, PARITY_ULPS bf16 ulps at max|logits|."""
    import numpy as np
    import torch

    from mxmoe_tpu_torch.ops import kernels
    from mxmoe_tpu_torch.serving.decode import forward_cached

    cfg, floats = _full_width_model(4, seed=3)
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    b, chunk, steps = 2, 256, 4
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, chunk)).astype(np.int32),
                             device=dev)
    logits, fed, launches = {}, [], {}
    for arm in ("bf16-k11", "none"):
        params, impl = prepare(floats, cfg, arm)
        cache = _init_cache(cfg, b, 512, False, dev)
        kernels.reset_launch_counts()
        lg, cache = forward_cached(params, prompt, cache, cfg, impl)
        out = [lg[:, -1]]
        for i in range(steps):
            if arm == "bf16-k11":
                fed.append(out[-1].argmax(-1).to(torch.int32)[:, None])
            lg, cache = forward_cached(params, fed[i], cache, cfg, impl)
            out.append(lg[:, 0])
        logits[arm] = torch.stack(out).float()
        launches[arm] = kernels.launches["gmm_bf16"]
    torch.cuda.synchronize()
    a, c = logits["bf16-k11"], logits["none"]
    err = (a - c).abs().max().item()
    bound = min(PARITY_BOUND, PARITY_ULPS * bf16_ulp(a.abs().max()).item())
    emit("float_arms", layers=cfg.num_layers, decode_steps=steps, max_abs_diff=err,
         bound=bound, max_abs_logit=a.abs().max().item(),
         gmm_bf16_launches=launches, finite=bool(torch.isfinite(a).all()))
    if not (torch.isfinite(a).all() and err <= bound):
        raise AssertionError(f"float arms: K11 and the stock product differ by "
                             f"{err} > {bound}")
    if launches["bf16-k11"] != 2 * cfg.num_layers * (1 + steps) or launches["none"]:
        raise AssertionError(f"float arms: unexpected K11 launches {launches}")


def bench_entry_point(quant_args: list, expect: tuple, absent: tuple = ()) -> None:
    """The bench_serving entry point as a user calls it, at a small depth;
    its launch counts are set to 0 before the call and read after it: the
    kernels in ``expect`` must launch, those in ``absent`` not."""
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
    stray = [k for k in absent if launches[k]]
    if missing or stray:
        raise AssertionError(f"bench_serving {quant_args}: kernels never "
                             f"launched: {missing}; launched but must not: {stray}")
    keys = {"model", "layers", "slots", "quant", "int8_head", "int8_kv",
            "prefill_ms", "prefill_tokens_per_s", "decode_attn", "decode_step_ms",
            "decode_tokens_per_s", "device"}
    if not (keys <= set(res) and res["decode_tokens_per_s"] > 0
            and res["prefill_ms"] > 0
            and res["int8_kv"] is ("--int8-kv" in quant_args)
            and res["int8_head"] is ("--int8-head" in quant_args)
            and res["decode_attn"] == (quant_args[quant_args.index("--decode-attn") + 1]
                                       if "--decode-attn" in quant_args else "auto")):
        raise AssertionError(f"bench_serving: unexpected result {res}")


def headline_bench() -> int:
    """``bench/headline.py`` in the process, at the workload's full shapes:
    the mixed one-launch arm and the bucketed arm. Each arm's outputs (K15)
    are held bitwise against its ``--no-ws`` arm's (K2; K5 + K2) on one call;
    then each arm runs as its entry point does and prints its JSON line.
    Returns K15's launches in the one-launch arm's run."""
    import numpy as np
    import torch

    from mxmoe_tpu_torch.bench import headline, workloads
    from mxmoe_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(42)
    operands = [headline.build_fp_operands(wl, gen, dev)
                for wl in workloads.qwen2_moe_l10_bs8192()]
    masks = [np.arange(len(op[2])) % 2 == 0 for op in operands]
    for label, prep, make in (
            ("onelaunch", headline.quantize_weights_mixed_onelaunch,
             headline.mixed_onelaunch_step),
            ("bucketed", headline.quantize_weights_mixed, headline.mixed_bucketed_step)):
        q = prep(operands, masks)
        ws = make(q, ws=True)()
        no_ws = make(q, ws=False)()
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(ws, no_ws)):
            _require_equal(a, b, f"headline {label} output {i}: K15 vs --no-ws")
        emit("headline", arm=label, ws_equals_no_ws=True, outputs=len(ws),
             finite=all(bool(torch.isfinite(o).all()) for o in ws))
        del q, ws, no_ws
    del operands
    torch.cuda.empty_cache()
    counts = {}
    for argv in ([], ["--bucketed"]):
        kernels.reset_launch_counts()
        res = headline.main(argv)
        counts[" ".join(argv) or "mixed"] = kernels.launches["gmm_ws"]
        if not (kernels.launches["gmm_ws"] > 0 and res["value"] > 0
                and res["vs_baseline"] > 0):
            raise AssertionError(f"headline {argv}: K15 never launched or no result")
    emit("headline", gmm_ws_launches=counts)
    return counts["mixed"]


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
    from mxmoe_tpu_torch.bench import timing
    emit("timing", device_ms_lost_traces=timing.LOST_TRACES[0])
    fused, aligned = {"fused_ffn": True}, {"dispatch_align": 32}
    for quant, int8_kv, pack, impl_kw in (("w8a8_g-1_sym", False, False, None),
                                          ("mixed-packed", True, False, None),
                                          ("w4a16_g128_asym", False, True, None),
                                          ("flex-shared-grouped", False, False, None),
                                          ("flex-wo", False, False, None),
                                          ("flex-packed", False, False, None),
                                          ("bf16-k11", False, False, None),
                                          ("mixed-packed", True, False, fused),
                                          ("w8a8_g-1_sym", False, False, fused),
                                          ("w8a8_g-1_sym", False, False, aligned)):
        torch.cuda.empty_cache()
        slice_parity(quant, int8_kv, pack, impl_kw)
    # ds2 at full width, its dense first layer and two MoE layers (MLA over
    # the 256-lane K cache: K3q at dk 256, G 1)
    torch.cuda.empty_cache()
    slice_parity("mixed-packed", True, model="ds2", layers=3)
    for model, layers in (("qwen2_moe", 2), ("ds2", 3)):
        torch.cuda.empty_cache()
        forward_logits_vs_prefill(model, layers)
    torch.cuda.empty_cache()
    storage_forms_bitwise()
    torch.cuda.empty_cache()
    storage_forms_bitwise("flex", "flex-packed")
    torch.cuda.empty_cache()
    storage_forms_bitwise("mixed", "mixed-packed", fused)
    torch.cuda.empty_cache()
    float_arms_agree()
    k1, k3, k3q = ("quantize_rows", "decode_attention_update_stacked",
                   "decode_attention_update_stacked_q8")
    k4f, k10, k11 = "gmm_mixed_packed_flex", "gmm_mixed_wo_wxa", "gmm_bf16"
    k12, k13 = "gmm_ffn_w8a8", "gmm_ffn_mixed_packed"
    # name -> (layers, quant, int8 KV, packed, int8 head, kernels that must
    # launch[, MoEImpl fields[, kernels that must not[, model]]]); a kernel's
    # launches in the last line are those of the serve that `counts` below
    # names for it
    serves = {
        "uniform": (4, "w8a8_g-1_sym", False, False, False, (k1, "gmm_w8a8", k3)),
        "packed_w4": (4, "w4a8_g-1_sym", False, True, False,
                      (k1, "gmm_w4a8_packed", k3)),
        "mixed": (4, "mixed-packed", True, False, False,
                  (k1, "gmm_w8a8", k3q, "gmm_mixed_packed")),
        "a16_packed": (4, "w4a16_g128_asym", False, True, False,
                       ("gmm_weight_only_packed", k3)),
        "grouped": (4, "w4a4_g128_sym", False, False, False,
                    ("gmm_w8a8_grouped", k3)),
        "asym": (4, "w8a8_g-1_asym", False, False, False, (k1, "gmm_w8a8_asym", k3)),
        "a16": (4, "w4a16_g-1_sym", False, False, False, ("gmm_weight_only", k3)),
        "flex": (4, "flex-shared-grouped", False, False, False,
                 ("gmm_w8a8_grouped", k3)),
        "flex_a16": (4, "flex-shared-a16", False, False, False,
                     ("gmm_w8a8_grouped", "gmm_weight_only", k3)),
        # the two-launch branches (4 layers; the 24-layer serve is the fused one)
        "flex_wo": (4, "flex-wo", False, False, False, (k1, "gmm_w8a8", k10, k3)),
        "flex_packed": (4, "flex-packed", True, False, False,
                        (k1, "gmm_w8a8", k4f, k3q)),
        "mixed_wo": (4, "mixed-wo", False, False, False, (k1, k10, k3)),
        "bf16_k11": (4, "bf16-k11", False, False, False, (k11, k3)),
        "bf16_stock": (4, "none", False, False, False, (k3,)),
        "int8_head": (4, "w8a8_g-1_sym", False, False, True, (k1, "gmm_w8a8", k3)),
        # the whole expert FFN in one launch: the full 24 layers for K13
        "mixed_fused": (24, "mixed-packed", True, False, False,
                        (k13, k1, "gmm_w8a8", k3q), fused, ("gmm_mixed_packed",)),
        "uniform_fused": (4, "w8a8_g-1_sym", False, False, False, (k12, k1, k3),
                          fused, ("gmm_w8a8",)),
        "uniform_auto": (4, "w8a8_g-1_sym", False, False, False, (k12, k1, k3),
                         {"fused_ffn": "auto"}, ("gmm_w8a8",)),
        "uniform_aligned": (4, "w8a8_g-1_sym", False, False, False,
                            (k1, "gmm_w8a8", k3), aligned, (k12,)),
        "flex_fused": (4, "flex", False, False, False, ("gmm_w8a8_grouped", k3),
                       fused, (k12, k13)),
        # the plain decode attention (scatter + attention): no K3
        "uniform_xla": (4, "w8a8_g-1_sym", False, False, False, (k1, "gmm_w8a8"),
                        {"decode_attn": "xla"}, (k3, k3q)),
        # ds2 at the full 27 layers (1 dense + 26 MoE): MLA through K3q at dk
        # 256, mixed-packed routed experts, w8a8 shared experts, the int8 head
        "ds2": (27, "mixed-packed", True, False, True,
                (k3q, k1, "gmm_mixed_packed", "gmm_w8a8"), None, (k3,), "ds2"),
        # GQA at G 4 / 7, full width, 4 layers; mixtral has no shared expert
        "mixtral": (4, "w8a8_g-1_sym", False, False, False, (k1, "gmm_w8a8", k3),
                    None, (), "mixtral"),
        "qwen2_57b": (4, "w8a8_g-1_sym", False, False, False, (k1, "gmm_w8a8", k3),
                      None, (), "qwen2_moe_57b"),
    }
    ran = {}
    for name, (layers, quant, int8_kv, pack, head, expect, *extra) in serves.items():
        torch.cuda.empty_cache()
        impl_kw, absent, model = (*extra, *SERVE_DEFAULTS[len(extra):])
        ran[name] = serve(layers, quant, int8_kv, expect, pack, head, impl_kw, absent,
                          model)
    # the flex serves go through K8 only: no K1, K2 or K9 for the routed
    # experts, and the grouped shared expert adds two K8 launches a layer
    if ran["flex"]["gmm_w8a8_grouped"] != 2 * ran["grouped"]["gmm_w8a8_grouped"]:
        raise AssertionError("the grouped shared expert did not go through K8: "
                             f"{ran['flex']} against {ran['grouped']}")
    # the stock arm of the float path launches no kernel of K11's, the int8
    # head one more K1 and K2 a forward than the float head
    if ran["bf16_stock"][k11] or not (ran["int8_head"]["gmm_w8a8"]
                                      > ran["uniform"]["gmm_w8a8"]):
        raise AssertionError(f"unexpected launches: stock float arm "
                             f"{ran['bf16_stock']}, int8 head {ran['int8_head']}")
    torch.cuda.empty_cache()
    bench_entry_point(["--quant", "mixed-packed", "--int8-kv"],
                      (k1, "gmm_w8a8", "gmm_mixed_packed", k3q))
    torch.cuda.empty_cache()
    bench_entry_point(["--quant", "w4a16_g128_asym"], ("gmm_weight_only", k3))
    torch.cuda.empty_cache()
    bench_entry_point(["--quant", "none"], (k3,))
    torch.cuda.empty_cache()
    bench_entry_point(["--quant", "w8a8_g-1_sym", "--int8-head"],
                      (k1, "gmm_w8a8", k3))
    torch.cuda.empty_cache()
    bench_entry_point(["--quant", "mixed-packed", "--int8-kv", "--fused-ffn", "on"],
                      (k13, k1, "gmm_w8a8", k3q))
    for attn, expect, absent in (("auto", (k3q,), ()), ("xla", (), (k3q, k3))):
        torch.cuda.empty_cache()
        bench_entry_point(["--model", "ds2", "--quant", "mixed-packed", "--int8-kv",
                           "--decode-attn", attn],
                          (k1, "gmm_w8a8", "gmm_mixed_packed", *expect), absent)
    torch.cuda.empty_cache()
    ws_launches = headline_bench()
    # one path per number: a kernel's launches are those of the full-depth
    # serve that runs it, else of the 4-layer serve that does
    counts = {"ds2": (k3q, k1, "gmm_w8a8", "gmm_mixed_packed"), "mixed_fused": (k13,),
              "uniform": (k3,), "flex_wo": (k10,), "flex_packed": (k4f,),
              "packed_w4": ("gmm_w4a8_packed",), "a16_packed": ("gmm_weight_only_packed",),
              "grouped": ("gmm_w8a8_grouped",), "asym": ("gmm_w8a8_asym",),
              "a16": ("gmm_weight_only",), "bf16_k11": (k11,), "uniform_fused": (k12,)}
    launches = {}
    for name, kernel_names in counts.items():
        layers, quant, int8_kv, pack, head, _, *extra = serves[name]
        impl_kw, _, model = (*extra, *SERVE_DEFAULTS[len(extra):])
        label = (f"serve {model} {quant}{' packed' if pack else ''}"
                 f"{' int8-kv' if int8_kv else ''}{' int8-head' if head else ''}"
                 f"{' fused' if impl_kw else ''} {layers} layers")
        for kn in kernel_names:
            launches[kn] = (ran[name][kn], label)
    for name in ("gmm_w8a8_fusedquant", *READ_ONLY_ATTENTION):
        launches[name] = (0, "kernels phase only: no serve reaches it in either "
                             "package")
    launches["gmm_ws"] = (ws_launches, "headline bench, mixed one-launch arm")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name][0], "launches_of": launches[name][1],
         "max_abs_err": rec[name]["max_abs_err"],
         "ms": rec[name]["ms"], "device_ms": rec[name]["device_ms"],
         "plain_ms": rec[name]["plain_ms"],
         "bound_ms": rec[name]["bound_ms"], "bound_by": rec[name]["bound_by"],
         "library_ms": rec[name].get("library_ms"),
         "library_device_ms": rec[name].get("library_device_ms"),
         **({"schedule": rec[name]["schedule"]} if "schedule" in rec[name] else {})}
        for name, (src, rep) in KERNEL_SOURCES.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
