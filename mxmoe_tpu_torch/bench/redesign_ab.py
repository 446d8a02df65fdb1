"""The redesigned kernel bodies against the bodies they replaced, in one
process on one card, at the shapes of the main path, by device time
(``bench.timing.device_ms``) and event time, old and new in ABBA order. Fourteen
case sets, each against the csrc of the commit before its redesign:

* ``gmm`` (against a csrc before the m16 decode schedule of
  ``gmm_int8_tile.cuh``): the int8 grouped GEMM, K2, K4, K5, K9, at decode;
* ``attention`` (before the warp-chunk body of ``decode_attention_tile.cuh``):
  decode attention, K3, K3q and the read-only forms;
* ``ffn`` (before the cluster body of ``gmm_ffn_tile.cuh``, when one block
  took an m-tile and hq went through a device workspace): the whole expert
  FFN, K12 and K13 (every other expert packed), qwen2_moe widths over the
  32-row aligned dispatch at 16 and 64 routed rows and a 256-token prefill
  chunk, with the clusters the new body's grid holds (``resident_clusters``:
  more live m-tiles than that run in rounds);
* ``grouped`` (against the csrc of the m16 decode kernel of
  ``gmm_grouped_tile.cuh`` before it became a device body shared with K10;
  its C entry points take the schedule): the grouped-scale GEMMs at decode,
  K8 and K4f (every other expert packed, or all), g128, qwen2_moe's routed
  gate_up and down products at 16 routed rows and (K8) its grouped shared
  expert (E = 1, M 4), without and with zero points: the refactor leaves
  both bitwise and, within the noise, as fast;
* ``weight_only`` (before the m16 decode body of
  ``gmm_weight_only_tile.cuh``, when every M took the 32 x 128 body and K10
  ran the 32 x 128 bodies of K6 and K8): K6, K7 (the same codes packed) and
  K10 (flex body, experts alternating, g128 with zero points) at
  qwen2_moe's routed gate_up and down products at 16 routed rows, and K6
  and K7 for its weight-only shared expert (E = 1, M 4). Old and new sum K
  in other orders: each is held within ``gmm_weight_only.error_over_bound``
  of the float64 product, the new K7 bitwise the new K6, and K10's w x a
  rows old and new bitwise;
* ``ws`` (before the wgmma body of ``gmm_ws.cu``, when a block held a
  full-K 64-column weight slice in shared memory): K15 in both forms (int8,
  nibble-packed) at the headline workload's gate_up and down products, every
  expert's rows padded to 128, bitwise old = new, beside K2 / K5 on the same
  codes and, labelled as another function (bf16 operands: the headline's
  baseline, not K15's product), ``torch._grouped_mm`` on the same rows;
* ``act_quant`` (before K1 kept its rows in registers): K1 at the
  headline's rows (36736 x 2048 / 1408, the shared expert's 8192 x 5632),
  prefill chunks (4096 and 1024 x 2048) and decode (16 x 2048), bf16,
  per-row bits 4 / 8 / 16 and a gain, codes and scales bitwise old = new;
* ``int8_large`` (before K2 / K5 above the decode rows took the wgmma body
  with group sizes read on the device): K2 and K5 through their wrappers
  (the body ``int8_gmm_schedule`` picks, printed) against the 64 x 128
  mma.sync body, at the prefill chunks of qwen2_moe (M 1024 over 60
  experts) and ds2 (M 1536 over 64), the int8 shared expert's prefill (one
  group, M 256), qwen2_moe's routing at M 68 / 128 / 512 / 4096 / 8192 and the
  headline's rows (32762 unaligned, 36736 aligned, where K15 on the same
  codes is timed beside), bitwise old = new (= K15);
* ``fusedquant`` (before K14's redesign, when every M took the 64 x 128
  body and each n-tile block quantized its rows again): K14 at qwen2_moe's
  gate_up, decode (M 16), a prefill chunk (M 1024) and the headline's rows
  (32762), bf16 activations, bitwise old = new = K1 + K2, with K1 + K2 (the
  package's kernels) timed beside;
* ``bf16_large`` (before K11's bf16 operands took the persistent wgmma body
  at every row count): K11 through its wrapper against the 32 x 128
  mma.sync body at ``workloads.k11_shapes``: the prefill chunks of
  qwen2_moe (M 1024 over 60 experts) and ds2 (M 1536 over 64), qwen2_moe's
  routing at the decode rows and just above them (M 16 / 40 / 68 / 80 / 96
  / 112 / 128, gate_up and down) and at M 512 / 4096,
  the profiler's three scales (M 8192 / 32768 / 65536, gate_up) and the
  headline's 32762 rows (gate_up and down); old and new sum K in other
  orders, so each, and ``torch._grouped_mm`` timed beside them, is held
  within ``gmm.error_over_bound`` of the float64 product;
* ``wo_prefill`` (before K6 / K7 / K10 above the decode rows took the
  persistent wgmma bodies of ``gmm_wq_body.cuh``): K6, K7 (the same 4-bit
  codes packed) and K10 (flex body, experts alternating, g128 with zero
  points) through their wrappers (the body ``weight_only_gmm_schedule``
  picks, printed) against the 32 x 128 mma.sync bodies, at qwen2_moe's
  routing at M 68 / 128 / 256 / 512 (gate_up), its prefill chunk (M 1024,
  gate_up and down) and M 8192 / 65536 (gate_up): each held within
  ``gmm_weight_only.error_over_bound``, the new K7 and K10's weight-only
  rows bitwise the new K6, K10's w x a rows old and new bitwise;
* ``grouped_prefill`` (the same commit, K8): K8 through its wrapper
  against the 32 x 128 body at the same rows, g128 without and with zero
  points and one group, bitwise old = new;
* ``mixed_prefill`` (before K4 / K4f above the decode rows took the wgmma
  bodies over their ragged storage): K4 (every other expert packed) against
  the 64 x 128 mma.sync tile and K4f (g128 with zero points, every other
  expert packed, then all) against the 32 x 128 body, through their
  wrappers (the body the schedule picks, printed), at qwen2_moe's routing
  at M 68 / 512, its prefill chunk (M 1024, gate_up and down), M 8192, the
  headline's 32762 rows and M 65536 (gate_up), bitwise old = new = K2 / K8
  on the same codes, whose device times are printed beside (K5 / K8 on the
  same codes for the all-packed K4f: whether L2 keeps a packed expert's
  second read off HBM);
* ``asym_prefill`` (the same commit, K9): K9 against the 64 x 128 tile at
  the same rows, bitwise old = new = K8 with one group and zero points,
  whose device time is printed beside.

    python -m mxmoe_tpu_torch.bench.redesign_ab --old-csrc DIR [--cases ffn]

DIR holds the earlier ``mxmoe_tpu_torch/csrc`` (for example
``git archive <commit> mxmoe_tpu_torch/csrc | tar -x -C DIR
--strip-components 2``) in a directory that git ignores. The case sets'
earlier sources are built into a library of their own with nvcc and called
through their own C entry points, with the argument lists they had
(``_OLD``); nothing in the package changes. Both outputs are compared
(the GEMMs and the FFN bitwise). One JSON line per case: both times, the
bound (bytes of this case's inputs and outputs over 3.35 TB/s, or
operations over the int8 / bf16 peak) and the new body's share of it; for
the bf16 attention cases also ``scaled_dot_product_attention``'s times. Then
the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import subprocess
import tempfile

import torch

from ..models import configs
from ..ops import gmm_mixed_packed as gmp, gmm_w4a8_packed as g4p
from ..ops import gmm_w8a8 as gmm, gmm_w8a8_asym as gas, kernels
from ..ops.dispatch import make_dispatch, route_topk
from ..quant.packing import build_ragged_mixed, pack_int4_halves
from ..serving import decode_attention as da
from ..utils.device import find_nvcc
from . import timing
from .timing import device_ms, event_ms

REPS = 25          # timed calls a reading, as chip_smoke.py
HBM = 3.35e12
PEAK = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# case set -> (earlier sources, their C entry points' argument lists)
_OLD = {
    "gmm": (("gmm_w8a8.cu", "gmm_mixed_packed.cu", "gmm_w4a8_packed.cu",
             "gmm_w8a8_asym.cu"), {
        "mxmoe_gmm_w8a8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "mxmoe_gmm_mixed_packed": [_P] * 8 + [_I] * 5 + [_P],
        "mxmoe_gmm_w4a8_packed": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "mxmoe_gmm_w8a8_asym": [_P] * 7 + [_I] * 5 + [_P]}),
    "attention": (("decode_attention.cu",), {
        "mxmoe_decode_attention_update": [_P, _P, _P, _I] + [_P] * 6 + [_I] * 7
                                         + [_F, _P],
        "mxmoe_decode_attention_update_q8": [_P, _P, _P, _I] + [_P] * 8 + [_I] * 7
                                            + [_F, _P],
        "mxmoe_decode_attention": [_P, _I] + [_P] * 5 + [_I] * 7 + [_F, _P],
        "mxmoe_decode_attention_q8": [_P, _I] + [_P] * 7 + [_I] * 7 + [_F, _P],
        "mxmoe_decode_attention_workspace_floats": [_I] * 5}),
    # ..., hq workspace, out, out_is_bf16, M, K, N, H, E, stream
    "ffn": (("gmm_ffn_w8a8.cu", "gmm_ffn_mixed_packed.cu"), {
        "mxmoe_gmm_ffn_w8a8": [_P] * 10 + [_I] * 6 + [_P],
        "mxmoe_gmm_ffn_mixed_packed": [_P] * 14 + [_I] * 6 + [_P]}),
    # ..., out, out_is_bf16, M, K, N, E, gsize, schedule, stream
    "grouped": (("gmm_w8a8_grouped.cu", "gmm_mixed_packed.cu"), {
        "mxmoe_gmm_w8a8_grouped": [_P] * 7 + [_I] * 6 + [_I] * 4 + [_P] * 3,
        "mxmoe_gmm_mixed_packed_flex": [_P] * 9 + [_I] * 6 + [_I] * 4 + [_P] * 3}),
    # ..., out, out_is_bf16, M, K, N, E, gsize, stream (no schedule)
    "weight_only": (("gmm_weight_only.cu", "gmm_weight_only_packed.cu",
                     "gmm_mixed_wo_wxa.cu"), {
        "mxmoe_gmm_weight_only": [_P] * 6 + [_I] * 6 + [_P],
        "mxmoe_gmm_weight_only_packed": [_P] * 6 + [_I] * 6 + [_P],
        "mxmoe_gmm_mixed_wo_wxa": [_P] * 9 + [_I] * 6 + [_P]}),
    # lhs, s_a, rhs, s_b, static sizes (host ints), out, packed, out_is_bf16,
    # M, K, N, E, stream
    "ws": (("gmm_ws.cu",), {"mxmoe_gmm_ws": [_P] * 6 + [_I] * 6 + [_P]}),
    # x, x_is_bf16, bits, gain, q, scale, M, K, stream
    "act_quant": (("act_quant.cu",), {
        "mxmoe_quantize_rows": [_P, _I, _P, _F, _P, _P, _I, _I, _P]}),
    # lhs, s_a, rhs, s_b, group_sizes, out, out_is_bf16, M, K, N, E, bm,
    # grid_m, splits, k_tiles_per_split, workspace, tickets, stream
    "int8_large": (("gmm_w8a8.cu", "gmm_w4a8_packed.cu"), {
        "mxmoe_gmm_w8a8": [_P] * 6 + [_I] * 5 + [_I] * 4 + [_P] * 3,
        "mxmoe_gmm_w4a8_packed": [_P] * 6 + [_I] * 5 + [_I] * 4 + [_P] * 3}),
    # lhs, lhs_is_bf16, rhs, s_b, group_sizes, out, out_is_bf16, upper, M, K,
    # N, E, stream
    "fusedquant": (("gmm_w8a8_fusedquant.cu",), {
        "mxmoe_gmm_w8a8_fusedquant": [_P, _I, _P, _P, _P, _P, _I, _F] + [_I] * 4
                                     + [_P]}),
    # lhs, rhs, group_sizes, out, in_is_bf16, out_is_bf16, M, K, N, E, stream
    "bf16_large": (("gmm_bf16.cu",), {
        "mxmoe_gmm_bf16": [_P] * 4 + [_I] * 6 + [_P]}),
    # ..., out, out_is_bf16, M, K, N, E, gsize, schedule (bm, grid_m, splits,
    # k_tiles_per_split, workspace, tickets), stream
    "wo_prefill": (("gmm_weight_only.cu", "gmm_weight_only_packed.cu",
                    "gmm_mixed_wo_wxa.cu"), {
        "mxmoe_gmm_weight_only": [_P] * 6 + [_I] * 6 + [_I] * 4 + [_P] * 3,
        "mxmoe_gmm_weight_only_packed": [_P] * 6 + [_I] * 6 + [_I] * 4 + [_P] * 3,
        "mxmoe_gmm_mixed_wo_wxa": [_P] * 9 + [_I] * 6 + [_I] * 4 + [_P] * 3}),
    "grouped_prefill": (("gmm_w8a8_grouped.cu",), {
        "mxmoe_gmm_w8a8_grouped": [_P] * 7 + [_I] * 6 + [_I] * 4 + [_P] * 3}),
    # lhs, s_a, rhs_cat, s_b, (zp,) group_sizes, pflags, blk_offsets, out,
    # out_is_bf16, M, K, N, E, (gsize,) schedule, stream: no rows of rhs_cat
    "mixed_prefill": (("gmm_mixed_packed.cu",), {
        "mxmoe_gmm_mixed_packed": [_P] * 8 + [_I] * 5 + [_I] * 4 + [_P] * 3,
        "mxmoe_gmm_mixed_packed_flex": [_P] * 9 + [_I] * 6 + [_I] * 4 + [_P] * 3}),
    # lhs, s_a, rhs, s_b, zp, group_sizes, out, out_is_bf16, M, K, N, E,
    # schedule, stream
    "asym_prefill": (("gmm_w8a8_asym.cu",), {
        "mxmoe_gmm_w8a8_asym": [_P] * 7 + [_I] * 5 + [_I] * 4 + [_P] * 3}),
}


def build_old(old_csrc: str, cases) -> ctypes.CDLL:
    """nvcc the case sets' earlier sources (one process each, together),
    link, load."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    out_dir = tempfile.mkdtemp(dir=kernels.BUILD_DIR, prefix="old_")
    procs = []
    for name in (src for c in cases for src in _OLD[c][0]):
        obj = os.path.join(out_dir, name[:-3] + ".o")
        procs.append((obj, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-c", "-o", obj, os.path.join(old_csrc, name)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for obj, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the earlier {obj}:\n{err}")
    lib_path = os.path.join(out_dir, "libold.so")
    subprocess.run([nvcc, "-shared", "-o", lib_path,
                    *sorted(glob.glob(os.path.join(out_dir, "*.o")))], check=True)
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in (kv for c in cases for kv in _OLD[c][1].items()):
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _stream():
    return kernels.stream_ptr(torch.device("cuda"))


def _bound(nbytes: float, ops: float, kind: str) -> dict:
    tb, to = nbytes / HBM * 1e3, ops / PEAK[kind] * 1e3
    return {"bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to else "operations",
            "bytes": int(nbytes)}


def _ab(old, new, reps: int) -> dict:
    """Old and new in the order old, new, new, old, by both readings; then
    the new body's device time after a read-only L2 overwrite (no dirty
    lines to write back during the call)."""
    d = [device_ms(f, reps) for f in (old, new, new, old)]
    e = [event_ms(f, reps) for f in (old, new, new, old)]
    return {"old_device_ms": (d[0] + d[3]) / 2, "new_device_ms": (d[1] + d[2]) / 2,
            "old_event_ms": (e[0] + e[3]) / 2, "new_event_ms": (e[1] + e[2]) / 2,
            "device_ms_abba": d, "event_ms_abba": e,
            "new_device_ms_read_overwrite": device_ms(new, reps, overwrite="read")}


def _emit(case: str, **kv) -> None:
    if "bound_ms" in kv and "new_device_ms" in kv:
        kv["new_share_of_bound"] = kv["bound_ms"] / kv["new_device_ms"]
        kv["old_share_of_bound"] = kv["bound_ms"] / kv["old_device_ms"]
    print(json.dumps({"case": case, **kv}), flush=True)


# ---------------------------------------------------------------------------
# the int8 grouped GEMM
# ---------------------------------------------------------------------------

def _old_gmm(lib, fn: str, out_shape, *ptrs_and_ints):
    out = torch.empty(out_shape, dtype=torch.bfloat16, device="cuda")

    def call():
        err = getattr(lib, fn)(*ptrs_and_ints[:-5], out.data_ptr(), 1,
                               *ptrs_and_ints[-5:-1], _stream())
        kernels.check(err, "old " + fn)
        return out
    return call


def gmm_cases(lib, reps: int) -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for model, tokens, shared in (("qwen2_moe", 4, True), ("ds2", 4, True)):
        cfg = configs.config_for(model)
        h, n, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
        logits = torch.randn((tokens, e), generator=gen, device=dev)
        gs = make_dispatch(route_topk(logits, cfg.top_k, cfg.norm_topk_prob),
                           e).group_sizes
        m = tokens * cfg.top_k
        live = gs > 0
        pflags = [int(i % 2 == 0) for i in range(e)]
        pf = torch.tensor(pflags, dtype=torch.int32, device=dev)
        sn = cfg.shared_expert_intermediate_size
        shapes = [("routed", gs, m, k, nn) for k, nn in ((h, 2 * n), (n, h))]
        if shared:
            one = torch.full((1,), tokens, dtype=torch.int32, device=dev)
            shapes += [("shared", one, tokens, k, nn) for k, nn in ((h, 2 * sn), (sn, h))]
        for use, g_s, rows, k, nn in shapes:
            ee = g_s.numel()
            lv = g_s > 0
            aq = torch.randint(-127, 128, (rows, k), generator=gen, device=dev,
                               dtype=torch.int8)
            asc = torch.rand((rows, 1), generator=gen, device=dev) * 0.05
            wq = torch.randint(-127, 128, (ee, k, nn), generator=gen, device=dev,
                               dtype=torch.int8)
            wsc = torch.rand((ee, 1, nn), generator=gen, device=dev) * 0.01
            zp = torch.rand((ee, 1, nn), generator=gen, device=dev) * 0.2 - 0.1
            base = rows * (k + 4) + int(lv.sum()) * nn * 4 + ee * 4 + rows * nn * 2
            ops = 2 * rows * k * nn
            sched = gmm.int8_gmm_schedule(rows, k, nn, ee)
            shape = {"model": model, "use": use, "M": rows, "K": k, "N": nn,
                     "live_groups": int(lv.sum()), "schedule": vars(sched)}
            ints = (rows, k, nn, ee)
            runs = [("gmm_w8a8", lambda: gmm.gmm_w8a8(aq, asc, wq, wsc, g_s),
                     _old_gmm(lib, "mxmoe_gmm_w8a8", (rows, nn), aq.data_ptr(),
                              asc.data_ptr(), wq.data_ptr(), wsc.data_ptr(),
                              g_s.data_ptr(), *ints, None),
                     base + int(lv.sum()) * k * nn)]
            if use == "routed":
                runs.append(("gmm_w8a8_asym",
                             lambda: gas.gmm_w8a8_asym(aq, asc, wq, wsc, zp, g_s),
                             _old_gmm(lib, "mxmoe_gmm_w8a8_asym", (rows, nn),
                                      aq.data_ptr(), asc.data_ptr(), wq.data_ptr(),
                                      wsc.data_ptr(), zp.data_ptr(), g_s.data_ptr(),
                                      *ints, None),
                             base + int(lv.sum()) * (k + 4) * nn))
                w4 = torch.randint(-8, 8, (ee, k, nn), generator=gen, device=dev,
                                   dtype=torch.int8)
                mixed = wq.clone()
                mixed[::2] = w4[::2]
                cat, blk = build_ragged_mixed(mixed, pflags)
                blk_t = torch.tensor(blk, dtype=torch.int32, device=dev)
                packed = pack_int4_halves(w4)
                per_expert = torch.tensor([k * nn // 2 if f else k * nn for f in pflags],
                                          device=dev)
                runs.append(("gmm_mixed_packed",
                             lambda: gmp.gmm_mixed_packed(aq, asc, cat, wsc, g_s, pf,
                                                          blk_t),
                             _old_gmm(lib, "mxmoe_gmm_mixed_packed", (rows, nn),
                                      aq.data_ptr(), asc.data_ptr(), cat.data_ptr(),
                                      wsc.data_ptr(), g_s.data_ptr(), pf.data_ptr(),
                                      blk_t.data_ptr(), *ints, None),
                             base + int(per_expert[lv].sum()) + 8 * ee))
                runs.append(("gmm_w4a8_packed",
                             lambda: g4p.gmm_w4a8_packed(aq, asc, packed, wsc, g_s),
                             _old_gmm(lib, "mxmoe_gmm_w4a8_packed", (rows, nn),
                                      aq.data_ptr(), asc.data_ptr(), packed.data_ptr(),
                                      wsc.data_ptr(), g_s.data_ptr(), *ints, None),
                             base + int(lv.sum()) * k * nn // 2))
            for name, new, old, nbytes in runs:
                a, b = new(), old()
                torch.cuda.synchronize()
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} {model} {use} K={k}: new and old "
                                         "bodies differ")
                _emit(name, **shape, bitwise_old=True, **_ab(old, new, reps),
                      **_bound(nbytes, ops, "int8"))


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

def attention_cases(lib, reps: int) -> None:
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    b, s_max, nl, layer = 4, 2048, 2, 1
    lengths = torch.tensor([0, 700, s_max, 1500], dtype=torch.int32, device=dev)
    valid = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device=dev)
    n_pos = [min(max(x, 0), s_max - 1) + 1 for x in lengths.tolist()]
    mask = (torch.arange(s_max, device=dev)[None, :]
            <= lengths.clamp(max=s_max - 1)[:, None])[:, None, None, :]
    # name -> n_h, n_kv, dk, dv, qk dim (scale)
    shapes = {"qwen2_moe": (16, 16, 128, 128, 128), "ds2_mla": (16, 16, 256, 128, 192),
              "mixtral": (32, 8, 128, 128, 128), "qwen2_moe_57b": (28, 4, 128, 128, 128)}
    for shape, (n_h, n_kv, dk, dv, d_qk) in shapes.items():
        scale = 1.0 / d_qk ** 0.5
        q = torch.randn((b, n_h, dk), generator=gen, device=dev).to(torch.bfloat16)
        kn = torch.randn((b, n_kv, dk), generator=gen, device=dev).to(torch.bfloat16)
        vn = torch.randn((b, n_kv, dv), generator=gen, device=dev).to(torch.bfloat16)
        for quant in (False, True):
            if quant:
                caches = [torch.randint(-127, 128, (nl, b, n_kv, s_max, d),
                                        generator=gen, device=dev, dtype=torch.int8)
                          if d else torch.rand((nl, b, n_kv, s_max), generator=gen,
                                               device=dev) * 0.03 + 1e-3
                          for d in (dk, 0, dv, 0)]
                pos_bytes = dk + dv + 8
            else:
                caches = [torch.randn((nl, b, n_kv, s_max, d), generator=gen,
                                      device=dev).to(torch.bfloat16) if d else None
                          for d in (dk, 0, dv, 0)]
                pos_bytes = 2 * (dk + dv)
            ptrs = [c.data_ptr() for c in caches if c is not None]
            ws_old = torch.empty(lib.mxmoe_decode_attention_workspace_floats(
                b, n_h, n_kv, s_max, dv), dtype=torch.float32, device=dev)
            out_old = torch.empty((b, n_h, dv), dtype=torch.bfloat16, device=dev)
            tail = (lengths.data_ptr(), valid.data_ptr(), out_old.data_ptr(),
                    ws_old.data_ptr(), layer, b, n_h, n_kv, s_max, dk, dv, scale)
            ro_tail = tail[:1] + tail[2:]
            upd_fn = "mxmoe_decode_attention_update" + ("_q8" if quant else "")
            ro_fn = "mxmoe_decode_attention" + ("_q8" if quant else "")
            head = (q.data_ptr(), kn.data_ptr(), vn.data_ptr(), 1)

            def old_update():
                kernels.check(getattr(lib, upd_fn)(*head, *ptrs, *tail, _stream()),
                              "old " + upd_fn)
                return out_old

            def new_update():
                return da.decode_attention_update_stacked(q, kn, vn, *caches, lengths,
                                                          layer, valid=valid,
                                                          scale=scale)[0]

            def old_read():
                kernels.check(getattr(lib, ro_fn)(q.data_ptr(), 1, *ptrs, *ro_tail,
                                                  _stream()), "old " + ro_fn)
                return out_old

            def new_read():
                return da.decode_attention_stacked(q, *caches, lengths, layer,
                                                   scale=scale)[0]

            label = "K3q" if quant else "K3"
            a = new_update()
            ref = (da.decode_attention_update_q8_plain if quant else
                   (lambda q_, k_, v_, ck, cks, cv, cvs, *r:
                    da.decode_attention_update_plain(q_, k_, v_, ck, cv, *r)))(
                q, kn, vn, *[None if c is None else c.clone() for c in caches],
                lengths, layer, valid, scale)
            bb = old_update().clone()
            torch.cuda.synchronize()
            rd = new_read()
            torch.cuda.synchronize()
            ops = sum(2 * n_h * p * (dk + dv) for p in n_pos)
            upd_bytes = sum(p * n_kv * pos_bytes for p in n_pos) + b * (
                n_h * dk + n_kv * (dk + dv) + n_h * dv) * 2
            read_bytes = sum(p * n_kv * pos_bytes for p in n_pos) + b * n_h * (dk + dv) * 2
            common = {"shape": shape, "n_h": n_h, "n_kv": n_kv, "dk": dk, "dv": dv,
                      "B": b, "S": s_max, "lengths": lengths.tolist()}
            _emit(label, **common,
                  max_abs_err_vs_plain=(a.float() - ref.float()).abs().max().item(),
                  max_abs_diff_old=(a.float() - bb.float()).abs().max().item(),
                  read_only_bitwise=bool(torch.equal(rd, a)),
                  **_ab(old_update, new_update, reps),
                  **_bound(upd_bytes, ops, "bf16"))
            lib_times = {}
            if not quant:
                kk, vv = caches[0][layer], caches[2][layer]

                def sdpa():
                    return F.scaled_dot_product_attention(
                        q[:, :, None, :], kk, vv, attn_mask=mask, scale=scale,
                        enable_gqa=n_h != n_kv)

                lib_times = {"sdpa_device_ms": device_ms(sdpa, reps),
                             "sdpa_event_ms": event_ms(sdpa, reps),
                             "sdpa_device_ms_read_overwrite": device_ms(
                                 sdpa, reps, overwrite="read")}
            _emit("decode_attention_stacked" + ("_q8" if quant else ""), **common,
                  **_ab(old_read, new_read, reps), **_bound(read_bytes, ops, "bf16"),
                  **lib_times)
            # the per-layer forms: layer `layer` of the stack as a [B, n_kv,
            # S, d] cache (the earlier wrapper passed it as layer 0 of one)
            layer_caches = [None if c is None else c[layer] for c in caches]
            layer_ptrs = [c.data_ptr() for c in layer_caches if c is not None]
            pl_tail = (lengths.data_ptr(), out_old.data_ptr(), ws_old.data_ptr(), 0,
                       b, n_h, n_kv, s_max, dk, dv, scale)

            def old_layer():
                kernels.check(getattr(lib, ro_fn)(q.data_ptr(), 1, *layer_ptrs,
                                                  *pl_tail, _stream()), "old " + ro_fn)
                return out_old

            if quant:
                def new_layer():
                    return da.decode_attention_q8(q, *layer_caches, lengths, scale=scale)
            else:
                def new_layer():
                    return da.decode_attention(q, layer_caches[0], layer_caches[2],
                                               lengths, scale=scale)

            if not torch.equal(new_layer(), rd):
                raise AssertionError(f"{ro_fn} {shape}: per-layer form differs from "
                                     "the stacked one")
            _emit(ro_fn.removeprefix("mxmoe_"), **common,
                  **_ab(old_layer, new_layer, reps), **_bound(read_bytes, ops, "bf16"))
            del caches


# ---------------------------------------------------------------------------
# the whole expert FFN
# ---------------------------------------------------------------------------

def ffn_cases(lib, reps: int) -> None:
    """K12 and K13 (every other expert packed), the one-block-per-tile body
    against the cluster body."""
    from ..ops import act_quant, gmm_ffn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    cfg = configs.QWEN2_MOE_A2_7B
    h, n, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts

    def quant_w(shape):
        w = torch.randn(shape, generator=gen, device=dev) * 0.02
        sc = w.abs().amax(1, keepdim=True) / 127.0
        return torch.round(w / sc).to(torch.int8), sc

    wgu, sgu = quant_w((e, h, 2 * n))
    wd, sd = quant_w((e, n, h))
    bits = torch.tensor([(4, 6, 8)[i % 3] for i in range(e)], dtype=torch.int32,
                        device=dev)
    pf = [int(i % 2 == 0) for i in range(e)]
    pfb = torch.tensor(pf, dtype=torch.bool, device=dev)[:, None, None]
    wgu4 = torch.where(pfb, wgu.clamp(-8, 7), wgu)
    wd4 = torch.where(pfb, wd.clamp(-8, 7), wd)
    gu_cat, gu_blk = build_ragged_mixed(wgu4, pf)
    d_cat, d_blk = build_ragged_mixed(wd4, pf)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    meta = (i32(pf), i32(gu_blk), i32(pf), i32(d_blk))
    for regime, tokens in (("decode", 4), ("decode", 16), ("prefill", 256)):
        disp = make_dispatch(route_topk(torch.randn((tokens, e), generator=gen,
                                                    device=dev),
                                        cfg.top_k, cfg.norm_topk_prob), e, align=32)
        gs, m = disp.group_sizes, disp.token_ids.numel()
        x = torch.randn((m, h), generator=gen, device=dev).to(torch.bfloat16)
        aq, asc = act_quant.quantize_rows_uniform(x, 8)
        rows, live = int(gs.sum()), gs > 0
        hq = torch.empty((m, n), dtype=torch.int8, device=dev)
        out_old = torch.empty((m, h), dtype=torch.bfloat16, device=dev)
        tail = (out_old.data_ptr(), 1, m, h, n, h, e)
        shape = {"regime": regime, "routed_rows": tokens * cfg.top_k, "M": m,
                 "rows": rows, "live_experts": int(live.sum()), "K": h, "N": n, "H": h}
        for name, w_gu, w_d, packed in (("gmm_ffn_w8a8", wgu, wd, [0] * e),
                                        ("gmm_ffn_mixed_packed", wgu4, wd4, pf)):
            if packed[0] == 0:
                new_args = (aq, asc, w_gu, sgu, w_d, sd, gs, bits)
                new = lambda a=new_args: gmm_ffn.gmm_ffn_w8a8(*a)
                ptrs = (aq, asc, w_gu, sgu, w_d, sd, gs, bits, hq)
            else:
                new_args = (aq, asc, gu_cat, sgu, meta[0], meta[1], d_cat, sd, meta[2],
                            meta[3], gs, bits)
                new = lambda a=new_args: gmm_ffn.gmm_ffn_mixed_packed(*a)
                ptrs = (*new_args, hq)

            def old(fn="mxmoe_" + name, p=tuple(t.data_ptr() for t in ptrs)):
                kernels.check(getattr(lib, fn)(*p, *tail, _stream()), "old " + fn)
                return out_old

            a, b = new(), old().clone()
            torch.cuda.synchronize()
            if not torch.equal(a[:rows], b[:rows]):
                raise AssertionError(f"{name} {regime} M={m}: the bodies differ")
            per_expert = torch.tensor([(h * 2 * n + n * h) // (2 if f else 1)
                                       for f in packed], device=dev)
            nbytes = (rows * (h + 4) + int(per_expert[live].sum())
                      + int(live.sum()) * (2 * n + h) * 4 + 2 * e * 4 + rows * h * 2)
            _emit(name, **shape, packed_experts=sum(packed), bitwise_old=True,
                  resident_clusters=gmm_ffn.resident_clusters(
                      n, h, ragged=name == "gmm_ffn_mixed_packed"),
                  **_ab(old, new, reps),
                  **_bound(nbytes, 2 * rows * (h * 2 * n + n * h), "int8"))


# ---------------------------------------------------------------------------
# the grouped-scale GEMMs
# ---------------------------------------------------------------------------

def grouped_cases(lib, reps: int) -> None:
    """K8 and K4f at g128, the 32 x 128 body against the m16 ring body."""
    from ..ops import gmm_w8a8_grouped as ggrp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    cfg = configs.QWEN2_MOE_A2_7B
    h, n, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
    sn, gsize, tokens = cfg.shared_expert_intermediate_size, 128, 4
    gs = make_dispatch(route_topk(torch.randn((tokens, e), generator=gen, device=dev),
                                  cfg.top_k, cfg.norm_topk_prob), e).group_sizes
    one = torch.full((1,), tokens, dtype=torch.int32, device=dev)
    storages = {"alternating": [int(i % 2 == 0) for i in range(e)],
                "all packed": [1] * e}
    for use, g_s, k, nn in (("gate_up", gs, h, 2 * n), ("down", gs, n, h),
                            ("shared gate_up", one, h, 2 * sn),
                            ("shared down", one, sn, h)):
        ee, rows, groups = g_s.numel(), int(g_s.sum()), k // gsize
        lv = g_s > 0
        aq = torch.randint(-127, 128, (rows, k), generator=gen, device=dev,
                           dtype=torch.int8)
        asc = torch.rand((rows, groups), generator=gen, device=dev) * 0.05 + 1e-3
        w8 = torch.randint(-127, 128, (ee, k, nn), generator=gen, device=dev,
                           dtype=torch.int8)
        w4 = torch.randint(-8, 8, (ee, k, nn), generator=gen, device=dev,
                           dtype=torch.int8)
        wsc = torch.rand((ee, groups, nn), generator=gen, device=dev) * 0.01 + 1e-4
        wzp = torch.randn((ee, groups, nn), generator=gen, device=dev) * 0.02
        sched = ggrp.grouped_gmm_schedule(rows, k, nn, ee, gsize)
        sched_args, _ws = gmm.schedule_args(sched, dev)
        shape = {"use": use, "M": rows, "K": k, "N": nn, "gsize": gsize,
                 "live_groups": int(lv.sum()),
                 "schedule": {"bm": sched.bm, "grid_m": sched.grid_m,
                              "splits": sched.splits,
                              "k_tiles_per_split": sched.k_tiles_per_split}}
        out_old = torch.empty((rows, nn), dtype=torch.bfloat16, device=dev)
        ints = (1, rows, k, nn, ee, gsize)

        def old_call(fn, ptrs):
            def call():
                kernels.check(getattr(lib, fn)(*ptrs, out_old.data_ptr(), *ints,
                                               *sched_args, _stream()), "old " + fn)
                return out_old
            return call

        for zp in (None, wzp):
            scale_bytes = int(lv.sum()) * groups * nn * 4 * (1 if zp is None else 2)
            base = rows * (k + 4 * groups) + scale_bytes + ee * 4 + rows * nn * 2
            zp_ptr = None if zp is None else zp.data_ptr()
            runs = [("gmm_w8a8_grouped", None,
                     lambda zp=zp: ggrp.gmm_w8a8_grouped(aq, asc, w8, wsc, g_s, gsize,
                                                         zp),
                     old_call("mxmoe_gmm_w8a8_grouped",
                              (aq.data_ptr(), asc.data_ptr(), w8.data_ptr(),
                               wsc.data_ptr(), zp_ptr, g_s.data_ptr())),
                     base + int(lv.sum()) * k * nn)]
            for label, pflags in storages.items() if ee > 1 else ():
                pfb = torch.tensor(pflags, dtype=torch.bool, device=dev)
                cat, blk = build_ragged_mixed(
                    torch.where(pfb[:, None, None], w4, w8), pflags)
                pf = pfb.to(torch.int32)
                blk = torch.tensor(blk, dtype=torch.int32, device=dev)
                per_expert = torch.tensor([k * nn // 2 if f else k * nn
                                           for f in pflags], device=dev)
                runs.append(("gmm_mixed_packed_flex", label,
                             lambda a=(cat, pf, blk), zp=zp: gmp.gmm_mixed_packed(
                                 aq, asc, a[0], wsc, g_s, a[1], a[2], rhs_zp=zp),
                             old_call("mxmoe_gmm_mixed_packed_flex",
                                      (aq.data_ptr(), asc.data_ptr(), cat.data_ptr(),
                                       wsc.data_ptr(), zp_ptr, g_s.data_ptr(),
                                       pf.data_ptr(), blk.data_ptr())),
                             base + int(per_expert[lv].sum()) + 8 * ee))
            for name, storage, new, old, nbytes in runs:
                a, b = new(), old().clone()
                torch.cuda.synchronize()
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} {use} {storage} zp={zp is not None}: "
                                         "new and old bodies differ")
                _emit(name, **shape, storage=storage, rhs_zp=zp is not None,
                      bitwise_old=True, **_ab(old, new, reps),
                      **_bound(nbytes, 2 * rows * k * nn, "int8"))


# ---------------------------------------------------------------------------
# the weight-only GEMMs
# ---------------------------------------------------------------------------

def weight_only_cases(lib, reps: int) -> None:
    """K6, K7 and K10 at g128 with zero points, the 32 x 128 bodies against
    the m16 ring bodies."""
    from ..ops import gmm_mixed_wo_wxa as gmx, gmm_w8a8_grouped as ggrp
    from ..ops import gmm_weight_only as gwo, gmm_weight_only_packed as gwop

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    cfg = configs.QWEN2_MOE_A2_7B
    h, n, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
    sn, gsize, tokens = cfg.shared_expert_intermediate_size, 128, 4
    gs = make_dispatch(route_topk(torch.randn((tokens, e), generator=gen, device=dev),
                                  cfg.top_k, cfg.norm_topk_prob), e).group_sizes
    one = torch.full((1,), tokens, dtype=torch.int32, device=dev)
    for use, g_s, k, nn in (("gate_up", gs, h, 2 * n), ("down", gs, n, h),
                            ("shared gate_up", one, h, 2 * sn),
                            ("shared down", one, sn, h)):
        ee, rows, groups = g_s.numel(), int(g_s.sum()), k // gsize
        lv = g_s > 0
        live = int(lv.sum())
        x = torch.randn((rows, k), generator=gen, device=dev).to(torch.bfloat16)
        aq = torch.randint(-127, 128, (rows, k), generator=gen, device=dev,
                           dtype=torch.int8)
        asc = torch.rand((rows, groups), generator=gen, device=dev) * 0.05 + 1e-3
        w4 = torch.randint(-8, 8, (ee, k, nn), generator=gen, device=dev,
                           dtype=torch.int8)
        packed = pack_int4_halves(w4)
        sc = torch.rand((ee, groups, nn), generator=gen, device=dev) * 0.02 + 1e-3
        zp = torch.randn((ee, groups, nn), generator=gen, device=dev) * 0.05
        flags = [int(i % 2 == 0) for i in range(ee)]
        fl = torch.tensor(flags, dtype=torch.int32, device=dev)
        sched = ggrp.weight_only_gmm_schedule(rows, k, nn, ee, gsize)
        shape = {"use": use, "M": rows, "K": k, "N": nn, "gsize": gsize,
                 "rhs_zp": True, "live_groups": live,
                 "schedule": {"bm": sched.bm, "grid_m": sched.grid_m,
                              "splits": sched.splits,
                              "k_tiles_per_split": sched.k_tiles_per_split}}
        ints = (1, rows, k, nn, ee, gsize)

        def old_call(fn, ptrs):
            out_old = torch.empty((rows, nn), dtype=torch.bfloat16, device=dev)

            def call():
                kernels.check(getattr(lib, fn)(*ptrs, out_old.data_ptr(), *ints,
                                               _stream()), "old " + fn)
                return out_old
            return call

        meta = rows * nn * 2 + ee * 4 + live * groups * nn * 8
        wo_ops = 2 * rows * k * nn
        runs = [("gmm_weight_only",
                 lambda: gwo.gmm_weight_only(x, w4, sc, zp, g_s, gsize),
                 old_call("mxmoe_gmm_weight_only",
                          (x.data_ptr(), w4.data_ptr(), sc.data_ptr(), zp.data_ptr(),
                           g_s.data_ptr())),
                 _bound(meta + rows * 2 * k + live * k * nn, wo_ops, "bf16")),
                ("gmm_weight_only_packed",
                 lambda: gwop.gmm_weight_only_packed(x, packed, sc, zp, g_s, gsize),
                 old_call("mxmoe_gmm_weight_only_packed",
                          (x.data_ptr(), packed.data_ptr(), sc.data_ptr(),
                           zp.data_ptr(), g_s.data_ptr())),
                 _bound(meta + rows * 2 * k + live * k * nn // 2, wo_ops, "bf16"))]
        wo_rows = torch.repeat_interleave(fl, g_s.long()).bool()
        if ee > 1:
            rows_wo = int(g_s[fl.bool()].sum())
            rows_wxa = rows - rows_wo
            t_ops = (2 * rows_wo * k * nn / PEAK["bf16"]
                     + 2 * rows_wxa * k * nn / PEAK["int8"]) * 1e3
            nbytes = (meta + rows_wo * 2 * k + rows_wxa * (k + 4 * groups)
                      + live * k * nn)
            t_bytes = nbytes / HBM * 1e3
            runs.append(("gmm_mixed_wo_wxa",
                         lambda: gmx.gmm_mixed_wo_wxa(x, aq, asc, w4, sc, fl, g_s,
                                                      rhs_zp=zp),
                         old_call("mxmoe_gmm_mixed_wo_wxa",
                                  (x.data_ptr(), aq.data_ptr(), asc.data_ptr(),
                                   w4.data_ptr(), sc.data_ptr(), zp.data_ptr(),
                                   fl.data_ptr(), g_s.data_ptr())),
                         {"bound_ms": max(t_bytes, t_ops), "bytes": int(nbytes),
                          "bound_by": "bytes" if t_bytes >= t_ops else "operations"}))
        k6 = runs[0][1]()
        for name, new, old, bound in runs:
            a, b = new(), old()
            torch.cuda.synchronize()
            rows_of = wo_rows if name == "gmm_mixed_wo_wxa" else torch.ones_like(wo_rows)
            gs_wo = torch.where(fl.bool(), g_s, torch.zeros_like(g_s)) \
                if name == "gmm_mixed_wo_wxa" else g_s
            ratios = []
            for got in (a, b):
                r = torch.nonzero(rows_of)[:, 0]
                ratios.append(gwo.error_over_bound(
                    got[r].contiguous(), x[r].contiguous(), w4, sc, zp, gs_wo,
                    gsize)[1])
            if not max(ratios) <= 1.0:
                raise AssertionError(f"{name} {use}: outside the bound {ratios}")
            if not torch.equal(a[rows_of], k6[rows_of]):
                raise AssertionError(f"{name} {use}: weight-only rows differ from K6")
            if name == "gmm_mixed_wo_wxa" and not torch.equal(a[~wo_rows],
                                                               b[~wo_rows]):
                raise AssertionError(f"{name} {use}: w x a rows differ old / new")
            _emit(name, **shape, new_err_over_bound=ratios[0],
                  old_err_over_bound=ratios[1], equals_new_k6=True,
                  **_ab(old, new, reps), **bound)


# ---------------------------------------------------------------------------
# the int8 grouped GEMM at large M (K15) and the activation quantizer (K1)
# ---------------------------------------------------------------------------

def ws_cases(lib, reps: int) -> None:
    """K15, int8 and packed, at the headline's shapes: the full-K slice body
    against the wgmma body, with K2 / K5 and bf16 ``torch._grouped_mm``."""
    from ..ops import gmm as gfl, gmm_ws
    from . import workloads

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    for wl in workloads.qwen2_moe_l10_bs8192():
        sizes = [(s + 127) // 128 * 128 for s in wl.group_sizes]
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        m, k, nn, e = sum(sizes), wl.k, wl.n, len(sizes)
        aq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        asc = torch.rand((m, 1), generator=gen, device=dev) * 0.05
        wsc = torch.rand((e, 1, nn), generator=gen, device=dev) * 0.01
        host = (ctypes.c_int * e)(*sizes)
        out_old = torch.empty((m, nn), dtype=torch.bfloat16, device=dev)
        ops = 2 * m * k * nn
        xb = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        wb = torch.randn((e, k, nn), generator=gen, device=dev).to(torch.bfloat16)
        library = {"grouped_mm_bf16_device_ms": device_ms(
                       lambda: gfl.gmm(xb, wb, gs, backend="ragged_dot"), reps),
                   "grouped_mm_bf16_note": "bf16 operands: the headline's baseline, "
                                           "not the same function"}
        del xb, wb
        for form in ("int8", "packed"):
            packed = form == "packed"
            if packed:
                w = pack_int4_halves(torch.randint(-8, 8, (e, k, nn), generator=gen,
                                                   device=dev, dtype=torch.int8))
                new = lambda w=w: gmm_ws.gmm_w4a8_packed_ws(aq, asc, w, wsc, sizes)
                sibling = lambda w=w: g4p.gmm_w4a8_packed(aq, asc, w, wsc, gs)
            else:
                w = torch.randint(-127, 128, (e, k, nn), generator=gen, device=dev,
                                  dtype=torch.int8)
                new = lambda w=w: gmm_ws.gmm_w8a8_ws(aq, asc, w, wsc, sizes)
                sibling = lambda w=w: gmm.gmm_w8a8(aq, asc, w, wsc, gs)

            def old(w=w, packed=packed):
                kernels.check(lib.mxmoe_gmm_ws(
                    aq.data_ptr(), asc.data_ptr(), w.data_ptr(), wsc.data_ptr(), host,
                    out_old.data_ptr(), int(packed), 1, m, k, nn, e, _stream()),
                    "old mxmoe_gmm_ws")
                return out_old

            a, b, c = new(), old().clone(), sibling()
            torch.cuda.synchronize()
            if not (torch.equal(a, b) and torch.equal(a, c)):
                raise AssertionError(f"gmm_ws {form} {wl.name}: new, old and "
                                     f"{'K5' if packed else 'K2'} differ")
            nbytes = m * (k + 4) + w.numel() + e * nn * 4 + m * nn * 2
            _emit("gmm_ws", form=form, workload=wl.name, M=m, K=k, N=nn,
                  bitwise_old=True, bitwise_sibling=True,
                  sibling_device_ms=device_ms(sibling, reps), **library,
                  **_ab(old, new, reps), **_bound(nbytes, ops, "int8"))
            del w


def act_quant_cases(lib, reps: int) -> None:
    """K1 at the headline's, prefill and decode rows: the body that staged a
    row in shared memory against the register bodies (a warp or a block a
    row)."""
    from ..ops import act_quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    gain = 1.0 + 3.7e-4
    for use, m, k in (("headline gate_up", 36736, 2048), ("headline down", 36736, 1408),
                      ("headline shared down", 8192, 5632),
                      ("prefill chunks", 4096, 2048), ("prefill chunk", 1024, 2048),
                      ("decode", 16, 2048)):
        x = (torch.randn((m, k), generator=gen, device=dev) * 3).to(torch.bfloat16)
        bits = torch.tensor([4.0, 8.0, 16.0], device=dev).repeat(m)[:m].contiguous()
        q_old = torch.empty((m, k), dtype=torch.int8, device=dev)
        s_old = torch.empty((m, 1), dtype=torch.float32, device=dev)

        def old():
            kernels.check(lib.mxmoe_quantize_rows(
                x.data_ptr(), 1, bits.data_ptr(), gain, q_old.data_ptr(),
                s_old.data_ptr(), m, k, _stream()), "old mxmoe_quantize_rows")
            return q_old, s_old

        def new():
            return act_quant.quantize_rows(x, bits, gain)

        (qa, sa), (qb, sb) = new(), old()
        torch.cuda.synchronize()
        if not (torch.equal(qa, qb) and torch.equal(sa, sb)):
            raise AssertionError(f"quantize_rows {use}: new and old differ")
        _emit("quantize_rows", use=use, M=m, K=k, bitwise_old=True,
              **_ab(old, new, reps),
              **_bound(m * k * 2 + m * 4 + m * k + m * 4, 3 * m * k, "f32"))


def _routed_sizes(model: str, tokens: int, gen) -> list[int]:
    """``tokens`` tokens routed over ``model``'s experts (random router
    logits) -> the group sizes, as host ints."""
    cfg = configs.config_for(model)
    logits = torch.randn((tokens, cfg.num_experts), generator=gen, device="cuda")
    routing = route_topk(logits, cfg.top_k, cfg.norm_topk_prob)
    return make_dispatch(routing, cfg.num_experts).group_sizes.tolist()


def int8_large_cases(lib, reps: int) -> None:
    """K2 and K5 above the decode rows: the 64 x 128 mma.sync body against
    the body the package's schedule takes there, with K15 beside on the
    headline's aligned layout."""
    from ..ops import gmm_ws
    from . import workloads

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(29)
    qwen = configs.config_for("qwen2_moe")
    h, n = qwen.hidden_size, qwen.moe_intermediate_size
    sn = qwen.shared_expert_intermediate_size
    routed = workloads.QWEN2_MOE_L10_BS8192_ROUTED_M
    shapes = []
    for model, tokens in (("qwen2_moe", 256), ("ds2", 256)):
        sizes = _routed_sizes(model, tokens, gen)
        shapes += [(f"{model} prefill chunk {proj}", sizes, k, nn)
                   for proj, k, nn in (("gate_up", h, 2 * n), ("down", n, h))]
    shapes += [(f"shared expert prefill {proj}", [256], k, nn)
               for proj, k, nn in (("gate_up", h, 2 * sn), ("down", sn, h))]
    shapes += [(f"qwen2_moe M {4 * t} gate_up", _routed_sizes("qwen2_moe", t, gen), h,
                2 * n) for t in (17, 32, 128, 1024, 2048)]
    for label, sizes in (("headline", list(routed)),
                         ("headline aligned", [(s + 127) // 128 * 128 for s in routed])):
        shapes += [(f"{label} {proj}", sizes, k, nn)
                   for proj, k, nn in (("gate_up", h, 2 * n), ("down", n, h))]
    for use, sizes, k, nn in shapes:
        m, e = sum(sizes), len(sizes)
        live = sum(1 for s in sizes if s > 0)
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        aq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        asc = torch.rand((m, 1), generator=gen, device=dev) * 0.05
        wsc = torch.rand((e, 1, nn), generator=gen, device=dev) * 0.01
        out_old = torch.empty((m, nn), dtype=torch.bfloat16, device=dev)
        aligned = all(s % 128 == 0 for s in sizes)
        for form in ("int8", "packed"):
            packed = form == "packed"
            if packed:
                w = pack_int4_halves(torch.randint(-8, 8, (e, k, nn), generator=gen,
                                                   device=dev, dtype=torch.int8))
                new = lambda w=w: g4p.gmm_w4a8_packed(aq, asc, w, wsc, gs)
                ws = lambda w=w: gmm_ws.gmm_w4a8_packed_ws(aq, asc, w, wsc, sizes)
                fn = "mxmoe_gmm_w4a8_packed"
            else:
                w = torch.randint(-127, 128, (e, k, nn), generator=gen, device=dev,
                                  dtype=torch.int8)
                new = lambda w=w: gmm.gmm_w8a8(aq, asc, w, wsc, gs)
                ws = lambda w=w: gmm_ws.gmm_w8a8_ws(aq, asc, w, wsc, sizes)
                fn = "mxmoe_gmm_w8a8"
            kw = k // 2 if packed else k

            def old(w=w, fn=fn, kw=kw):
                kernels.check(getattr(lib, fn)(
                    aq.data_ptr(), asc.data_ptr(), w.data_ptr(), wsc.data_ptr(),
                    gs.data_ptr(), out_old.data_ptr(), 1, m, k, nn, e,
                    64, (m + 63) // 64 + e - 1, 1, (kw + 63) // 64, None, None,
                    _stream()), "old " + fn)
                return out_old

            a, b = new(), old().clone()
            c = ws() if aligned else None
            torch.cuda.synchronize()
            if not (torch.equal(a, b) and (c is None or torch.equal(a, c))):
                raise AssertionError(f"{fn} {use}: new, old (and K15) differ")
            beside = {"k15_device_ms": device_ms(ws, reps)} if aligned else {}
            sched = gmm.int8_gmm_schedule(m, k, nn, e, packed, wgmma=True)
            nbytes = m * (k + 4) + live * (kw * nn + nn * 4) + e * 4 + m * nn * 2
            _emit("gmm_w4a8_packed" if packed else "gmm_w8a8", form=form, use=use, M=m,
                  K=k, N=nn, E=e, live_groups=live, schedule=vars(sched),
                  bitwise_old=True, **beside, **_ab(old, new, reps),
                  **_bound(nbytes, 2 * m * k * nn, "int8"))
            del w
        del aq, out_old
        torch.cuda.empty_cache()


def fusedquant_cases(lib, reps: int) -> None:
    """K14 at qwen2_moe's gate_up, decode, prefill chunk and headline rows:
    the 64 x 128 body against the new bodies, K1 + K2 beside."""
    from ..ops import act_quant, gmm_w8a8_fusedquant as gfq
    from . import workloads

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    qwen = configs.config_for("qwen2_moe")
    k, nn = qwen.hidden_size, 2 * qwen.moe_intermediate_size
    for use, sizes in (("decode", _routed_sizes("qwen2_moe", 4, gen)),
                       ("prefill chunk", _routed_sizes("qwen2_moe", 256, gen)),
                       ("headline", list(workloads.QWEN2_MOE_L10_BS8192_ROUTED_M))):
        m, e = sum(sizes), len(sizes)
        live = sum(1 for s in sizes if s > 0)
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        x = (torch.randn((m, k), generator=gen, device=dev) * 2).to(torch.bfloat16)
        wq = torch.randint(-127, 128, (e, k, nn), generator=gen, device=dev,
                           dtype=torch.int8)
        wsc = torch.rand((e, 1, nn), generator=gen, device=dev) * 0.01 + 1e-4
        out_old = torch.empty((m, nn), dtype=torch.bfloat16, device=dev)

        def old():
            kernels.check(lib.mxmoe_gmm_w8a8_fusedquant(
                x.data_ptr(), 1, wq.data_ptr(), wsc.data_ptr(), gs.data_ptr(),
                out_old.data_ptr(), 1, 127.0, m, k, nn, e, _stream()),
                "old mxmoe_gmm_w8a8_fusedquant")
            return out_old

        def new():
            return gfq.gmm_w8a8_fusedquant(x, wq, wsc, gs)

        def k1_k2():
            aq, asc = act_quant.quantize_rows_uniform(x, 8)
            return gmm.gmm_w8a8(aq, asc, wq, wsc, gs)

        a, b, c = new(), old().clone(), k1_k2()
        torch.cuda.synchronize()
        if not (torch.equal(a, b) and torch.equal(a, c)):
            raise AssertionError(f"gmm_w8a8_fusedquant {use}: new, old and K1 + K2 "
                                 "differ")
        nbytes = m * k * 2 + live * (k * nn + nn * 4) + e * 4 + m * nn * 2
        _emit("gmm_w8a8_fusedquant", use=use, M=m, K=k, N=nn, E=e, live_groups=live,
              bitwise_old=True, bitwise_k1_k2=True,
              k1_k2_device_ms=device_ms(k1_k2, reps), k1_k2_event_ms=event_ms(k1_k2, reps),
              **_ab(old, new, reps), **_bound(nbytes, 2 * m * k * nn, "int8"))
        del x, wq, out_old
        torch.cuda.empty_cache()


def bf16_large_cases(lib, reps: int) -> None:
    """K11 with bf16 operands (``workloads.k11_shapes``): the 32 x 128
    mma.sync body (old) against the wgmma body (the package's, at every row
    count), the stock grouped product beside."""
    from ..ops import gmm as gfl
    from . import workloads

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(37)
    for use, sizes, k, nn in workloads.k11_shapes(lambda model, t: _routed_sizes(
            model, t, gen)):
        m, e = sum(sizes), len(sizes)
        live = sum(1 for s in sizes if s > 0)
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((e, k, nn), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        out_old = torch.empty((m, nn), dtype=torch.bfloat16, device=dev)

        def old():
            kernels.check(lib.mxmoe_gmm_bf16(
                x.data_ptr(), w.data_ptr(), gs.data_ptr(), out_old.data_ptr(), 1, 1, m,
                k, nn, e, _stream()), "old mxmoe_gmm_bf16")
            return out_old

        def new():
            return gfl.gmm_bf16(x, w, gs)

        def library():
            return gfl.gmm(x, w, gs, backend="ragged_dot")

        got = {"new": new(), "old": old().clone(), "library": library()}
        torch.cuda.synchronize()
        ratios = {name: gfl.error_over_bound(o, x, w, gs)[1] for name, o in got.items()}
        if not (ratios["new"] <= 1.0 and ratios["old"] <= 1.0):
            raise AssertionError(f"gmm_bf16 {use}: outside the bound {ratios}")
        nbytes = m * k * 2 + live * k * nn * 2 + e * 4 + m * nn * 2
        _emit("gmm_bf16", use=use, M=m, K=k, N=nn, E=e, live_groups=live,
              schedule=vars(gfl.bf16_gmm_schedule()), err_over_bound=ratios,
              library_device_ms=device_ms(library, reps),
              library_event_ms=event_ms(library, reps),
              **_ab(old, new, reps), **_bound(nbytes, 2 * m * k * nn, "bf16"))
        del x, w, out_old, got
        torch.cuda.empty_cache()


def _wq_prefill_shapes(gen) -> list:
    """qwen2_moe's routing above the decode rows: (use, sizes, K, N)."""
    qwen = configs.config_for("qwen2_moe")
    h, n = qwen.hidden_size, qwen.moe_intermediate_size
    shapes = [(f"qwen2_moe M {4 * t} gate_up", _routed_sizes("qwen2_moe", t, gen), h,
               2 * n) for t in (17, 32, 64, 128)]
    chunk = _routed_sizes("qwen2_moe", 256, gen)
    shapes += [(f"qwen2_moe prefill chunk {proj}", chunk, k, nn)
               for proj, k, nn in (("gate_up", h, 2 * n), ("down", n, h))]
    return shapes + [(f"qwen2_moe M {4 * t} gate_up", _routed_sizes("qwen2_moe", t, gen),
                      h, 2 * n) for t in (2048, 16384)]


def _old_32(lib, fn: str, out, head, m: int, k: int, nn: int, e: int, gsize: int):
    """A call of the earlier 32 x 128 body through its C entry point."""
    def call():
        kernels.check(getattr(lib, fn)(
            *head, out.data_ptr(), 1, m, k, nn, e, gsize, 32, (m + 31) // 32 + e - 1, 1,
            (k + 63) // 64, None, None, _stream()), "old " + fn)
        return out
    return call


def wo_prefill_cases(lib, reps: int) -> None:
    """K6, K7 and K10 above the decode rows, g128 with zero points: the
    32 x 128 bodies against the package's schedule (the wgmma body A, and
    body B for K10's w x a experts, from its threshold on)."""
    from ..ops import gmm_mixed_wo_wxa as gmx, gmm_w8a8_grouped as ggrp
    from ..ops import gmm_weight_only as gwo, gmm_weight_only_packed as gwop

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(41)
    gsize = 128
    for use, sizes, k, nn in _wq_prefill_shapes(gen):
        m, e, groups = sum(sizes), len(sizes), k // gsize
        live = sum(1 for s in sizes if s > 0)
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        aq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        asc = torch.rand((m, groups), generator=gen, device=dev) * 0.05 + 1e-3
        w4 = torch.randint(-8, 8, (e, k, nn), generator=gen, device=dev, dtype=torch.int8)
        packed = pack_int4_halves(w4)
        sc = torch.rand((e, groups, nn), generator=gen, device=dev) * 0.02 + 1e-3
        zp = torch.randn((e, groups, nn), generator=gen, device=dev) * 0.05
        fl = torch.tensor([int(i % 2 == 0) for i in range(e)], dtype=torch.int32,
                          device=dev)
        wo_rows = torch.repeat_interleave(fl, gs.long()).bool()
        out_old = torch.empty((m, nn), dtype=torch.bfloat16, device=dev)
        sched = ggrp.weight_only_gmm_schedule(m, k, nn, e, gsize)
        meta = m * nn * 2 + e * 4 + live * groups * nn * 8
        ops = 2 * m * k * nn
        rows_wo = int(gs[fl.bool()].sum())
        t_mix = max((meta + rows_wo * 2 * k + (m - rows_wo) * (k + 4 * groups)
                     + live * k * nn) / HBM * 1e3,
                    (2 * rows_wo * k * nn / PEAK["bf16"]
                     + 2 * (m - rows_wo) * k * nn / PEAK["int8"]) * 1e3)
        runs = [("gmm_weight_only", lambda: gwo.gmm_weight_only(x, w4, sc, zp, gs, gsize),
                 _old_32(lib, "mxmoe_gmm_weight_only", out_old,
                         (x.data_ptr(), w4.data_ptr(), sc.data_ptr(), zp.data_ptr(),
                          gs.data_ptr()), m, k, nn, e, gsize),
                 _bound(meta + m * 2 * k + live * k * nn, ops, "bf16")),
                ("gmm_weight_only_packed",
                 lambda: gwop.gmm_weight_only_packed(x, packed, sc, zp, gs, gsize),
                 _old_32(lib, "mxmoe_gmm_weight_only_packed", out_old,
                         (x.data_ptr(), packed.data_ptr(), sc.data_ptr(), zp.data_ptr(),
                          gs.data_ptr()), m, k, nn, e, gsize),
                 _bound(meta + m * 2 * k + live * k * nn // 2, ops, "bf16")),
                ("gmm_mixed_wo_wxa",
                 lambda: gmx.gmm_mixed_wo_wxa(x, aq, asc, w4, sc, fl, gs, rhs_zp=zp),
                 _old_32(lib, "mxmoe_gmm_mixed_wo_wxa", out_old,
                         (x.data_ptr(), aq.data_ptr(), asc.data_ptr(), w4.data_ptr(),
                          sc.data_ptr(), zp.data_ptr(), fl.data_ptr(), gs.data_ptr()),
                         m, k, nn, e, gsize),
                 {"bound_ms": t_mix, "bound_by": "bytes or operations by flag"})]
        k6 = runs[0][1]()
        k8 = ggrp.gmm_w8a8_grouped(aq, asc, w4, sc, gs, gsize, zp)
        for name, new, old, bound in runs:
            a, b = new(), old().clone()
            torch.cuda.synchronize()
            rows_of = wo_rows if name == "gmm_mixed_wo_wxa" else torch.ones_like(wo_rows)
            gs_wo = (torch.where(fl.bool(), gs, torch.zeros_like(gs))
                     if name == "gmm_mixed_wo_wxa" else gs)
            r = torch.nonzero(rows_of)[:, 0]
            ratios = [gwo.error_over_bound(got[r].contiguous(), x[r].contiguous(), w4, sc,
                                           zp, gs_wo, gsize)[1] for got in (a, b)]
            if not max(ratios) <= 1.0:
                raise AssertionError(f"{name} {use}: outside the bound {ratios}")
            if not torch.equal(a[rows_of], k6[rows_of]):
                raise AssertionError(f"{name} {use}: weight-only rows differ from K6")
            if name == "gmm_mixed_wo_wxa" and not (
                    torch.equal(a[~wo_rows], b[~wo_rows])
                    and torch.equal(a[~wo_rows], k8[~wo_rows])):
                raise AssertionError(f"{name} {use}: w x a rows differ old / new / K8")
            _emit(name, use=use, M=m, K=k, N=nn, E=e, gsize=gsize, rhs_zp=True,
                  live_groups=live, schedule=vars(sched), new_err_over_bound=ratios[0],
                  old_err_over_bound=ratios[1], equals_new_k6=True,
                  **_ab(old, new, reps), **bound)
        del x, aq, w4, packed, out_old, k6, k8
        torch.cuda.empty_cache()


def grouped_prefill_cases(lib, reps: int) -> None:
    """K8 above the decode rows, g128 without and with zero points and one
    group: the 32 x 128 body against the package's schedule (the wgmma body B
    from its threshold on), bitwise."""
    from ..ops import gmm_w8a8_grouped as ggrp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(43)
    for use, sizes, k, nn in _wq_prefill_shapes(gen):
        m, e = sum(sizes), len(sizes)
        live = sum(1 for s in sizes if s > 0)
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        aq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        wq = torch.randint(-127, 128, (e, k, nn), generator=gen, device=dev,
                           dtype=torch.int8)
        out_old = torch.empty((m, nn), dtype=torch.bfloat16, device=dev)
        for gsize, with_zp in ((128, False), (128, True), (k, False)):
            groups = k // gsize
            asc = torch.rand((m, groups), generator=gen, device=dev) * 0.05 + 1e-3
            wsc = torch.rand((e, groups, nn), generator=gen, device=dev) * 0.01 + 1e-4
            zp = (torch.randn((e, groups, nn), generator=gen, device=dev) * 0.02
                  if with_zp else None)

            def new(asc=asc, wsc=wsc, zp=zp, gsize=gsize):
                return ggrp.gmm_w8a8_grouped(aq, asc, wq, wsc, gs, gsize, zp)
            old = _old_32(lib, "mxmoe_gmm_w8a8_grouped", out_old,
                          (aq.data_ptr(), asc.data_ptr(), wq.data_ptr(), wsc.data_ptr(),
                           None if zp is None else zp.data_ptr(), gs.data_ptr()),
                          m, k, nn, e, gsize)
            a, b = new(), old().clone()
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(f"gmm_w8a8_grouped {use} gsize {gsize}: old / new")
            sched = ggrp.grouped_gmm_schedule(m, k, nn, e, gsize, wgmma=True)
            nbytes = (m * (k + 4 * groups) + live * (k * nn + groups * nn * 4
                                                      * (2 if with_zp else 1))
                      + e * 4 + m * nn * 2)
            _emit("gmm_w8a8_grouped", use=use, M=m, K=k, N=nn, E=e, gsize=gsize,
                  rhs_zp=with_zp, live_groups=live, schedule=vars(sched),
                  bitwise_old=True, **_ab(old, new, reps),
                  **_bound(nbytes, 2 * m * k * nn, "int8"))
        del aq, wq, out_old
        torch.cuda.empty_cache()


def _ragged_prefill_shapes(gen) -> list:
    """qwen2_moe's routing above the decode rows for K4 / K4f / K9: (use,
    sizes, K, N) at M 68 / 512, the chunk's gate_up and down, M 8192, the
    headline's 32762 rows and M 65536."""
    from . import workloads

    qwen = configs.config_for("qwen2_moe")
    h, n = qwen.hidden_size, qwen.moe_intermediate_size
    shapes = [(f"qwen2_moe M {4 * t} gate_up", _routed_sizes("qwen2_moe", t, gen), h,
               2 * n) for t in (17, 128)]
    chunk = _routed_sizes("qwen2_moe", 256, gen)
    shapes += [(f"qwen2_moe prefill chunk {proj}", chunk, k, nn)
               for proj, k, nn in (("gate_up", h, 2 * n), ("down", n, h))]
    shapes.append(("qwen2_moe M 8192 gate_up", _routed_sizes("qwen2_moe", 2048, gen), h,
                   2 * n))
    shapes.append(("headline gate_up", list(workloads.QWEN2_MOE_L10_BS8192_ROUTED_M), h,
                   2 * n))
    shapes.append(("qwen2_moe M 65536 gate_up", _routed_sizes("qwen2_moe", 16384, gen),
                   h, 2 * n))
    return shapes


def _old_tile(lib, fn: str, out, head, tail, m: int, k: int, nn: int, e: int, bm: int):
    """A call of an earlier mma.sync tile (bm 64: K4 / K9's 64 x 128 tile;
    32: K4f's 32 x 128 body) through its C entry point; ``tail`` the ints
    after E (K4f's gsize)."""
    def call():
        kernels.check(getattr(lib, fn)(
            *head, out.data_ptr(), 1, m, k, nn, e, *tail, bm, (m + bm - 1) // bm + e - 1,
            1, (k + 63) // 64, None, None, _stream()), "old " + fn)
        return out
    return call


def mixed_prefill_cases(lib, reps: int) -> None:
    """K4 and K4f above the decode rows: the earlier mma.sync bodies against
    the wgmma bodies over the ragged storage, bitwise, with K2 / K8 (and
    K5 for the all-packed K4f) on the same codes beside."""
    from ..ops import gmm_w8a8_grouped as ggrp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(47)
    gsize = 128
    for use, sizes, k, nn in _ragged_prefill_shapes(gen):
        m, e, groups = sum(sizes), len(sizes), k // gsize
        live = sum(1 for s in sizes if s > 0)
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        aq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        w8 = torch.randint(-127, 128, (e, k, nn), generator=gen, device=dev,
                           dtype=torch.int8)
        w4 = torch.randint(-8, 8, (e, k, nn), generator=gen, device=dev, dtype=torch.int8)
        out_old = torch.empty((m, nn), dtype=torch.bfloat16, device=dev)
        alternating = [int(i % 2 == 0) for i in range(e)]
        lv = [s > 0 for s in sizes]
        for form, pflags in (("per_channel", alternating), ("flex", alternating),
                             ("flex", [1] * e)):
            pfb = torch.tensor(pflags, dtype=torch.bool, device=dev)
            codes = torch.where(pfb[:, None, None], w4, w8)
            cat, blk = build_ragged_mixed(codes, pflags)
            pf = pfb.to(torch.int32)
            blk = torch.tensor(blk, dtype=torch.int32, device=dev)
            wbytes = sum((k * nn // 2 if f else k * nn) for f, ok in zip(pflags, lv) if ok)
            storage = "all packed" if all(pflags) else "alternating"
            if form == "per_channel":
                asc = torch.rand((m, 1), generator=gen, device=dev) * 0.05
                wsc = torch.rand((e, 1, nn), generator=gen, device=dev) * 0.01

                def new(asc=asc, wsc=wsc, cat=cat, pf=pf, blk=blk):
                    return gmp.gmm_mixed_packed(aq, asc, cat, wsc, gs, pf, blk)

                def sibling(asc=asc, wsc=wsc, codes=codes):
                    return gmm.gmm_w8a8(aq, asc, codes, wsc, gs)
                old = _old_tile(lib, "mxmoe_gmm_mixed_packed", out_old,
                                (aq.data_ptr(), asc.data_ptr(), cat.data_ptr(),
                                 wsc.data_ptr(), gs.data_ptr(), pf.data_ptr(),
                                 blk.data_ptr()), (), m, k, nn, e, 64)
                sched = gmm.int8_gmm_schedule(m, k, nn, e, wgmma=True, ragged=True)
                name, sib = "gmm_mixed_packed", "gmm_w8a8"
                nbytes = m * (k + 4) + wbytes + live * nn * 4 + 8 * e + m * nn * 2
            else:
                asc = torch.rand((m, groups), generator=gen, device=dev) * 0.05 + 1e-3
                wsc = torch.rand((e, groups, nn), generator=gen, device=dev) * 0.01 + 1e-4
                zp = torch.randn((e, groups, nn), generator=gen, device=dev) * 0.02

                def new(asc=asc, wsc=wsc, zp=zp, cat=cat, pf=pf, blk=blk):
                    return gmp.gmm_mixed_packed(aq, asc, cat, wsc, gs, pf, blk, rhs_zp=zp)

                def sibling(asc=asc, wsc=wsc, zp=zp, codes=codes):
                    return ggrp.gmm_w8a8_grouped(aq, asc, codes, wsc, gs, gsize, zp)
                old = _old_tile(lib, "mxmoe_gmm_mixed_packed_flex", out_old,
                                (aq.data_ptr(), asc.data_ptr(), cat.data_ptr(),
                                 wsc.data_ptr(), zp.data_ptr(), gs.data_ptr(),
                                 pf.data_ptr(), blk.data_ptr()), (gsize,), m, k, nn, e,
                                32)
                sched = ggrp.grouped_gmm_schedule(m, k, nn, e, gsize, wgmma=True,
                                                  mixed=True)
                name, sib = "gmm_mixed_packed_flex", "gmm_w8a8_grouped"
                nbytes = (m * (k + 4 * groups) + wbytes + live * groups * nn * 8 + 8 * e
                          + m * nn * 2)
            a, b, c = new(), old().clone(), sibling()
            torch.cuda.synchronize()
            if not (torch.equal(a, b) and torch.equal(a, c)):
                raise AssertionError(f"{name} {use} {storage}: new, old and {sib} differ")
            beside = {f"{sib}_same_codes_device_ms": device_ms(sibling, reps)}
            if storage == "all packed":
                beside["gmm_w4a8_packed_same_codes_device_ms"] = device_ms(
                    lambda p=pack_int4_halves(w4), s1=asc[:, :1].contiguous(),
                    s2=wsc[:, :1].contiguous(): g4p.gmm_w4a8_packed(aq, s1, p, s2, gs),
                    reps)
            _emit(name, use=use, storage=storage, M=m, K=k, N=nn, E=e,
                  gsize=None if form == "per_channel" else gsize,
                  rhs_zp=form == "flex", live_groups=live, schedule=vars(sched),
                  bitwise_old=True, **{f"equals_{sib}": True}, **beside,
                  **_ab(old, new, reps), **_bound(nbytes, 2 * m * k * nn, "int8"))
            del cat, codes
        del aq, w8, w4, out_old
        torch.cuda.empty_cache()


def asym_prefill_cases(lib, reps: int) -> None:
    """K9 above the decode rows: the 64 x 128 mma.sync tile against K8's
    wgmma body B with one group and zero points, bitwise, K8 beside."""
    from ..ops import gmm_w8a8_grouped as ggrp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(53)
    for use, sizes, k, nn in _ragged_prefill_shapes(gen):
        m, e = sum(sizes), len(sizes)
        live = sum(1 for s in sizes if s > 0)
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        aq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        wq = torch.randint(-127, 128, (e, k, nn), generator=gen, device=dev,
                           dtype=torch.int8)
        asc = torch.rand((m, 1), generator=gen, device=dev) * 0.05 + 1e-3
        wsc = torch.rand((e, 1, nn), generator=gen, device=dev) * 0.01 + 1e-4
        zp = torch.randn((e, 1, nn), generator=gen, device=dev) * 0.02
        out_old = torch.empty((m, nn), dtype=torch.bfloat16, device=dev)

        def new():
            return gas.gmm_w8a8_asym(aq, asc, wq, wsc, zp, gs)

        def k8():
            return ggrp.gmm_w8a8_grouped(aq, asc, wq, wsc, gs, -1, zp)
        old = _old_tile(lib, "mxmoe_gmm_w8a8_asym", out_old,
                        (aq.data_ptr(), asc.data_ptr(), wq.data_ptr(), wsc.data_ptr(),
                         zp.data_ptr(), gs.data_ptr()), (), m, k, nn, e, 64)
        a, b, c = new(), old().clone(), k8()
        torch.cuda.synchronize()
        if not (torch.equal(a, b) and torch.equal(a, c)):
            raise AssertionError(f"gmm_w8a8_asym {use}: new, old and K8 differ")
        nbytes = m * (k + 4) + live * (k * nn + 8 * nn) + e * 4 + m * nn * 2
        _emit("gmm_w8a8_asym", use=use, M=m, K=k, N=nn, E=e, rhs_zp=True,
              live_groups=live, schedule=vars(gas.asym_gmm_schedule(m, k, nn, e)),
              bitwise_old=True, equals_gmm_w8a8_grouped_one_group=True,
              gmm_w8a8_grouped_same_codes_device_ms=device_ms(k8, reps),
              **_ab(old, new, reps), **_bound(nbytes, 2 * m * k * nn, "int8"))
        del aq, wq, out_old
        torch.cuda.empty_cache()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-csrc", required=True,
                    help="directory of the earlier csrc sources")
    ap.add_argument("--cases", nargs="+", choices=sorted(_OLD), default=["ffn"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("redesign_ab: needs a CUDA card")
    kernels.lib()
    old = build_old(args.old_csrc, args.cases)
    runs = {"gmm": gmm_cases, "attention": attention_cases, "ffn": ffn_cases,
            "grouped": grouped_cases, "weight_only": weight_only_cases,
            "ws": ws_cases, "act_quant": act_quant_cases,
            "int8_large": int8_large_cases, "fusedquant": fusedquant_cases,
            "bf16_large": bf16_large_cases, "wo_prefill": wo_prefill_cases,
            "grouped_prefill": grouped_prefill_cases,
            "mixed_prefill": mixed_prefill_cases, "asym_prefill": asym_prefill_cases}
    with torch.no_grad():
        for case in args.cases:
            runs[case](old, REPS)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi.splitlines()[0],
                      "device": torch.cuda.get_device_name(0),
                      "lost_traces": timing.LOST_TRACES[0]}))


if __name__ == "__main__":
    main()
