"""The redesigned kernel bodies against the bodies they replaced, in one
process on one card, at the shapes of the main path, by device time
(``bench.timing.device_ms``) and event time, old and new in ABBA order. Five
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
  rows old and new bitwise.

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
PEAK = {"int8": 1979e12, "bf16": 989e12}
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
            "grouped": grouped_cases, "weight_only": weight_only_cases}
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
