"""Variants of a kernel body against the package's own, in one process on
one card, by device time (``bench.timing.device_ms``), in turns (the
package's, each variant, then the same in reverse). A variant is an edited
copy of ``mxmoe_tpu_torch/csrc`` in a directory that git ignores; the
kernel's sources are built into a library of their own, with the package's
C signatures, and swapped in for the wrappers' library while they are
timed. One JSON line per shape and kernel; whether each variant's output
equals the package's bit for bit (a variant that drops work to time the
rest does not).

    python -m mxmoe_tpu_torch.bench.variant_ab \\
        [--kernel weight_only|ws|act_quant|wgmma|bf16] --variant name=DIR [...]

* ``weight_only`` (the default): the weight-only decode body
  (``csrc/gmm_weight_only_tile.cuh``; sources ``gmm_weight_only.cu``,
  ``gmm_weight_only_packed.cu``, ``gmm_mixed_wo_wxa.cu``) at qwen2_moe's
  routed gate_up and down at 16 routed rows (K6, K7, K10 with experts
  alternating) and its weight-only shared expert (E = 1, M 4: K6, K7), g128
  with zero points.
* ``ws``: K15's body (``gmm_ws.cu``), int8 and nibble-packed, at the
  headline workload's gate_up and down (every expert's rows padded to 128).
* ``wgmma``: the wgmma body of ``gmm_ws_body.cuh`` and K14's bodies
  (sources ``gmm_w8a8.cu``, ``gmm_w4a8_packed.cu``, ``gmm_ws.cu``,
  ``gmm_w8a8_fusedquant.cu``): K2 and K5 at qwen2_moe's 256-token prefill
  chunk (gate_up, down) and the headline's 32762 unaligned rows (gate_up),
  K15 on the aligned layout, K14 at decode (M 16), the prefill chunk and
  the headline's rows.
* ``bf16``: K11's bodies (``gmm_bf16.cu``) with bf16 operands through the
  wrapper, at ``workloads.k11_shapes`` (the prefill chunks, qwen2_moe's
  routing at M 16-4096, the profiler's three scales, the headline pair),
  each variant's output held within ``gmm.error_over_bound`` (printed; a
  variant that drops work fails it).
* ``act_quant``: K1's bodies (``act_quant.cu``) at the headline's rows
  (36736 x 2048 / 1408, 8192 x 5632), prefill chunks (4096 and 1024 x 2048)
  and decode (16 x 2048), bf16, per-row bits 4 / 8 / 16.

``--split-sweep`` times K6 and K7 at the shared expert's shapes instead, by
split count (1-16), through the C entry points with schedules made by hand
(ceil(G / splits) groups a split), beside ``weight_only_gmm_schedule``'s
own count.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import tempfile

import torch

from ..models import configs
from ..ops import gmm_mixed_wo_wxa as gmx, gmm_weight_only as gwo
from ..ops import gmm_weight_only_packed as gwop, kernels
from ..ops.dispatch import make_dispatch, route_topk
from ..ops.gmm_w8a8 import _PART_INTS, Int8GemmSchedule, schedule_args
from ..ops.gmm_w8a8_grouped import weight_only_gmm_schedule
from ..quant.packing import pack_int4_halves
from ..utils.device import find_nvcc
from . import timing
from .timing import device_ms

# kernel -> (its sources, its C entry points)
KERNEL_SETS = {
    "weight_only": (("gmm_weight_only.cu", "gmm_weight_only_packed.cu",
                     "gmm_mixed_wo_wxa.cu"),
                    ("mxmoe_gmm_weight_only", "mxmoe_gmm_weight_only_packed",
                     "mxmoe_gmm_mixed_wo_wxa")),
    "ws": (("gmm_ws.cu",), ("mxmoe_gmm_ws",)),
    "act_quant": (("act_quant.cu",), ("mxmoe_quantize_rows",)),
    "wgmma": (("gmm_w8a8.cu", "gmm_w4a8_packed.cu", "gmm_ws.cu",
               "gmm_w8a8_fusedquant.cu"),
              ("mxmoe_gmm_w8a8", "mxmoe_gmm_w4a8_packed", "mxmoe_gmm_ws",
               "mxmoe_gmm_w8a8_fusedquant")),
    "bf16": (("gmm_bf16.cu",), ("mxmoe_gmm_bf16",)),
}
GSIZE = 128


def build_variant(csrc: str, kernel: str = "weight_only") -> ctypes.CDLL:
    """nvcc a variant's sources of ``kernel`` (together), link, load."""
    sources, entry_points = KERNEL_SETS[kernel]
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    out = tempfile.mkdtemp(dir=kernels.BUILD_DIR, prefix="variant_")
    objs = [os.path.join(out, s[:-3] + ".o") for s in sources]
    procs = [subprocess.Popen([nvcc, *kernels.NVCC_FLAGS, "-c", "-o", o,
                               os.path.join(csrc, s)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for s, o in zip(sources, objs)]
    for p in procs:
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on a variant in {csrc}:\n{err}")
    path = os.path.join(out, "libvariant.so")
    subprocess.run([nvcc, "-shared", "-o", path, *objs], check=True)
    lib = ctypes.CDLL(path)
    for name in entry_points:
        getattr(lib, name).argtypes = kernels._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _shapes(gen, dev):
    cfg = configs.QWEN2_MOE_A2_7B
    h, n, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
    sn = cfg.shared_expert_intermediate_size
    gs = make_dispatch(route_topk(torch.randn((4, e), generator=gen, device=dev),
                                  cfg.top_k, cfg.norm_topk_prob), e).group_sizes
    one = torch.full((1,), 4, dtype=torch.int32, device=dev)
    return (("gate_up", gs, h, 2 * n), ("down", gs, n, h),
            ("shared gate_up", one, h, 2 * sn), ("shared down", one, sn, h))


def _operands(gen, dev, g_s, k, nn):
    ee, rows, groups = g_s.numel(), int(g_s.sum()), k // GSIZE
    x = torch.randn((rows, k), generator=gen, device=dev).to(torch.bfloat16)
    w4 = torch.randint(-8, 8, (ee, k, nn), generator=gen, device=dev, dtype=torch.int8)
    sc = torch.rand((ee, groups, nn), generator=gen, device=dev) * 0.02 + 1e-3
    zp = torch.randn((ee, groups, nn), generator=gen, device=dev) * 0.05
    return x, w4, sc, zp


def variants(named: dict) -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    libs = {"package": kernels.lib(), **{k: build_variant(d) for k, d in named.items()}}
    for use, g_s, k, nn in _shapes(gen, dev):
        x, w4, sc, zp = _operands(gen, dev, g_s, k, nn)
        ee, rows = g_s.numel(), int(g_s.sum())
        packed = pack_int4_halves(w4)
        runs = {"gmm_weight_only": lambda: gwo.gmm_weight_only(x, w4, sc, zp, g_s, GSIZE),
                "gmm_weight_only_packed": lambda: gwop.gmm_weight_only_packed(
                    x, packed, sc, zp, g_s, GSIZE)}
        if ee > 1:
            aq = torch.randint(-127, 128, (rows, k), generator=gen, device=dev,
                               dtype=torch.int8)
            asc = torch.rand((rows, k // GSIZE), generator=gen, device=dev) * 0.05
            fl = torch.tensor([i % 2 == 0 for i in range(ee)], dtype=torch.int32,
                              device=dev)
            runs["gmm_mixed_wo_wxa"] = lambda: gmx.gmm_mixed_wo_wxa(
                x, aq, asc, w4, sc, fl, g_s, rhs_zp=zp)
        for name, fn in runs.items():
            times, same = _timed_in_turns(libs, fn)
            print(json.dumps({"use": use, "kernel": name, "M": rows, "K": k, "N": nn,
                              "device_ms": {v: sum(t) / len(t) for v, t in times.items()},
                              "device_ms_turns": times, "bitwise_package": same}),
                  flush=True)


def _timed_in_turns(libs: dict, fn) -> tuple[dict, dict]:
    """Each library's device ms of ``fn`` in turns (there and back), and
    whether its output equals the package's."""
    order = list(libs) + list(libs)[::-1]
    times = {v: [] for v in libs}
    same = {}
    try:
        ref = fn().clone()
        for v in order:
            kernels._lib = libs[v]
            same[v] = bool(torch.equal(fn(), ref))
            times[v].append(device_ms(fn))
    finally:
        kernels._lib = libs["package"]
    return times, same


def ws_variants(named: dict) -> None:
    from ..ops import gmm_ws
    from . import workloads

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    libs = {"package": kernels.lib(),
            **{k: build_variant(d, "ws") for k, d in named.items()}}
    for wl in workloads.qwen2_moe_l10_bs8192():
        sizes = [(s + 127) // 128 * 128 for s in wl.group_sizes]
        m, k, nn, e = sum(sizes), wl.k, wl.n, len(sizes)
        aq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        asc = torch.rand((m, 1), generator=gen, device=dev) * 0.05
        wsc = torch.rand((e, 1, nn), generator=gen, device=dev) * 0.01
        w8 = torch.randint(-127, 128, (e, k, nn), generator=gen, device=dev,
                           dtype=torch.int8)
        w4 = pack_int4_halves(torch.randint(-8, 8, (e, k, nn), generator=gen,
                                            device=dev, dtype=torch.int8))
        for form, fn in (("int8", lambda: gmm_ws.gmm_w8a8_ws(aq, asc, w8, wsc, sizes)),
                         ("packed", lambda: gmm_ws.gmm_w4a8_packed_ws(aq, asc, w4, wsc,
                                                                      sizes))):
            times, same = _timed_in_turns(libs, fn)
            print(json.dumps({"kernel": "gmm_ws", "form": form, "workload": wl.name,
                              "M": m, "K": k, "N": nn,
                              "device_ms": {v: sum(t) / len(t) for v, t in times.items()},
                              "device_ms_turns": times, "bitwise_package": same}),
                  flush=True)
        del w8, w4


def wgmma_variants(named: dict) -> None:
    from ..ops import gmm_w4a8_packed as g4p, gmm_w8a8 as g8, gmm_w8a8_fusedquant as gfq
    from ..ops import gmm_ws
    from . import workloads

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(41)
    libs = {"package": kernels.lib(),
            **{k: build_variant(d, "wgmma") for k, d in named.items()}}
    cfg = configs.QWEN2_MOE_A2_7B
    h, n, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts

    def routed(tokens):
        logits = torch.randn((tokens, e), generator=gen, device=dev)
        return make_dispatch(route_topk(logits, cfg.top_k, cfg.norm_topk_prob),
                             e).group_sizes

    chunk = routed(256)
    headline = torch.tensor(workloads.QWEN2_MOE_L10_BS8192_ROUTED_M, dtype=torch.int32,
                            device=dev)
    aligned = [(s + 127) // 128 * 128 for s in workloads.QWEN2_MOE_L10_BS8192_ROUTED_M]
    for use, gs, k, nn in (("prefill chunk gate_up", chunk, h, 2 * n),
                           ("prefill chunk down", chunk, n, h),
                           ("headline gate_up", headline, h, 2 * n),
                           ("headline aligned gate_up", None, h, 2 * n)):
        sizes = aligned if gs is None else gs.tolist()
        m = sum(sizes)
        aq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        asc = torch.rand((m, 1), generator=gen, device=dev) * 0.05
        wsc = torch.rand((e, 1, nn), generator=gen, device=dev) * 0.01
        w8 = torch.randint(-127, 128, (e, k, nn), generator=gen, device=dev,
                           dtype=torch.int8)
        w4 = pack_int4_halves(torch.randint(-8, 8, (e, k, nn), generator=gen,
                                            device=dev, dtype=torch.int8))
        if gs is None:
            runs = {"gmm_ws": lambda: gmm_ws.gmm_w8a8_ws(aq, asc, w8, wsc, sizes)}
        else:
            runs = {"gmm_w8a8": lambda: g8.gmm_w8a8(aq, asc, w8, wsc, gs),
                    "gmm_w4a8_packed": lambda: g4p.gmm_w4a8_packed(aq, asc, w4, wsc, gs)}
        for name, fn in runs.items():
            times, same = _timed_in_turns(libs, fn)
            print(json.dumps({"use": use, "kernel": name, "M": m, "K": k, "N": nn,
                              "device_ms": {v: sum(t) / len(t) for v, t in times.items()},
                              "device_ms_turns": times, "bitwise_package": same}),
                  flush=True)
        del aq, w8, w4
    for use, gs in (("decode", routed(4)), ("prefill chunk", chunk),
                    ("headline", headline)):
        m = int(gs.sum())
        x = (torch.randn((m, h), generator=gen, device=dev) * 2).to(torch.bfloat16)
        wq = torch.randint(-127, 128, (e, h, 2 * n), generator=gen, device=dev,
                           dtype=torch.int8)
        ws = torch.rand((e, 1, 2 * n), generator=gen, device=dev) * 0.01 + 1e-4
        times, same = _timed_in_turns(libs, lambda: gfq.gmm_w8a8_fusedquant(x, wq, ws, gs))
        print(json.dumps({"use": use, "kernel": "gmm_w8a8_fusedquant", "M": m, "K": h,
                          "N": 2 * n,
                          "device_ms": {v: sum(t) / len(t) for v, t in times.items()},
                          "device_ms_turns": times, "bitwise_package": same}), flush=True)


def bf16_variants(named: dict) -> None:
    from ..ops import gmm as gfl
    from . import workloads

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(43)
    libs = {"package": kernels.lib(),
            **{k: build_variant(d, "bf16") for k, d in named.items()}}

    def routed(model, tokens):
        cfg = configs.config_for(model)
        logits = torch.randn((tokens, cfg.num_experts), generator=gen, device=dev)
        return make_dispatch(route_topk(logits, cfg.top_k, cfg.norm_topk_prob),
                             cfg.num_experts).group_sizes.tolist()

    for use, sizes, k, nn in workloads.k11_shapes(routed):
        m, e = sum(sizes), len(sizes)
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((e, k, nn), generator=gen, device=dev) * 0.02).to(torch.bfloat16)

        def fn():
            return gfl.gmm_bf16(x, w, gs)

        times, same = _timed_in_turns(libs, fn)
        ratio = {}
        for v, lib in libs.items():
            kernels._lib = lib
            try:
                ratio[v] = gfl.error_over_bound(fn(), x, w, gs)[1]
            finally:
                kernels._lib = libs["package"]
        print(json.dumps({"use": use, "kernel": "gmm_bf16", "M": m, "K": k, "N": nn,
                          "body": gfl.bf16_gmm_schedule().body,
                          "device_ms": {v: sum(t) / len(t) for v, t in times.items()},
                          "device_ms_turns": times, "bitwise_package": same,
                          "err_over_bound": ratio}), flush=True)
        del x, w
        torch.cuda.empty_cache()


def act_quant_variants(named: dict) -> None:
    from ..ops import act_quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(37)
    libs = {"package": kernels.lib(),
            **{k: build_variant(d, "act_quant") for k, d in named.items()}}
    for m, k in ((36736, 2048), (36736, 1408), (8192, 5632), (4096, 2048),
                 (1024, 2048), (16, 2048)):
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        bits = torch.tensor([4.0, 8.0, 16.0], device=dev).repeat(m)[:m].contiguous()
        times, same = _timed_in_turns(libs, lambda: act_quant.quantize_rows(x, bits)[0])
        print(json.dumps({"kernel": "quantize_rows", "M": m, "K": k,
                          "device_ms": {v: sum(t) / len(t) for v, t in times.items()},
                          "device_ms_turns": times, "bitwise_package": same}),
              flush=True)


def split_sweep() -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    lib = kernels.lib()
    for use, g_s, k, nn in _shapes(gen, dev)[2:]:
        x, w4, sc, zp = _operands(gen, dev, g_s, k, nn)
        packed = pack_int4_halves(w4)
        m, groups, grid_n = int(g_s.sum()), k // GSIZE, nn // 64
        own = weight_only_gmm_schedule(m, k, nn, 1, GSIZE).splits
        for want in (1, 2, 3, 4, 6, 8, 11, 16):
            per = -(-groups // want)
            splits = -(-groups // per)
            sched = Int8GemmSchedule(16, 64, grid_n, 1, splits, per * GSIZE // 64,
                                     grid_n * splits * per * _PART_INTS if splits > 1
                                     else 0, grid_n if splits > 1 else 0)
            args, _ws = schedule_args(sched, dev)
            out = torch.empty((m, nn), dtype=torch.bfloat16, device=dev)
            times = {}
            for name, w in (("mxmoe_gmm_weight_only", w4),
                            ("mxmoe_gmm_weight_only_packed", packed)):
                def call(fn=getattr(lib, name), w=w):
                    kernels.check(fn(x.data_ptr(), w.data_ptr(), sc.data_ptr(),
                                     zp.data_ptr(), g_s.data_ptr(), out.data_ptr(), 1,
                                     m, k, nn, 1, GSIZE, *args, kernels.stream_ptr(dev)),
                                  name)
                    return out
                call()
                torch.cuda.synchronize()
                times[name.removeprefix("mxmoe_")] = device_ms(call)
            ratio = gwo.error_over_bound(out, x, w4, sc, zp, g_s, GSIZE)[1]
            print(json.dumps({"use": use, "M": m, "K": k, "N": nn, "splits": splits,
                              "schedule_splits": own, "blocks": grid_n * splits,
                              "err_over_bound": ratio, "device_ms": times}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="name=DIR of an edited copy of mxmoe_tpu_torch/csrc")
    ap.add_argument("--kernel", default="weight_only", choices=sorted(KERNEL_SETS))
    ap.add_argument("--split-sweep", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("variant_ab: needs a CUDA card")
    with torch.no_grad():
        named = dict(v.split("=", 1) for v in args.variant)
        if args.split_sweep:
            split_sweep()
        elif args.kernel == "ws":
            ws_variants(named)
        elif args.kernel == "act_quant":
            act_quant_variants(named)
        elif args.kernel == "wgmma":
            wgmma_variants(named)
        elif args.kernel == "bf16":
            bf16_variants(named)
        else:
            variants(named)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi.splitlines()[0],
                      "device": torch.cuda.get_device_name(0),
                      "lost_traces": timing.LOST_TRACES[0]}))


if __name__ == "__main__":
    main()
