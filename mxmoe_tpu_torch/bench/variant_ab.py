"""Variants of the weight-only decode body (``csrc/gmm_weight_only_tile.cuh``)
against the package's own, in one process on one card, by device time
(``bench.timing.device_ms``), in turns (the package's, each variant, then
the same in reverse). A variant is an edited copy of ``mxmoe_tpu_torch/csrc``
in a directory that git ignores; its three weight-only sources
(``gmm_weight_only.cu``, ``gmm_weight_only_packed.cu``,
``gmm_mixed_wo_wxa.cu``) are built into a library of their own, with the
package's C signatures, and swapped in for the wrappers' library while they
are timed. Shapes: qwen2_moe's routed gate_up and down at 16 routed rows
(K6, K7, K10 with experts alternating) and its weight-only shared expert
(E = 1, M 4: K6, K7), g128 with zero points. One JSON line per shape and
kernel; whether each variant's output equals the package's bit for bit
(a variant that drops work to time the rest does not).

    python -m mxmoe_tpu_torch.bench.variant_ab --variant name=DIR [...]

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

SOURCES = ("gmm_weight_only.cu", "gmm_weight_only_packed.cu", "gmm_mixed_wo_wxa.cu")
ENTRY_POINTS = ("mxmoe_gmm_weight_only", "mxmoe_gmm_weight_only_packed",
                "mxmoe_gmm_mixed_wo_wxa")
GSIZE = 128


def build_variant(csrc: str) -> ctypes.CDLL:
    """nvcc a variant's weight-only sources (together), link, load."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    out = tempfile.mkdtemp(dir=kernels.BUILD_DIR, prefix="variant_")
    objs = [os.path.join(out, s[:-3] + ".o") for s in SOURCES]
    procs = [subprocess.Popen([nvcc, *kernels.NVCC_FLAGS, "-c", "-o", o,
                               os.path.join(csrc, s)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for s, o in zip(SOURCES, objs)]
    for p in procs:
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on a variant in {csrc}:\n{err}")
    path = os.path.join(out, "libvariant.so")
    subprocess.run([nvcc, "-shared", "-o", path, *objs], check=True)
    lib = ctypes.CDLL(path)
    for name in ENTRY_POINTS:
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
    order = list(libs) + list(libs)[::-1]
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
            print(json.dumps({"use": use, "kernel": name, "M": rows, "K": k, "N": nn,
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
    ap.add_argument("--split-sweep", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("variant_ab: needs a CUDA card")
    with torch.no_grad():
        if args.split_sweep:
            split_sweep()
        else:
            variants(dict(v.split("=", 1) for v in args.variant))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi.splitlines()[0],
                      "device": torch.cuda.get_device_name(0),
                      "lost_traces": timing.LOST_TRACES[0]}))


if __name__ == "__main__":
    main()
