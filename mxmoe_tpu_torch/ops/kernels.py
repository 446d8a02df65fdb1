"""Build, load and count the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source compiles to an object in its own ``nvcc``
process, all started together, and one more ``nvcc`` call links them into
a shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so the build takes seconds). The build happens at first
use, into ``mxmoe_tpu_torch/_build/`` (git-ignored), keyed by a hash of
the sources, headers and flags so an edited source rebuilds.
``--use_fast_math`` is deliberately absent: the quantizing kernels' codes
depend on IEEE division and rounding.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise on a non-zero code. ``launches`` counts kernel launches
per wrapper (only where the kernel is launched, never for the plain
versions), so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import tempfile
import time

import torch

from ..utils.device import find_nvcc

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

KERNELS = ("quantize_rows", "gmm_w8a8", "decode_attention_update_stacked",
           "decode_attention_update_stacked_q8", "gmm_mixed_packed",
           "gmm_w4a8_packed", "gmm_weight_only", "gmm_weight_only_packed",
           "gmm_w8a8_grouped", "gmm_w8a8_asym", "gmm_mixed_packed_flex",
           "gmm_mixed_wo_wxa", "gmm_bf16", "gmm_ffn_w8a8", "gmm_ffn_mixed_packed",
           "gmm_w8a8_fusedquant", "gmm_ws", "decode_attention_stacked",
           "decode_attention_stacked_q8", "decode_attention", "decode_attention_q8")
launches = {name: 0 for name in KERNELS}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SCHED = [_I, _I, _I, _I, _P, _P]
_SIGNATURES = {
    # x, x_is_bf16, bits, gain, q, scale, M, K, stream
    "mxmoe_quantize_rows": [_P, _I, _P, _F, _P, _P, _I, _I, _P],
    # the int8 grouped GEMMs (K2, K4, K5, K9) end in the schedule of
    # gmm_w8a8.int8_gmm_schedule: bm, grid_m, splits, k_tiles_per_split,
    # workspace, tickets; then the stream.
    # lhs, s_a, rhs, s_b, group_sizes, out, out_is_bf16, M, K, N, E, ...
    "mxmoe_gmm_w8a8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, *_SCHED, _P],
    # q, k_new, v_new, is_bf16, cache_k, cache_v, lengths, valid, out,
    # workspace, tickets, layer, B, n_h, n_kv, S, dk, dv, chunk, n_split,
    # scale, stream
    "mxmoe_decode_attention_update": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # q, k_new, v_new, is_bf16, cache_k, cache_ks, cache_v, cache_vs, lengths,
    # valid, out, workspace, tickets, layer, B, n_h, n_kv, S, dk, dv, chunk,
    # n_split, scale, stream
    "mxmoe_decode_attention_update_q8": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                                         _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                         _I, _I, _F, _P],
    # the read-only forms: q, is_bf16, cache_k, cache_v, lengths, out,
    # workspace, tickets, layer, B, n_h, n_kv, S, dk, dv, chunk, n_split,
    # scale, stream
    "mxmoe_decode_attention": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _F, _P],
    # q, is_bf16, cache_k, cache_ks, cache_v, cache_vs, lengths, out,
    # workspace, tickets, layer, B, n_h, n_kv, S, dk, dv, chunk, n_split,
    # scale, stream
    "mxmoe_decode_attention_q8": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # lhs, s_a, rhs_cat, s_b, group_sizes, pflags, blk_offsets, out,
    # out_is_bf16, M, K, N, E, schedule, stream
    "mxmoe_gmm_mixed_packed": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, *_SCHED, _P],
    # lhs, s_a, rhs_packed, s_b, group_sizes, out, out_is_bf16, M, K, N, E,
    # schedule, stream
    "mxmoe_gmm_w4a8_packed": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, *_SCHED,
                              _P],
    # lhs, rhs_q | rhs_packed, scale, zp, group_sizes, out, out_is_bf16, M, K,
    # N, E, gsize, schedule (gmm_w8a8_grouped.weight_only_gmm_schedule), stream
    "mxmoe_gmm_weight_only": [_P] * 6 + [_I] * 6 + [*_SCHED, _P],
    "mxmoe_gmm_weight_only_packed": [_P] * 6 + [_I] * 6 + [*_SCHED, _P],
    # lhs, s_a, rhs, s_b, zp (may be null), group_sizes, out, out_is_bf16, M,
    # K, N, E, gsize, schedule (gmm_w8a8_grouped.grouped_gmm_schedule), stream
    "mxmoe_gmm_w8a8_grouped": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, *_SCHED, _P],
    # lhs, s_a, rhs, s_b, zp, group_sizes, out, out_is_bf16, M, K, N, E,
    # schedule, stream
    "mxmoe_gmm_w8a8_asym": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            *_SCHED, _P],
    # lhs, s_a, rhs_cat, s_b, zp (may be null), group_sizes, pflags,
    # blk_offsets, out, out_is_bf16, M, K, N, E, gsize, schedule, stream
    "mxmoe_gmm_mixed_packed_flex": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _I, _I, _I, _I, *_SCHED, _P],
    # lhs (bf16), lhs_q, s_a, rhs, s_b, zp (may be null), scheme_flags,
    # group_sizes, out, out_is_bf16, M, K, N, E, gsize, schedule (the same
    # weight_only_gmm_schedule for both bodies), stream
    "mxmoe_gmm_mixed_wo_wxa": [_P] * 9 + [_I] * 6 + [*_SCHED, _P],
    # lhs, rhs, group_sizes, out, in_is_bf16, out_is_bf16, M, K, N, E, stream
    "mxmoe_gmm_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # lhs, s_a, gate_up, s_gu, down, s_d, group_sizes, act_bits_down, out,
    # out_is_bf16, M, K, N, H, E, stream
    "mxmoe_gmm_ffn_w8a8": [_P] * 9 + [_I] * 6 + [_P],
    # lhs, s_a, gu_cat, s_gu, gu_pf, gu_blk, down_cat, s_d, d_pf, d_blk,
    # group_sizes, act_bits_down, out, out_is_bf16, M, K, N, H, E, stream
    "mxmoe_gmm_ffn_mixed_packed": [_P] * 13 + [_I] * 6 + [_P],
    # N, H -> dynamic shared bytes of the two calls above (-1: the widths do
    # not fit the layout)
    "mxmoe_gmm_ffn_smem_bytes": [_I, _I],
    # N, H -> the clusters the grid of the call above holds (-error)
    "mxmoe_gmm_ffn_w8a8_clusters": [_I, _I],
    "mxmoe_gmm_ffn_mixed_packed_clusters": [_I, _I],
    # lhs, lhs_is_bf16, rhs, s_b, group_sizes, out, out_is_bf16, upper, M, K,
    # N, E, stream
    "mxmoe_gmm_w8a8_fusedquant": [_P, _I, _P, _P, _P, _P, _I, _F, _I, _I, _I, _I,
                                  _P],
    # lhs, s_a, rhs, s_b, static sizes (host ints), out, packed, out_is_bf16,
    # M, K, N, E, stream
    "mxmoe_gmm_ws": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # K -> dynamic shared bytes of the call above
    "mxmoe_gmm_ws_smem_bytes": [_I],
}

_lib = None
build_seconds: float | None = None


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libmxmoe_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels if this source set has no library yet; returns
    its path. A compile records its wall time in ``build_seconds``.
    ``verbose`` prints what ``ptxas -v`` says (registers, shared memory,
    spills) for every source."""
    global build_seconds
    path = library_path()
    if os.path.exists(path):
        return path
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH)")
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        extra = ["-Xptxas", "-v"] if verbose else []
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src)[:-3] + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        # wait for every compile (none is left running), then report
        results = [(src, proc.communicate(), proc.returncode)
                   for src, proc in procs]
        for src, (out, err), rc in results:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}) on {src}:\n{err}")
            if verbose:
                print(os.path.basename(src) + ":\n" + out + err)
        lib_tmp = os.path.join(tmp, "lib.so")
        res = subprocess.run([nvcc, "-shared", "-o", lib_tmp, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        os.replace(lib_tmp, path)      # atomic: a reader never sees half a file
    build_seconds = time.perf_counter() - t0
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


_tickets: dict = {}


def tickets(device: torch.device, n: int) -> torch.Tensor:
    """``n`` int32 tickets on ``device``, all 0: the counters by which the
    last block of a tile or head finds itself (decode attention, split-K).
    Kept across calls: the last block resets its ticket to 0, so they are
    zeroed once, when first made or grown."""
    key = (device.type, device.index)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros((max(n, 1024),), dtype=torch.int32, device=device)
        _tickets[key] = t
    return t


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(cond: bool, msg: str) -> None:
    """Wrapper argument check: raises ValueError (survives ``python -O``)."""
    if not cond:
        raise ValueError(msg)


def group_size(k: int, gsize: int, name: str) -> int:
    """A wrapper's ``gsize`` argument (-1: one group, all of K) -> codes per
    scale group, which must divide K."""
    gsize = k if gsize == -1 else int(gsize)
    require(gsize > 0 and k % gsize == 0,
            f"{name}: K={k} is not a multiple of gsize={gsize}")
    return gsize
