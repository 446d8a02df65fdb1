"""Native (C++) host kernels through ctypes (port of ``mxmoe_tpu/native``).

The library is ``csrc/mxmoe_pack.cpp``, unedited, built with ``g++`` into
``mxmoe_tpu_torch/_build/`` at first use (``native.build``). Where the JAX
wrapper falls back to jax when its library is missing, the port builds it,
and raises when the build fails. Beside each entry point stands a plain
PyTorch version under its own name (``*_plain``): the same function in
torch ops, which the tests hold the library against.

The entry points take numpy arrays or CPU tensors and return numpy arrays:
they are host-side loops of the checkpoint converter.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build as _build

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    # w, rows, k, gsize, bits, sym, codes, scales, zps
    "mxmoe_rtn_quant": [_P, _I64, _I64, _INT, _INT, _INT, _P, _P, _P],
    # codes [k, n], k, n, out [k/2, n]
    "mxmoe_pack_int4": [_P, _I64, _I64, _P],
    # src [rows, cols], rows, cols, dst [cols, rows]
    "mxmoe_transpose_f32": [_P, _I64, _I64, _P],
    # src (uint16 bf16 bits), count, dst
    "mxmoe_bf16_to_f32": [_P, _I64, _P],
}
_lib = None


def lib() -> ctypes.CDLL:
    """The loaded library, built at first use (raises if it cannot be)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(_build.build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = None
        _lib = handle
    return _lib


def available() -> bool:
    """True once the library is built and loaded (building it if need be)."""
    return lib() is not None


def _host(a, dtype) -> np.ndarray:
    """numpy or CPU tensor -> a C-contiguous numpy array of ``dtype``."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"native: host tensors only, got {a.device}")
        a = a.numpy()
    return np.ascontiguousarray(a, dtype)


def rtn_quant(w, gsize: int, bits: int, sym: bool):
    """Row-grouped RTN quant of [rows, k] float32 -> (codes int8 [rows, k],
    scales [rows, k/g], zero points [rows, k/g]); asymmetric codes are
    re-centred to signed storage (``quant.packing`` convention)."""
    w = _host(w, np.float32)
    rows, k = w.shape
    g = k if gsize == -1 else gsize
    if k % g:
        raise ValueError(f"rtn_quant: k={k} is no multiple of gsize {g}")
    codes = np.empty((rows, k), np.int8)
    scales = np.empty((rows, k // g), np.float32)
    zps = np.empty((rows, k // g), np.float32)
    lib().mxmoe_rtn_quant(w.ctypes.data, rows, k, g, int(bits), int(sym),
                          codes.ctypes.data, scales.ctypes.data, zps.ctypes.data)
    return codes, scales, zps


def pack_int4(codes_kn) -> np.ndarray:
    """[k, n] signed int4 codes in int8 -> [k/2, n] nibble-packed int8, low
    nibble = even k (``quant.packing.pack_int4_rows``)."""
    codes_kn = _host(codes_kn, np.int8)
    k, n = codes_kn.shape
    if k % 2:
        raise ValueError(f"pack_int4: k={k} must be even")
    out = np.empty((k // 2, n), np.int8)
    lib().mxmoe_pack_int4(codes_kn.ctypes.data, k, n, out.ctypes.data)
    return out


def transpose_f32(a) -> np.ndarray:
    a = _host(a, np.float32)
    rows, cols = a.shape
    out = np.empty((cols, rows), np.float32)
    lib().mxmoe_transpose_f32(a.ctypes.data, rows, cols, out.ctypes.data)
    return out


def bf16_to_f32(raw) -> np.ndarray:
    """uint16 bf16 bit patterns -> float32."""
    raw = _host(raw, np.uint16)
    out = np.empty(raw.shape, np.float32)
    lib().mxmoe_bf16_to_f32(raw.ctypes.data, raw.size, out.ctypes.data)
    return out


# -- the plain PyTorch versions -------------------------------------------

def rtn_quant_plain(w, gsize: int, bits: int, sym: bool):
    """:func:`rtn_quant` in torch ops, step for step as the C++ loop (f32
    range, scale by the reciprocal, round half to even, clamp)."""
    w = torch.as_tensor(_host(w, np.float32))
    rows, k = w.shape
    g = k if gsize == -1 else gsize
    wg = w.reshape(rows, k // g, g)
    one = torch.tensor(1.0, dtype=torch.float32)
    if sym:
        upper = torch.tensor(float((1 << (bits - 1)) - 1), dtype=torch.float32)
        s = wg.abs().amax(-1) / upper
        zp = torch.zeros_like(s)
        inv = torch.where(s == 0, torch.zeros_like(s), one / s)
        q = torch.round(wg * inv[..., None]).clamp(-upper, upper)
    else:
        upper = torch.tensor(float((1 << bits) - 1), dtype=torch.float32)
        shift = torch.tensor(float(1 << (bits - 1)), dtype=torch.float32)
        mn, mx = wg.amin(-1), wg.amax(-1)
        s = (mx - mn) / upper
        inv = torch.where(s == 0, torch.zeros_like(s), one / s)
        q = torch.round((wg - mn[..., None]) * inv[..., None]).clamp(0, upper) - shift
        zp = mn + shift * s
    return (q.reshape(rows, k).to(torch.int8).numpy(), s.numpy(), zp.numpy())


def pack_int4_plain(codes_kn) -> np.ndarray:
    from ..quant.packing import pack_int4_rows

    return pack_int4_rows(torch.as_tensor(_host(codes_kn, np.int8))).numpy()


def transpose_f32_plain(a) -> np.ndarray:
    return torch.as_tensor(_host(a, np.float32)).t().contiguous().numpy()


def bf16_to_f32_plain(raw) -> np.ndarray:
    bits = torch.as_tensor(_host(raw, np.uint16).astype(np.int16))
    return bits.view(torch.bfloat16).float().numpy()
