"""The port's native pack library (``mxmoe_tpu_torch.native``: the unedited
``csrc/mxmoe_pack.cpp`` built with g++ into ``mxmoe_tpu_torch/_build/``)
against the JAX package's reference functions, which need no library
(``quant.packing.quantize_weight_kn`` / ``pack_int4_rows``), and against the
port's plain PyTorch versions; and the packing additions (``storage_dtype_for``,
``pack_int4_rows`` / ``unpack_int4_rows``, ``quantize_act`` /
``dequantize_act``, ``shard_ragged_mixed``) bitwise ``mxmoe_tpu.quant.packing``.

Tolerances: codes and packed bytes bitwise; scales and zero points within
``tests/test_native.py``'s rtol 1e-5 / atol 1e-6 of JAX's, and bitwise the
plain versions' (the same f32 operations in the same order)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.quant import packing as jpack
from mxmoe_tpu.quant.schemes import QLinearConfig as JQ
from mxmoe_tpu_torch import native
from mxmoe_tpu_torch.native import build as native_build
from mxmoe_tpu_torch.quant import packing as tpack
from mxmoe_tpu_torch.quant.schemes import QLinearConfig as TQ

RTN_CASES = [(32, 64, -1, 8, True), (16, 128, 32, 4, False), (16, 128, 128, 4, True),
             (8, 256, 64, 8, False), (20, 96, 32, 3, False), (12, 64, 16, 2, True)]


def test_library_is_built_into_the_port_build_dir():
    path = native_build.build()
    assert os.path.dirname(path) == os.path.abspath(native_build.BUILD_DIR)
    assert os.path.basename(path).startswith("libmxmoe_pack_") and os.path.exists(path)
    assert native.available()


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "SOURCE", str(bad))
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_build.build()


@pytest.mark.parametrize("rows,k,g,bits,sym", RTN_CASES)
def test_rtn_quant_matches_jax_and_plain(rows, k, g, bits, sym):
    w = np.random.default_rng(rows * k + bits).standard_normal((rows, k)).astype(np.float32)
    codes, scales, zps = native.rtn_quant(w, g, bits, sym)
    p = jpack.quantize_weight_kn(jnp.asarray(w).T, JQ(w_bits=bits, w_gsize=g, w_sym=sym))
    np.testing.assert_array_equal(codes, np.asarray(p.values, np.int8).T)
    np.testing.assert_allclose(scales, np.asarray(p.scale).T, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(zps, np.asarray(p.zp).T, rtol=1e-5, atol=1e-6)
    pc, ps, pz = native.rtn_quant_plain(w, g, bits, sym)
    np.testing.assert_array_equal(codes, pc)
    np.testing.assert_array_equal(scales, ps)
    np.testing.assert_allclose(zps, pz, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("k,n", [(64, 32), (2, 7), (128, 96)])
def test_pack_int4_matches_jax_and_plain(k, n):
    codes = np.random.default_rng(k + n).integers(-8, 8, size=(k, n)).astype(np.int8)
    got = native.pack_int4(codes)
    np.testing.assert_array_equal(got, np.asarray(jpack.pack_int4_rows(jnp.asarray(codes))))
    np.testing.assert_array_equal(got, native.pack_int4_plain(codes))
    np.testing.assert_array_equal(native.pack_int4(torch.from_numpy(codes)), got)


def test_transpose_and_bf16_match_plain():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((100, 70)).astype(np.float32)
    np.testing.assert_array_equal(native.transpose_f32(a), a.T)
    np.testing.assert_array_equal(native.transpose_f32_plain(a), a.T)
    f = rng.standard_normal(1000).astype(np.float32)
    bits = (f.view(np.uint32) >> 16).astype(np.uint16)
    np.testing.assert_array_equal(native.bf16_to_f32(bits), native.bf16_to_f32_plain(bits))
    np.testing.assert_array_equal(native.bf16_to_f32(bits),
                                  (bits.astype(np.uint32) << 16).view(np.float32))


def test_matches_the_jax_library_where_built():
    """Bitwise the JAX package's own native functions, where its library
    (git-ignored) is built."""
    from mxmoe_tpu import native as jnative

    if not jnative.available():
        pytest.skip("mxmoe_tpu/native/libmxmoe_pack.so is not built")
    w = np.random.default_rng(5).standard_normal((24, 128)).astype(np.float32)
    for g, bits, sym in ((-1, 8, True), (32, 4, False)):
        for a, b in zip(native.rtn_quant(w, g, bits, sym), jnative.rtn_quant(w, g, bits, sym)):
            np.testing.assert_array_equal(a, b)
    codes = np.random.default_rng(6).integers(-8, 8, size=(64, 40)).astype(np.int8)
    np.testing.assert_array_equal(native.pack_int4(codes), jnative.pack_int4(codes))


def test_storage_dtype_for():
    assert tpack.storage_dtype_for(4) is torch.int8
    assert tpack.storage_dtype_for(8) is torch.int8
    with pytest.raises(ValueError):
        tpack.storage_dtype_for(16)


@pytest.mark.parametrize("shape", [(16, 8), (3, 32, 6)])
def test_pack_int4_rows_bitwise_jax(shape):
    codes = np.random.default_rng(1).integers(-8, 8, size=shape).astype(np.int8)
    got = tpack.pack_int4_rows(torch.from_numpy(codes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpack.pack_int4_rows(jnp.asarray(codes))))
    np.testing.assert_array_equal(tpack.unpack_int4_rows(got).numpy(), codes)
    np.testing.assert_array_equal(
        tpack.unpack_int4_rows(got).numpy(),
        np.asarray(jpack.unpack_int4_rows(jnp.asarray(got.numpy()))))


@pytest.mark.parametrize("kw", [dict(a_bits=8), dict(a_bits=4, a_gsize=16),
                                dict(a_bits=4, a_gsize=16, a_sym=False),
                                dict(a_bits=8, a_sym=False), dict(a_bits=2, a_gsize=32)])
def test_quantize_act_bitwise_jax(kw):
    x = np.random.default_rng(2).standard_normal((8, 64)).astype(np.float32)
    pj = jpack.quantize_act(jnp.asarray(x), JQ(**kw))
    pt = tpack.quantize_act(torch.from_numpy(x), TQ(**kw))
    for a, b in ((pt.values, pj.values), (pt.scale, pj.scale), (pt.zp, pj.zp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (pt.bits, pt.gsize, pt.sym) == (pj.bits, pj.gsize, pj.sym)
    np.testing.assert_array_equal(tpack.dequantize_act(pt).numpy(),
                                  np.asarray(jpack.dequantize_act(pj)))


@pytest.mark.parametrize("e,ep", [(8, 4), (6, 4), (60, 8), (5, 2)])
def test_shard_ragged_mixed_bitwise_jax(e, ep):
    k, n = 16, 12
    rng = np.random.default_rng(e * ep)
    codes = rng.integers(-8, 8, size=(e, k, n)).astype(np.int8)
    pf = (np.arange(e) % 3 != 0).astype(np.int32)
    cat_j, blk_j = jpack.build_ragged_mixed(jnp.asarray(codes), pf)
    cat_t, blk_t = tpack.build_ragged_mixed(torch.from_numpy(codes), pf)
    assert blk_t == list(blk_j)
    got, blk_l = tpack.shard_ragged_mixed(cat_t, blk_t, pf, k, ep)
    ref, blk_lj = jpack.shard_ragged_mixed(cat_j, np.asarray(blk_j), pf, k, ep)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert blk_l == list(blk_lj)
