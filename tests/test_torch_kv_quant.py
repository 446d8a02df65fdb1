"""Port parity: the int8 KV cache of mxmoe_tpu_torch.serving (QuantKVCache,
_quant_vec, scatter_layer_cache_quant, attention_with_quant_cache and the
plain version of kernel K3q) against mxmoe_tpu.serving.

The reference is run compiled (jax.jit), as every serving entry point runs
it: XLA then turns the scale's division by 127 into a multiply by the
float32 reciprocal, and the port computes the scale that way. Run op by op
the reference divides, and about half its scales differ by one ulp.

Tolerances: written codes and scales are bitwise equal. Attention outputs
agree to rtol = atol = 2e-5 in float32: the reference's blocked online
softmax (and XLA's einsum) sum in another order than the port's full
softmax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.serving import kv_cache as jkv
from mxmoe_tpu.serving.decode_attention import (
    decode_attention_update_stacked as jax_update)
from mxmoe_tpu_torch.models import configs
from mxmoe_tpu_torch.ops import kernels
from mxmoe_tpu_torch.params_from_jax import kv_cache_from_jax
from mxmoe_tpu_torch.serving import kv_cache as tkv
from mxmoe_tpu_torch.serving.decode_attention import decode_attention_update_stacked


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_vec_bitwise_vs_jitted_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 7, 3, 128)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0                                  # all-zero vector: 1e-8 floor
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    q_ref, s_ref = jax.jit(jkv._quant_vec)(xj)
    q, s = tkv._quant_vec(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


def _cache_arrays(rng, nl, b, n_kv, s_max, hd):
    kq = rng.integers(-127, 128, (nl, b, n_kv, s_max, hd)).astype(np.int8)
    vq = rng.integers(-127, 128, (nl, b, n_kv, s_max, hd)).astype(np.int8)
    ks = rng.uniform(0.005, 0.03, (nl, b, n_kv, s_max)).astype(np.float32)
    vs = rng.uniform(0.005, 0.03, (nl, b, n_kv, s_max)).astype(np.float32)
    return kq, ks, vq, vs


def test_scatter_and_attention_quant_vs_reference():
    """A prefill chunk: masked, capacity-dropping write + causal attention."""
    rng = np.random.default_rng(1)
    nl, b, n_kv, groups, hd, s_max, s_new, layer = 2, 3, 2, 2, 32, 24, 6, 1
    arrays = _cache_arrays(rng, nl, b, n_kv, s_max, hd)
    new_k = rng.standard_normal((b, s_new, n_kv, hd)).astype(np.float32)
    new_v = rng.standard_normal((b, s_new, n_kv, hd)).astype(np.float32)
    q = rng.standard_normal((b, s_new, n_kv * groups, hd)).astype(np.float32)
    lengths = np.asarray([0, 20, 9], np.int32)        # slot 1 overflows S_max
    valid = np.asarray([True, True, False])

    @jax.jit
    def ref_fn(kq, ks, vq, vs, nk, nv, qq, ln, vl):
        c = jkv.scatter_layer_cache_quant(kq, ks, vq, vs, layer, nk, nv, ln, valid=vl)
        out = jkv.attention_with_quant_cache(qq, c[0][layer], c[1][layer],
                                             c[2][layer], c[3][layer], ln, s_new)
        return c, out

    c_ref, out_ref = ref_fn(*map(jnp.asarray, (*arrays, new_k, new_v, q, lengths, valid)))
    c = [torch.from_numpy(a.copy()) for a in arrays]
    tkv.scatter_layer_cache_quant(*c, layer, torch.from_numpy(new_k),
                                  torch.from_numpy(new_v), torch.from_numpy(lengths),
                                  valid=torch.from_numpy(valid))
    for got, ref in zip(c, c_ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    out = tkv.attention_with_quant_cache(torch.from_numpy(q), *(a[layer] for a in c),
                                         torch.from_numpy(lengths), s_new)
    # slot 2 wrote nothing and its rows past lengths are garbage in both
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("lengths,valid", [
    ([0, 70, 128, 127], [1, 1, 1, 1]),       # empty, mid, full, last position
    ([5, 64, 128, 0], [0, 1, 0, 1]),         # masked writes, block boundary
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_update_q8_plain_vs_jax_kernel(lengths, valid, dtype):
    """K3q's plain version against the Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(sum(lengths))
    nl, b, n_kv, groups, hd, s_max, layer = 2, 4, 2, 2, 128, 128, 1
    n_h = n_kv * groups
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    q = rng.standard_normal((b, n_h, hd)).astype(np.float32)
    kn = rng.standard_normal((b, n_kv, hd)).astype(np.float32)
    vn = rng.standard_normal((b, n_kv, hd)).astype(np.float32)
    arrays = _cache_arrays(rng, nl, b, n_kv, s_max, hd)
    lens, val = np.asarray(lengths, np.int32), np.asarray(valid, np.int32)

    out_j, c_ref = jax_update(
        jnp.asarray(q).astype(jdt), jnp.asarray(kn).astype(jdt),
        jnp.asarray(vn).astype(jdt), *map(jnp.asarray, arrays),
        jnp.asarray(lens), jnp.int32(layer), valid=jnp.asarray(val),
        block_s=64, interpret=True)

    c = [torch.from_numpy(a.copy()) for a in arrays]
    kernels.reset_launch_counts()
    out_t, c_ret = decode_attention_update_stacked(
        torch.from_numpy(q).to(tdt), torch.from_numpy(kn).to(tdt),
        torch.from_numpy(vn).to(tdt), *c, torch.from_numpy(lens), layer,
        valid=torch.from_numpy(val))
    assert all(r is a for r, a in zip(c_ret, c))          # written in place
    assert kernels.launches["decode_attention_update_stacked_q8"] == 0
    for name, got, ref in zip(("k_q", "k_sc", "v_q", "v_sc"), c, c_ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=name)
    tol = 2e-5 if dtype == "float32" else 1e-2            # one bf16 ulp of |out| <~ 1
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_init_and_convert_quant_cache():
    from mxmoe_tpu.models import configs as jax_configs

    ref = jkv.init_quant_kv_cache(jax_configs.tiny_qwen2_moe(4, 2), 3, 16)
    got = tkv.init_quant_kv_cache(configs.tiny_qwen2_moe(4, 2), 3, 16, device="cpu")
    conv = kv_cache_from_jax(ref, "cpu")
    assert isinstance(conv, tkv.QuantKVCache) and got.max_len == ref.max_len == 16
    for name in ("k_q", "k_sc", "v_q", "v_sc", "lengths"):
        a, b = getattr(got, name), getattr(conv, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b)
    bf = kv_cache_from_jax(jkv.init_kv_cache(jax_configs.tiny_qwen2_moe(4, 2), 3, 16),
                           "cpu")
    assert isinstance(bf, tkv.KVCache) and bf.k.dtype == torch.bfloat16
    # MLA: one K / V per head, K at the 128-padded width, as the reference
    ds2 = jkv.init_quant_kv_cache(jax_configs.config_for("ds2"), 1, 16)
    got = tkv.init_quant_kv_cache(configs.config_for("ds2"), 1, 16, device="cpu")
    conv = kv_cache_from_jax(ds2, "cpu")
    assert got.k_q.shape == (27, 1, 16, 16, 256) and got.v_q.shape[-1] == 128
    for name in ("k_q", "k_sc", "v_q", "v_sc", "lengths"):
        a, b = getattr(got, name), getattr(conv, name)
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), name
