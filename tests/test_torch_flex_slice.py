"""Port parity for the rest of the scheme domain on the serving path:
weight-only (a16), grouped (g128) and asymmetric expert schemes, uniform and
as flex per-expert mixes with int8-stored codes, and the grouped / asymmetric
/ all-a16 shared expert. The JAX package (Pallas kernels in interpret mode)
against the port (the kernels' plain versions) on the same weights, at tiny
widths: 2 layers, 8 experts, top-2, H 256, expert N 384 (so the down
projection has K = 384, whose half is no multiple of the group size 128: the
small twin of K = 1408), shared N 256.

Tolerances. The flex quantizer's params are compared key by key, bitwise
(both packages run it op by op). Logits of the cached forward (|logits| ~ 1,
f32 params):

- weight-only schemes: atol 2e-3. No activation is quantized; XLA contracts
  the dequantization ``q * s + zp`` into an FMA and sums K in another order;
- w8a8 per-channel asymmetric: atol 2e-3, as the uniform symmetric slice;
- 4-bit activations (w4a4 grouped, the flex mixes): atol 2e-2. f32 sums in
  other orders can move an activation across a rounding boundary of its
  4-bit code (one step is 1/7 of the group's maximum). The grouped
  asymmetric zero-point term is added inside the port's kernel and outside
  the reference's; with f32 activations both add it in f32.

Within the port, int8-stored and nibble-packed w4a16 params give bitwise
equal logits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.models import configs as jax_configs
from mxmoe_tpu.models import model as jax_model
from mxmoe_tpu.models.layers import MoEImpl as JaxMoEImpl
from mxmoe_tpu.quant import schemes as jax_schemes
from mxmoe_tpu.quant.qparams import quantize_model_experts_mixed as jax_quantize_mixed
from mxmoe_tpu.quant.qparams import quantize_model_experts_uniform as jax_quantize_uniform
from mxmoe_tpu.serving import decode as jax_decode
from mxmoe_tpu.serving import kv_cache as jax_kv
from mxmoe_tpu_torch.models import configs
from mxmoe_tpu_torch.models.convert import pack_int4_experts
from mxmoe_tpu_torch.models.layers import MoEImpl
from mxmoe_tpu_torch.ops import kernels
from mxmoe_tpu_torch.params_from_jax import params_from_jax
from mxmoe_tpu_torch.quant import schemes
from mxmoe_tpu_torch.quant.qparams import quantize_model_experts_mixed
from mxmoe_tpu_torch.serving import decode, kv_cache

# name -> (routed pattern cycled over the experts, shared expert's scheme)
MIXES = {
    # grouped asymmetric w4a4 beside per-channel w8a8; shared expert grouped
    # asymmetric w x a (K8 with zp for the routed experts and with E = 1)
    "flex-shared-grouped": (("w4a4_g128_asym", "w8a8_g-1_sym"), "w8a8_g128_asym"),
    # an all-symmetric flex family (drops its zp); shared expert weight-only
    # in every layer (K6 with E = 1)
    "flex-shared-a16": (("w4a4_g128_sym", "w8a8_g-1_sym"), "w4a16_g128_asym"),
}
UNIFORM = {"w4a16_g128_asym": 2e-3, "w4a16_g-1_sym": 2e-3, "w8a8_g-1_asym": 2e-3,
           "w4a4_g128_sym": 2e-2, "w4a4_g128_asym": 2e-2}
MIX_ATOL = 2e-2


def _cfgs():
    kw = dict(hidden_size=256, num_heads=4, num_kv_heads=2, head_dim=128,
              moe_intermediate_size=384, shared_expert_intermediate_size=256)
    return (dataclasses.replace(jax_configs.tiny_qwen2_moe(8, 2), **kw),
            dataclasses.replace(configs.tiny_qwen2_moe(8, 2), **kw))


def _qmc(mod, cfg, pattern, shared):
    experts = {str(e): mod.build_uniform_expert(mod.parse_scheme(pattern[e % len(pattern)]))
               for e in range(cfg.num_experts)}
    experts[str(cfg.num_experts)] = mod.build_uniform_expert(mod.parse_scheme(shared))
    return mod.QModelConfig(layers={str(l): mod.QLayerConfig(experts=dict(experts))
                                    for l in range(cfg.num_layers)})


def _scheme(mod, name):
    """A uniform scheme; per-token activations stay symmetric (an "_asym"
    name means asymmetric weights: both packages refuse asymmetric per-token
    activations, and the grouped quantizer never reads ``a_sym``)."""
    c = mod.parse_scheme(name)
    if c.a_bits < 16 and c.w_gsize == -1:
        c = dataclasses.replace(c, a_sym=True)
    return c


def _to_torch(params_j):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), "cpu")


@pytest.fixture(scope="module")
def floats():
    cfg_j, cfg_t = _cfgs()
    float_j = jax_model.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    return cfg_j, cfg_t, float_j, _to_torch(float_j)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_quantize_model_experts_mixed_flex_bitwise(floats, mix):
    """The flex arm and the shared expert's storage, key by key."""
    cfg_j, cfg_t, float_j, float_t = floats
    pattern, shared = MIXES[mix]
    ref = jax_quantize_mixed(float_j, cfg_j, _qmc(jax_schemes, cfg_j, pattern, shared))
    got = quantize_model_experts_mixed(float_t, cfg_t,
                                       _qmc(schemes, cfg_t, pattern, shared))["layers"]
    ref = _to_torch(ref)["layers"]          # the converter carries every key across
    assert sorted(got) == sorted(ref)
    g_h, g_n = cfg_t.hidden_size // 128, cfg_t.moe_intermediate_size // 128
    assert got["expert_gate_up_sc"].shape[-2] == g_h
    assert got["expert_down_sc"].shape[-2] == g_n == 3
    assert got["act_gsize_gateup"].shape == (2, cfg_t.num_experts, g_h)
    assert got["act_gsize_down"][0, :2, 0].tolist() == [128.0, -1.0]
    assert ("expert_gate_up_zp" in got) == ("asym" in pattern[0])
    assert ("shared_wo" in got) == (mix == "flex-shared-a16")
    assert "shared_gate_up_zp" in got and got["shared_down_sc"].shape[-2] == 2
    for key in ref:
        assert got[key].dtype == ref[key].dtype and got[key].shape == ref[key].shape, key
        assert torch.equal(got[key], ref[key]), key


def _run_both(cfg_j, cfg_t, params_j, params_t, impl_j, impl_t, atol):
    """One 12-token prefill (valid 12 and 7) + two decode steps through both
    packages; asserts the logits agree and returns the port's."""
    rng = np.random.default_rng(1)
    b = 2
    steps = [(rng.integers(0, cfg_t.vocab_size, (b, 12)).astype(np.int32),
              np.asarray([12, 7], np.int32))] + [
        (rng.integers(0, cfg_t.vocab_size, (b, 1)).astype(np.int32),
         np.asarray([1, 1], np.int32)) for _ in range(2)]
    cj = jax_kv.init_kv_cache(cfg_j, b, 32)
    ct = kv_cache.init_kv_cache(cfg_t, b, 32, device="cpu")
    fwd_j = jax.jit(lambda p, t, c, v: jax_decode.forward_cached(
        p, t, c, cfg_j, impl_j, valid_lengths=v))
    out = []
    kernels.reset_launch_counts()
    for i, (tk, vl) in enumerate(steps):
        lj, cj = fwd_j(params_j, jnp.asarray(tk), cj, jnp.asarray(vl))
        lt, ct = decode.forward_cached(params_t, torch.from_numpy(tk), ct, cfg_t,
                                       impl_t, valid_lengths=torch.from_numpy(vl))
        lj = np.asarray(lj)
        for r in range(b):   # rows past a slot's valid length are padding
            np.testing.assert_allclose(lt.numpy()[r, :vl[r]], lj[r, :vl[r]],
                                       rtol=0, atol=atol, err_msg=f"step {i}")
        out.append(lt)
    assert all(n == 0 for n in kernels.launches.values()), kernels.launches
    return out, steps


@pytest.mark.parametrize("scheme", sorted(UNIFORM))
def test_forward_cached_uniform_scheme_vs_jax(floats, scheme):
    cfg_j, cfg_t, float_j, _ = floats
    params_j = jax_quantize_uniform(float_j, _scheme(jax_schemes, scheme))
    params_t = _to_torch(params_j)
    impl_j = JaxMoEImpl(kind="ragged", quant=_scheme(jax_schemes, scheme),
                        interpret=True, decode_attn="fused")
    impl_t = MoEImpl(quant=_scheme(schemes, scheme))
    out, steps = _run_both(cfg_j, cfg_t, params_j, params_t, impl_j, impl_t,
                           UNIFORM[scheme])
    if scheme.startswith("w4a16"):
        # served from nibble-packed codes (K7's path): bitwise the logits of
        # the int8-stored codes (K6's path)
        packed = pack_int4_experts(params_t, impl_t.quant)
        assert "expert_gate_up_q" not in packed["layers"]
        assert packed["layers"]["expert_down_q_packed"].shape[-2] == 192
        ct = kv_cache.init_kv_cache(cfg_t, 2, 32, device="cpu")
        for (tk, vl), want in zip(steps, out):
            lt, ct = decode.forward_cached(packed, torch.from_numpy(tk), ct, cfg_t,
                                           impl_t, valid_lengths=torch.from_numpy(vl))
            assert torch.equal(lt, want)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_forward_cached_flex_mix_vs_jax(floats, mix):
    cfg_j, cfg_t, float_j, _ = floats
    pattern, shared = MIXES[mix]
    params_j = jax_quantize_mixed(float_j, cfg_j, _qmc(jax_schemes, cfg_j, pattern, shared))
    impl_j = JaxMoEImpl(kind="ragged", quant="mixed", interpret=True,
                        decode_attn="fused")
    out, _ = _run_both(cfg_j, cfg_t, params_j, _to_torch(params_j), impl_j,
                       MoEImpl(quant="mixed"), MIX_ATOL)
    assert all(torch.isfinite(lt).all() for lt in out)


def test_flex_over_packed_storage_still_raises(floats):
    """Flex over the ragged packed buffer raised before it was ported (the
    name stays): it now quantizes key by key bitwise the reference's, and its
    logits are bitwise those of the int8-stored flex params."""
    cfg_j, cfg_t, float_j, float_t = floats
    pattern, shared = MIXES["flex-shared-grouped"]
    got = quantize_model_experts_mixed(float_t, cfg_t,
                                       _qmc(schemes, cfg_t, pattern, shared),
                                       pack_w4=True)
    ref = _to_torch(jax_quantize_mixed(float_j, cfg_j,
                                       _qmc(jax_schemes, cfg_j, pattern, shared),
                                       pack_w4=True))["layers"]
    assert sorted(got["layers"]) == sorted(ref)
    assert "expert_down_qcat" in ref and "expert_down_zp" in ref
    for key in ref:
        assert torch.equal(got["layers"][key], ref[key]), key
    stored = quantize_model_experts_mixed(float_t, cfg_t,
                                          _qmc(schemes, cfg_t, pattern, shared))
    toks = torch.arange(20, dtype=torch.int32).reshape(2, 10)
    outs = []
    for params in (got, stored):
        ct = kv_cache.init_kv_cache(cfg_t, 2, 16, device="cpu")
        lg, ct = decode.forward_cached(params, toks, ct, cfg_t, MoEImpl(quant="mixed"))
        lg2, _ = decode.forward_cached(params, lg[:, -1:].argmax(-1).to(torch.int32),
                                       ct, cfg_t, MoEImpl(quant="mixed"))
        outs.append(torch.cat([lg, lg2], dim=1))
    assert torch.equal(outs[0], outs[1])
