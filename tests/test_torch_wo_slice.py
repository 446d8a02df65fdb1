"""Port parity for the remaining two-launch branches of the expert FFN on the
serving path, the slice as a whole: a mixed layer with weight-only (a16)
experts served through ``gmm_mixed_wo_wxa`` (per channel and flex), a flex
family over the ragged packed buffer (``gmm_mixed_packed``, flex form), the
float experts through ``ops.gmm`` (both backends) and the int8 lm_head. The
JAX package's ``forward_cached`` (Pallas kernels in interpret mode) against
the port's (the kernels' plain versions) on the same weights, at tiny widths:
2 layers, 8 experts, top-2, H 256, expert N 384 (so the down projection has
K = 384, whose half is no multiple of the group size 128: the small twin of
K = 1408), shared N 256.

Tolerances. The mixed quantizer's params are compared key by key, bitwise.
Logits of the cached forward (|logits| ~ 1, f32 params):

- wo mixes (w4a16 beside w8a8) and the int8 head: atol 2e-3. The only
  quantized activations have 8 bits; XLA contracts the dequantization and the
  epilogues into FMAs and sums K in another order. The head's per-token scale
  is a true division in the port and a multiply by the reciprocal in the
  compiled reference (one ulp apart on some rows);
- flex-packed (4-bit activations): atol 2e-2, as every a4 mix: f32 sums in
  other orders can move an activation across a rounding boundary of its
  4-bit code (one step is 1/7 of the group's maximum);
- float experts: atol 1e-4 (f32 sums in other orders, nothing quantized).

The JAX package's ``gmm_backend="pallas"`` arm compiles for the TPU only (its
front end passes no interpret flag), so the reference of both float arms is
its stock ``ragged_dot`` arm; the Pallas kernel itself is compared in
test_torch_gmm_bf16.py.
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
from mxmoe_tpu.quant.qparams import quantize_lm_head as jax_quantize_lm_head
from mxmoe_tpu.quant.qparams import quantize_model_experts_mixed as jax_quantize_mixed
from mxmoe_tpu.quant.qparams import quantize_model_experts_uniform as jax_quantize_uniform
from mxmoe_tpu.serving import decode as jax_decode
from mxmoe_tpu.serving import kv_cache as jax_kv
from mxmoe_tpu_torch.models import configs
from mxmoe_tpu_torch.models.layers import MoEImpl
from mxmoe_tpu_torch.ops import kernels
from mxmoe_tpu_torch.params_from_jax import params_from_jax
from mxmoe_tpu_torch.quant import schemes
from mxmoe_tpu_torch.quant.qparams import (quantize_lm_head,
                                           quantize_model_experts_mixed)
from mxmoe_tpu_torch.serving import decode, kv_cache
from mxmoe_tpu_torch.serving.engine import Engine, EngineConfig

# name -> (routed pattern cycled over the experts, shared expert's scheme,
#          pack_w4, mixed_weight_only, logits atol)
MIXES = {
    # the reference's fused-kernel instance: w4a16 g128 beside w8a8 (K10 flex)
    "flex-wo": (("w4a16_g128_asym", "w8a8_g-1_sym"), "w8a8_g-1_sym", False, True, 2e-3),
    # per-channel weight-only beside w8a8 (K10's other body)
    "wo": (("w4a16_g-1_sym", "w8a8_g-1_sym"), "w8a8_g-1_sym", False, True, 2e-3),
    # grouped asymmetric w4a4 nibble-packed beside w8a8 (K4f, with zp)
    "flex-packed": (("w4a4_g128_asym", "w8a8_g-1_sym"), "w8a8_g-1_sym", True, False, 2e-2),
}


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


def _to_torch(params_j):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), "cpu")


@pytest.fixture(scope="module")
def floats():
    cfg_j, cfg_t = _cfgs()
    float_j = jax_model.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    return cfg_j, cfg_t, float_j, _to_torch(float_j)


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
    assert all(torch.isfinite(lt).all() for lt in out)
    return out


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_quantize_model_experts_mixed_bitwise(floats, mix):
    cfg_j, cfg_t, float_j, float_t = floats
    pattern, shared, pack, _, _ = MIXES[mix]
    ref = _to_torch(jax_quantize_mixed(float_j, cfg_j, _qmc(jax_schemes, cfg_j, pattern, shared),
                                       pack_w4=pack))["layers"]
    got = quantize_model_experts_mixed(float_t, cfg_t, _qmc(schemes, cfg_t, pattern, shared),
                                       pack_w4=pack)["layers"]
    assert sorted(got) == sorted(ref)
    assert ("expert_gate_up_qcat" in got) == pack
    assert ("act_gsize_down" in got) == mix.startswith("flex")
    if not pack:
        assert got["act_bits_gateup"][0, :2].tolist() == [16.0, 8.0]
    for key in ref:
        assert got[key].dtype == ref[key].dtype and got[key].shape == ref[key].shape, key
        assert torch.equal(got[key], ref[key]), key


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_forward_cached_mix_vs_jax(floats, mix):
    cfg_j, cfg_t, float_j, _ = floats
    pattern, shared, pack, wo, atol = MIXES[mix]
    params_j = jax_quantize_mixed(float_j, cfg_j, _qmc(jax_schemes, cfg_j, pattern, shared),
                                  pack_w4=pack)
    impl_j = JaxMoEImpl(kind="ragged", quant="mixed", interpret=True,
                        decode_attn="fused", mixed_weight_only=wo)
    impl_t = MoEImpl(quant="mixed", mixed_weight_only=wo)
    params_t = _to_torch(params_j)
    out = _run_both(cfg_j, cfg_t, params_j, params_t, impl_j, impl_t, atol)
    if wo:
        # without the flag the a16 rows are quantized to 8 bits: another result
        ct = kv_cache.init_kv_cache(cfg_t, 2, 32, device="cpu")
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg_t.vocab_size, (2, 12)).astype(np.int32))
        lt, _ = decode.forward_cached(params_t, toks, ct, cfg_t, MoEImpl(quant="mixed"),
                                      valid_lengths=torch.tensor([12, 7], dtype=torch.int32))
        assert not torch.equal(lt[0], out[0][0])


@pytest.mark.parametrize("backend", ["ragged_dot", "pallas"])
def test_forward_cached_float_experts_vs_jax(floats, backend):
    cfg_j, cfg_t, float_j, float_t = floats
    impl_j = JaxMoEImpl(kind="ragged", interpret=True, decode_attn="fused")
    _run_both(cfg_j, cfg_t, float_j, float_t, impl_j, MoEImpl(gmm_backend=backend), 1e-4)


def test_forward_cached_int8_head_vs_jax(floats):
    cfg_j, cfg_t, float_j, _ = floats
    qc_j, qc_t = (m.parse_scheme("w8a8_g-1_sym") for m in (jax_schemes, schemes))
    params_j = jax_quantize_lm_head(jax_quantize_uniform(float_j, qc_j))
    params_t = _to_torch(params_j)
    assert params_t["lm_head_q"].dtype == torch.int8 and "lm_head" not in params_t
    impl_j = JaxMoEImpl(kind="ragged", quant=qc_j, interpret=True, decode_attn="fused")
    _run_both(cfg_j, cfg_t, params_j, params_t, impl_j, MoEImpl(quant=qc_t), 2e-3)


def test_quantize_lm_head_bitwise(floats):
    _, _, float_j, float_t = floats
    ref = _to_torch(jax_quantize_lm_head(float_j))
    got = quantize_lm_head(float_t)
    assert sorted(got) == sorted(ref)
    assert torch.equal(got["lm_head_q"], ref["lm_head_q"])
    assert torch.equal(got["lm_head_sc"], ref["lm_head_sc"])


def test_engine_serves_float_and_wo_models(floats):
    """The Engine with ``quant=None`` and with ``mixed_weight_only`` passed by
    the caller: requests come back whole, no kernel launches on the CPU."""
    _, cfg_t, _, float_t = floats
    pattern, shared, _, _, _ = MIXES["flex-wo"]
    wo = quantize_model_experts_mixed(float_t, cfg_t, _qmc(schemes, cfg_t, pattern, shared))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg_t.vocab_size, n).tolist() for n in (11, 5)]
    kernels.reset_launch_counts()
    for params, impl in ((float_t, MoEImpl()),
                         (float_t, MoEImpl(gmm_backend="pallas")),
                         (wo, MoEImpl(quant="mixed", mixed_weight_only=True))):
        eng = Engine(params, cfg_t, EngineConfig(batch_slots=2, max_len=32,
                                                 prefill_chunk=8), impl)
        rids = [eng.submit(p, max_new_tokens=4) for p in prompts]
        out = eng.run_to_completion(chunk=2)
        assert all(len(out[r]) == 4 for r in rids)
    assert all(n == 0 for n in kernels.launches.values())


def test_head_act_quant_is_the_op_by_op_reference_and_an_ulp_from_the_compiled():
    """The int8 head quantizes the hidden states through K1's function, a
    true division by 127: bitwise the reference's ``quantize_act_per_token``
    run op by op; compiled, XLA turns the division by a constant into a
    multiply by the f32 reciprocal, which moves some rows' scales by one ulp
    (the codes divide by the scale and stay equal here)."""
    from mxmoe_tpu.quant.qparams import quantize_act_per_token
    from mxmoe_tpu_torch.ops.act_quant import quantize_rows_uniform

    x = np.random.default_rng(0).standard_normal((64, 256)).astype(np.float32)
    qt, st = quantize_rows_uniform(torch.from_numpy(x), 8)
    qe, se = quantize_act_per_token(jnp.asarray(x), 8)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qe))
    np.testing.assert_array_equal(st.numpy(), np.asarray(se))
    qj, sj = jax.jit(lambda a: quantize_act_per_token(a, 8))(jnp.asarray(x))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=2.0 ** -23, atol=0)
    assert (np.abs(qt.numpy().astype(np.int32) - np.asarray(qj).astype(np.int32)) <= 1).all()
