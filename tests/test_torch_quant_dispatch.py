"""Port parity: weight quantization, routing and dispatch of mxmoe_tpu_torch
against mxmoe_tpu, plus the framework-free config copies.

Tolerances: codes, scales (asym zero points: 1e-7 abs, see below), routing ids, sort order, group sizes and the
padded dispatch layout are bitwise/exactly equal. Routing weights and the
f32 combine are compared differently: routing weights agree to rtol 3e-7
(XLA's and torch's exp differ by an ulp), and the combine, given the same
weights, is bitwise (the same serial per-token accumulation order on the
CPU).

Top-k tie rule: jax.lax.top_k and torch.topk may order EQUAL probabilities
differently, so the logits here are tie-free (continuous random draws);
the port promises equal routing on tie-free logits only."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.models import configs as jax_configs
from mxmoe_tpu.ops import dispatch as jd
from mxmoe_tpu.models import model as jax_model
from mxmoe_tpu.quant import schemes as jax_schemes
from mxmoe_tpu.quant.qparams import quantize_model_experts_mixed as jax_quantize_mixed
from mxmoe_tpu.quant.qparams import quantize_model_experts_uniform as jax_quantize_uniform
from mxmoe_tpu.quant.schemes import parse_scheme as jax_parse_scheme
from mxmoe_tpu_torch.models import configs
from mxmoe_tpu_torch.ops import dispatch as td
from mxmoe_tpu_torch.params_from_jax import params_from_jax
from mxmoe_tpu_torch.quant.packing import dequantize_weight_kn, quantize_weight_kn
from mxmoe_tpu_torch.quant import schemes
from mxmoe_tpu_torch.quant.qparams import (quantize_model_experts_mixed,
                                           quantize_model_experts_uniform)
from mxmoe_tpu_torch.quant.schemes import parse_scheme


@pytest.mark.parametrize("scheme", ["w8a8_g-1_sym", "w4a4_g-1_sym",
                                    "w4a16_g8_asym"])
def test_quantize_model_experts_uniform_bitwise(scheme):
    rng = np.random.default_rng(3)
    layers = {
        "expert_gate_up": rng.standard_normal((2, 4, 64, 48)).astype(np.float32) * 0.1,
        "expert_down": rng.standard_normal((2, 4, 24, 64)).astype(np.float32) * 0.1,
    }
    layers["expert_down"][1, 2, :, 5] = 0.0        # an all-zero column
    ref = jax_quantize_uniform({"layers": {k: jnp.asarray(v) for k, v in layers.items()}},
                               jax_parse_scheme(scheme))["layers"]
    got = quantize_model_experts_uniform(
        {"layers": params_from_jax(layers, "cpu")}, parse_scheme(scheme))["layers"]
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].dtype == params_from_jax(np.asarray(ref[key]), "cpu").dtype, key
        if key.endswith("_zp") and "asym" in scheme:
            # re-centred asym zero points zp + 2^(b-1)*scale: XLA contracts
            # the multiply-add into one FMA, torch rounds twice (<= 1e-7 abs)
            np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                       rtol=0, atol=1e-7, err_msg=key)
            continue
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)


def _mixed_qmc(mod, num_experts, layer_patterns, shared=("w8a8_g-1_sym",)):
    """Per-layer lists of per-expert scheme names (cycled) -> QModelConfig."""
    layers = {}
    for l, pattern in enumerate(layer_patterns):
        experts = {str(e): mod.build_uniform_expert(
            mod.parse_scheme(pattern[e % len(pattern)])) for e in range(num_experts)}
        if shared:
            experts[str(num_experts)] = mod.build_uniform_expert(
                mod.parse_scheme(shared[l % len(shared)]))
        layers[str(l)] = mod.QLayerConfig(experts=experts)
    return mod.QModelConfig(layers=layers)


def _float_model(num_experts=4, num_layers=2):
    import jax

    cfg_j = jax_configs.tiny_qwen2_moe(num_experts, num_layers)
    params_j = jax_model.init_params(cfg_j, jax.random.PRNGKey(4), dtype=jnp.float32)
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), "cpu")
    return cfg_j, configs.tiny_qwen2_moe(num_experts, num_layers), params_j, params_t


@pytest.mark.parametrize("pack_w4", [False, True], ids=["int8-stored", "packed"])
@pytest.mark.parametrize("shared", [("w8a8_g-1_sym",), ("w4a8_g-1_sym", "w8a4_g-1_sym"), ()],
                         ids=["shared-w8a8", "shared-mixed", "no-shared"])
def test_quantize_model_experts_mixed_bitwise(pack_w4, shared):
    """Codes, scales, ragged buffer + blk/pf, act bits and the real-quantized
    shared expert, in both storages. The layers' packed counts differ, so
    the ragged stack pads the shorter layer."""
    patterns = [("w4a4_g-1_sym", "w8a8_g-1_sym"),
                ("w4a8_g-1_sym", "w2a8_g-1_sym", "w3a4_g-1_sym", "w8a8_g-1_sym")]
    cfg_j, cfg_t, params_j, params_t = _float_model()
    ref = jax_quantize_mixed(params_j, cfg_j, _mixed_qmc(jax_schemes, 4, patterns, shared),
                             pack_w4=pack_w4)["layers"]
    got = quantize_model_experts_mixed(params_t, cfg_t,
                                       _mixed_qmc(schemes, 4, patterns, shared),
                                       pack_w4=pack_w4)["layers"]
    assert sorted(got) == sorted(ref)
    assert ("expert_gate_up_qcat" in got) == pack_w4
    assert ("shared_gate_up_q" in got) == bool(shared)
    for key in ref:
        r = np.asarray(ref[key])
        assert got[key].dtype == params_from_jax(r, "cpu").dtype, key
        np.testing.assert_array_equal(got[key].float().numpy(),
                                      r.astype(np.float32), err_msg=key)


@pytest.mark.parametrize("pattern,pack_w4,match", [
    # a flex family (grouped, or asymmetric weights) over packed storage
    (("w4a4_g-1_sym", "w4a4_g32_sym"), True, None),
    (("w8a8_g-1_sym", "w4a8_g-1_asym"), True, None),
    # a weight-only expert in a mixed layer
    (("w8a8_g-1_sym", "w4a16_g-1_sym"), False, None),
    # ... which refuses pack_w4, as in the reference; so do 12-bit activations
    (("w8a8_g-1_sym", "w4a16_g-1_sym"), True, "pack_w4 requires pure w x a"),
    (("w8a8_g-1_sym", "w4a12_g-1_sym"), False, "supports int w<=8"),
])
def test_quantize_model_experts_mixed_unported_domains_raise(pattern, pack_w4, match):
    """The domains that raised before they were ported (the name stays) now
    quantize, key by key bitwise the reference's; what the reference refuses
    still raises."""
    cfg_j, cfg_t, params_j, params_t = _float_model()
    qmc = _mixed_qmc(schemes, 4, [pattern, pattern], shared=())
    if match is not None:
        with pytest.raises(ValueError, match=match):
            quantize_model_experts_mixed(params_t, cfg_t, qmc, pack_w4=pack_w4)
        with pytest.raises(AssertionError):
            jax_quantize_mixed(params_j, cfg_j,
                               _mixed_qmc(jax_schemes, 4, [pattern, pattern], shared=()),
                               pack_w4=pack_w4)
        return
    got = quantize_model_experts_mixed(params_t, cfg_t, qmc, pack_w4=pack_w4)["layers"]
    ref = jax_quantize_mixed(params_j, cfg_j,
                             _mixed_qmc(jax_schemes, 4, [pattern, pattern], shared=()),
                             pack_w4=pack_w4)["layers"]
    assert sorted(got) == sorted(ref)
    assert ("expert_gate_up_qcat" in got) == pack_w4
    assert ("expert_gate_up_zp" in got) == (not pack_w4 or "asym" in pattern[1])
    if "a16" in pattern[1]:
        assert got["act_bits_gateup"][0].tolist() == [8.0, 16.0, 8.0, 16.0]
    for key in ref:
        r = np.asarray(ref[key])
        assert got[key].dtype == params_from_jax(r, "cpu").dtype, key
        np.testing.assert_array_equal(got[key].float().numpy(),
                                      r.astype(np.float32), err_msg=key)
    if pack_w4:
        # int8-stored, the same flex family quantizes
        got = quantize_model_experts_mixed(params_t, cfg_t, qmc)["layers"]
        assert "act_gsize_gateup" in got and "act_gsize_down" in got


def test_quantize_model_experts_mixed_heterogeneous_shared_raises():
    """A shared expert that is a16 in one layer and a8 in the other takes the
    reference's fake-quant fallback (it raised before the fallback was
    ported; the name stays): fake-quantized float weights and act_bits_shared,
    bitwise the reference's."""
    cfg_j, cfg_t, params_j, params_t = _float_model()
    shared = ("w8a8_g-1_sym", "w4a16_g-1_sym")
    ref = jax_quantize_mixed(params_j, cfg_j, _mixed_qmc(jax_schemes, 4,
                             [("w8a8_g-1_sym",)] * 2, shared))["layers"]
    got = quantize_model_experts_mixed(params_t, cfg_t, _mixed_qmc(
        schemes, 4, [("w8a8_g-1_sym",)] * 2, shared))["layers"]
    assert sorted(got) == sorted(ref)
    assert "shared_gate_up_q" not in got and got["shared_gate_up"].dtype == torch.float32
    for key in ("shared_gate_up", "shared_down", "act_bits_shared"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)


def test_weight_roundtrip_error_bounded():
    w = torch.randn(3, 64, 40)
    p = quantize_weight_kn(w, parse_scheme("w8a8_g-1_sym"))
    err = (dequantize_weight_kn(p) - w).abs()
    assert bool((err <= p.scale / 2 + 1e-7).all())


@pytest.mark.parametrize("norm,align", [(False, None), (True, None),
                                        (False, 4), (True, 8)])
def test_route_and_dispatch_equal(norm, align):
    rng = np.random.default_rng(5)
    t, e, k = 19, 8, 2
    logits = rng.standard_normal((t, e)).astype(np.float32)   # tie-free
    rj = jd.route_topk(jnp.asarray(logits), k, norm)
    rt = td.route_topk(torch.from_numpy(logits), k, norm)
    np.testing.assert_array_equal(rt.expert_ids.numpy(), np.asarray(rj.expert_ids))
    np.testing.assert_allclose(rt.weights.numpy(), np.asarray(rj.weights),
                               rtol=3e-7, atol=0)

    dj = jd.make_dispatch(rj, e, align=align)
    dt = td.make_dispatch(rt, e, align=align)
    for field in ("sort_idx", "group_sizes", "token_ids"):
        np.testing.assert_array_equal(getattr(dt, field).numpy(),
                                      np.asarray(getattr(dj, field)), err_msg=field)
    np.testing.assert_allclose(dt.combine_weights.numpy(),
                               np.asarray(dj.combine_weights), rtol=3e-7, atol=0)
    dt = dt._replace(combine_weights=torch.from_numpy(np.array(dj.combine_weights)))

    x = rng.standard_normal((t, 16)).astype(np.float32)
    xs_j = jd.gather_tokens(jnp.asarray(x), dj)
    xs_t = td.gather_tokens(torch.from_numpy(x), dt)
    np.testing.assert_array_equal(xs_t.numpy(), np.asarray(xs_j))
    # expert outputs with garbage (NaN) in padding rows: masked, not multiplied
    out = rng.standard_normal(xs_t.shape).astype(np.float32)
    out[dt.combine_weights.numpy() == 0] = np.nan
    cj = jd.combine_tokens(jnp.asarray(out), dj, t)
    ct = td.combine_tokens(torch.from_numpy(out), dt, t)
    assert np.isfinite(ct.numpy()).all()
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def test_configs_and_schemes_match_reference():
    for name in ("qwen2_moe", "qwen2_moe_57b", "mixtral", "ds2"):
        assert (dataclasses.asdict(configs.config_for(name))
                == dataclasses.asdict(jax_configs.config_for(name)))
    assert (dataclasses.asdict(configs.tiny_qwen2_moe(6, 3))
            == dataclasses.asdict(jax_configs.tiny_qwen2_moe(6, 3)))
    for s in ("w8a8_g-1_sym", "w4a4_g128_asym", "w4a16_g-1_sym_mse", "w2.5a16_g64_sym"):
        ref = jax_parse_scheme(s)
        got = parse_scheme(s)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert got.scheme_name == ref.scheme_name
