"""Port parity for the fake-quant evaluation path
(``mxmoe_tpu_torch.quant.quantizer.quantize_model_fake`` by rtn, gptq and
rtn-had, and the forward branches it feeds: the fake-quantized activations
of ``moe_ffn_ragged`` per token and per k-group (``act_bits_*`` /
``act_gsize_*``), the dense layer's ``act_bits_dense`` and
``MoEImpl.online_had``) against the JAX package on the CPU, for tiny
qwen2_moe (4 experts, 2 layers) and tiny ds2 (with a ``dense-0`` scheme).

The mix: per layer, the routed experts take w8a8 per channel, w4a4 at g16
(grouped activations), w4a16 g16 asymmetric (weight-only) and float; the
shared expert w8a8; so both families are flex.

Bounds: RTN's params within 1e-6 (max |d| over the tensor's max |x|: the
same float32 ops); GPTQ's fake weights equal (1e-6) on >= 99.9 % of the
elements, the code agreement of ``test_torch_gptq.py``; the logits within
the fake-quant parity bound, atol 2e-2 at |logits| ~ 1e-1 (an f32 sum in
another order can move an activation across a rounding boundary of its
4-bit code, one step being 1/7 of its row's maximum)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.models import configs as jax_configs
from mxmoe_tpu.models import model as jax_model
from mxmoe_tpu.models.layers import MoEImpl as JaxMoEImpl
from mxmoe_tpu.quant import quantizer as jax_quantizer
from mxmoe_tpu.quant import schemes as jax_schemes
from mxmoe_tpu.quant.hadamard import random_hadamard_matrix as jax_rhm
from mxmoe_tpu_torch.models import configs, model
from mxmoe_tpu_torch.models.layers import MoEImpl
from mxmoe_tpu_torch.params_from_jax import params_from_jax
from mxmoe_tpu_torch.quant import quantizer, schemes

LOGIT_ATOL = 2e-2
PARAM_REL = 1e-6
ROUTED = ("w8a8_g-1_sym", "w4a4_g16_sym", "w4a16_g16_asym", "w16a16_g-1_sym")


def _mix(mod, num_layers, e, dense=()):
    layers = {}
    for l in range(num_layers):
        ex = {str(i): mod.build_uniform_expert(mod.parse_scheme(ROUTED[(i + l) % 4]))
              for i in range(e)}
        ex[str(e)] = mod.build_uniform_expert(mod.parse_scheme("w8a8_g-1_sym"))
        layers[str(l)] = mod.QLayerConfig(experts=ex)
    for d in dense:
        layers[f"dense-{d}"] = mod.QLayerConfig(experts={"0": mod.build_uniform_expert(
            mod.parse_scheme("w4a8_g-1_sym"))})
    return mod.QModelConfig(layers=layers)


def _setup(name, seed):
    cfg_j = getattr(jax_configs, name)(num_experts=4)
    cfg_t = getattr(configs, name)(num_experts=4)
    pj = jax_model.init_params(cfg_j, jax.random.PRNGKey(seed), dtype=jnp.float32)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    dense = (0,) if cfg_t.first_dense_layers else ()
    nl = cfg_t.num_moe_layers
    toks = np.random.default_rng(seed).integers(0, cfg_t.vocab_size, (4, 64)).astype(np.int32)
    return (cfg_j, cfg_t, pj, pt, _mix(jax_schemes, nl, 4, dense),
            _mix(schemes, nl, 4, dense), toks)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _compare_params(got, ref, gptq=False):
    g, r = _flat(got), _flat(jax.tree_util.tree_map(np.asarray, ref))
    assert sorted(g) == sorted(r)
    for k in r:
        gn, rn = g[k].numpy(), r[k]
        assert gn.shape == rn.shape, k
        tol = PARAM_REL * max(float(np.abs(rn).max()), 1e-30)
        if gptq and k.split(".")[-1] in ("expert_gate_up", "expert_down", "shared_gate_up",
                                         "shared_down", "mlp_gate_up", "mlp_down"):
            assert (np.abs(gn - rn) <= tol).mean() >= 0.999, k
        else:
            np.testing.assert_allclose(gn, rn, rtol=0, atol=tol, err_msg=k)


def _logits(cfg_j, cfg_t, qj, qt, toks, **impl):
    want = np.asarray(jax_model.forward_logits(qj, jnp.asarray(toks), cfg_j,
                                               JaxMoEImpl(**impl)))
    got = model.forward_logits(qt, torch.from_numpy(toks), cfg_t, MoEImpl(**impl)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    return got


@pytest.fixture(scope="module")
def qwen():
    return _setup("tiny_qwen2_moe", 0)


def test_rtn_params_and_forward_match_jax(qwen):
    cfg_j, cfg_t, pj, pt, mj, mt, toks = qwen
    qj = jax_quantizer.quantize_model_fake(pj, cfg_j, mj, "rtn")
    qt = quantizer.quantize_model_fake(pt, cfg_t, mt, "rtn", device="cpu")
    _compare_params(qt, qj)
    lp = qt["layers"]
    assert {"act_bits_gateup", "act_bits_down", "act_bits_shared", "act_gsize_gateup",
            "act_gsize_down"} <= set(lp)
    np.testing.assert_array_equal(lp["act_bits_gateup"][0].numpy(), [8, 4, 16, 16])
    fq = _logits(cfg_j, cfg_t, qj, qt, toks)
    # the fake quantization moves the logits
    flt = model.forward_logits(pt, torch.from_numpy(toks), cfg_t).numpy()
    assert np.abs(fq - flt).max() > 1e-4
    # the online Hadamard of the down projection's input, on the same params
    _logits(cfg_j, cfg_t, qj, qt, toks, online_had=True)


def test_gptq_params_match_jax(qwen):
    cfg_j, cfg_t, pj, pt, mj, mt, toks = qwen
    qj = jax_quantizer.quantize_model_fake(pj, cfg_j, mj, "gptq",
                                           calib_tokens=jnp.asarray(toks))
    qt = quantizer.quantize_model_fake(pt, cfg_t, mt, "gptq",
                                       calib_tokens=torch.from_numpy(toks), device="cpu")
    _compare_params(qt, qj, gptq=True)


def test_rtn_had_matches_jax(qwen):
    cfg_j, cfg_t, pj, pt, mj, mt, toks = qwen
    key = jax.random.PRNGKey(5)
    qj = jax_quantizer.quantize_model_fake(pj, cfg_j, mj, "rtn-had", rotation_key=key)
    q = torch.from_numpy(np.array(jax_rhm(cfg_t.hidden_size, key)))
    qt = quantizer.quantize_model_fake(pt, cfg_t, mt, "rtn-had", rotation=q, device="cpu")
    _compare_params(qt, qj)
    _logits(cfg_j, cfg_t, qj, qt, toks)


def test_ds2_dense_act_bits_match_jax():
    cfg_j, cfg_t, pj, pt, mj, mt, toks = _setup("tiny_ds2", 2)
    qj = jax_quantizer.quantize_model_fake(pj, cfg_j, mj, "rtn")
    qt = quantizer.quantize_model_fake(pt, cfg_t, mt, "rtn", device="cpu")
    _compare_params(qt, qj)
    np.testing.assert_array_equal(qt["dense_layers"]["act_bits_dense"].numpy(), [[8, 8]])
    _logits(cfg_j, cfg_t, qj, qt, toks)


def test_quantize_model_fake_refuses_unknown_methods(qwen):
    _, cfg_t, _, pt, _, mt, _ = qwen
    with pytest.raises(ValueError):
        quantizer.quantize_model_fake(pt, cfg_t, mt, "awq", device="cpu")
    with pytest.raises(ValueError):
        quantizer.quantize_model_fake(pt, cfg_t, mt, "gptq", device="cpu")
