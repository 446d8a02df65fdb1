"""Port parity for the full forward (``mxmoe_tpu_torch.models.model``:
``forward_hidden`` / ``forward_logits`` / ``make_forward_fn``, and the
attention, MLA, dense-layer and decoder-layer blocks of
``models.layers``) against the JAX package's ``forward_logits``, for
``tiny_qwen2_moe``, ``tiny_mixtral`` and ``tiny_ds2``, from one numpy-seeded
JAX init carried over by ``params_from_jax``.

Tolerances: float32 weights, ``kind`` dense and ragged: logits within
rtol = atol = 1e-4 (|logits| ~ 1e-1; f32 matmuls and softmax sums in other
orders). Mixed-packed real-quantized experts (the JAX kernels in interpret
mode): atol 2e-2, as the mixed serving slice: an f32 sum in another order can
move an activation across a rounding boundary of its 4-bit code (one step
is 1/7 of the row's maximum)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.models import configs as jax_configs
from mxmoe_tpu.models import model as jax_model
from mxmoe_tpu.models.layers import MoEImpl as JaxMoEImpl
from mxmoe_tpu.quant import qparams as jax_qparams
from mxmoe_tpu.quant import schemes as jax_schemes
from mxmoe_tpu_torch.models import configs, layers, model
from mxmoe_tpu_torch.models.layers import MoEImpl
from mxmoe_tpu_torch.ops import kernels
from mxmoe_tpu_torch.params_from_jax import params_from_jax

FAMILIES = ("tiny_qwen2_moe", "tiny_mixtral", "tiny_ds2")
FULL = ("QWEN2_MOE_A2_7B", "MIXTRAL_8X7B", "QWEN2_MOE_57B", "DEEPSEEK_V2_LITE")


def _cfgs(name):
    return getattr(jax_configs, name)(), getattr(configs, name)()


@pytest.mark.parametrize("name", ["tiny_mixtral", "tiny_ds2"])
def test_tiny_configs_equal_the_reference(name):
    cfg_j, cfg_t = _cfgs(name)
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    assert (dataclasses.asdict(getattr(configs, name)(6, 5))
            == dataclasses.asdict(getattr(jax_configs, name)(6, 5)))


@pytest.mark.parametrize("name", FULL + FAMILIES)
def test_param_shapes_equal_the_reference(name):
    cfg = getattr(jax_configs, name)
    cfg = cfg() if callable(cfg) else cfg
    assert model.layer_param_shapes(cfg) == jax_model.layer_param_shapes(cfg)
    assert model.dense_layer_param_shapes(cfg) == \
        jax_model.dense_layer_param_shapes(cfg)


def _params(name, seed=0):
    cfg_j, cfg_t = _cfgs(name)
    params_j = jax_model.init_params(cfg_j, jax.random.PRNGKey(seed),
                                     dtype=jnp.float32)
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), "cpu")
    return cfg_j, cfg_t, params_j, params_t


def test_params_from_jax_carries_dense_layers_and_mla_keys():
    cfg_j, cfg_t, params_j, params_t = _params("tiny_ds2")
    assert set(params_t) == {"embed", "layers", "dense_layers", "final_norm",
                             "lm_head"}
    for group in ("layers", "dense_layers"):
        assert set(params_t[group]) == set(params_j[group])
        for k, v in params_j[group].items():
            np.testing.assert_array_equal(params_t[group][k].numpy(), np.asarray(v))
    assert {"kv_a", "kv_a_norm", "kv_b", "mlp_gate_up", "mlp_down"} <= (
        set(params_t["layers"]) | set(params_t["dense_layers"]))
    # bf16 leaves keep their bits
    bf = params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.bfloat16)), params_j["dense_layers"]), "cpu")
    for k, v in params_j["dense_layers"].items():
        assert bf[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            bf[k].float().numpy(), np.asarray(v.astype(jnp.bfloat16).astype(jnp.float32)))


def _tokens(cfg, seed=1, b=2, s=11):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("kind", ["dense", "ragged"])
def test_forward_logits_float_vs_jax(name, kind):
    cfg_j, cfg_t, params_j, params_t = _params(name)
    toks = _tokens(cfg_t)
    want = jax_model.forward_logits(params_j, jnp.asarray(toks), cfg_j,
                                    JaxMoEImpl(kind=kind))
    kernels.reset_launch_counts()
    got = model.forward_logits(params_t, torch.from_numpy(toks), cfg_t,
                               MoEImpl(kind=kind))
    assert all(n == 0 for n in kernels.launches.values())
    assert got.shape == (2, 11, cfg_t.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["tiny_qwen2_moe", "tiny_mixtral"])
def test_flash_backend_on_the_cpu_is_the_einsum(name):
    """``attn_backend="flash"`` takes the library kernel only on an
    accelerator: on the CPU both packages run the einsum softmax."""
    cfg_j, cfg_t, params_j, params_t = _params(name, seed=2)
    toks = _tokens(cfg_t, seed=2)
    want = jax_model.forward_logits(params_j, jnp.asarray(toks), cfg_j,
                                    JaxMoEImpl(attn_backend="flash"))
    got = model.forward_logits(params_t, torch.from_numpy(toks), cfg_t,
                               MoEImpl(attn_backend="flash"))
    xla = model.forward_logits(params_t, torch.from_numpy(toks), cfg_t, MoEImpl())
    assert torch.equal(got, xla)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def _alternating(cfg, mod):
    s4, s8 = (mod.parse_scheme(s) for s in ("w4a4_g-1_sym", "w8a8_g-1_sym"))
    experts = {str(e): mod.QExpertConfig(*([(s4, s8)[e % 2]] * 3))
               for e in range(cfg.num_experts)}
    if cfg.shared_expert_intermediate_size:
        experts[str(cfg.num_experts)] = mod.QExpertConfig(*([s8] * 3))
    return mod.QModelConfig(layers={str(l): mod.QLayerConfig(experts=dict(experts))
                                    for l in range(cfg.num_moe_layers)})


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_logits_mixed_packed_vs_jax(name):
    """Mixed-packed routed experts (alternating w4a4 / w8a8, the w4 ones
    nibble-packed; a w8a8 shared expert where the family has one), the JAX
    kernels in interpret mode against the port's plain versions."""
    cfg_j, cfg_t, float_j, _ = _params(name, seed=3)
    params_j = jax_qparams.quantize_model_experts_mixed(
        float_j, cfg_j, _alternating(cfg_j, jax_schemes), pack_w4=True)
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), "cpu")
    assert "expert_gate_up_qcat" in params_t["layers"]
    toks = _tokens(cfg_t, seed=3)
    want = jax_model.forward_logits(params_j, jnp.asarray(toks), cfg_j,
                                    JaxMoEImpl(quant="mixed", interpret=True))
    got = model.forward_logits(params_t, torch.from_numpy(toks), cfg_t,
                               MoEImpl(quant="mixed"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-2)


def test_make_forward_fn_is_forward_logits_under_inference_mode():
    cfg_j, cfg_t, params_j, params_t = _params("tiny_ds2", seed=4)
    toks = torch.from_numpy(_tokens(cfg_t, seed=4))
    fn = model.make_forward_fn(cfg_t, MoEImpl())
    out = fn(params_t, toks)
    assert out.is_inference()
    assert torch.equal(out, model.forward_logits(params_t, toks, cfg_t))


def test_forward_hidden_positions_and_decoder_layers():
    """forward_hidden with explicit positions equals the reference's; the
    dense layer runs first (params["dense_layers"]), then the MoE layers."""
    cfg_j, cfg_t, params_j, params_t = _params("tiny_ds2", seed=5)
    toks = _tokens(cfg_t, seed=5, b=1, s=6)
    pos = np.arange(3, 9, dtype=np.int32)
    want = jax_model.forward_hidden(params_j, jnp.asarray(toks), cfg_j,
                                    positions=jnp.asarray(pos))
    got = model.forward_hidden(params_t, torch.from_numpy(toks), cfg_t,
                               positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    # by hand: the dense layer, then the MoE layers, then the final norm
    x = params_t["embed"][torch.from_numpy(toks).long()]
    cos, sin = layers.make_rope_tables(cfg_t, torch.from_numpy(pos))
    for stack, dense in ((params_t["dense_layers"], True), (params_t["layers"], False)):
        for l in range(stack["input_norm"].shape[0]):
            x = layers.decoder_layer(x, {k: v[l] for k, v in stack.items()}, cfg_t,
                                     cos, sin, dense_mlp=dense)
    assert torch.equal(layers.rms_norm(x, params_t["final_norm"], cfg_t.rms_norm_eps),
                       got)


def test_unported_branches_raise():
    cfg = configs.tiny_qwen2_moe()
    q = torch.zeros((1, 4, cfg.num_heads, cfg.head_dim))
    k = torch.zeros((1, 4, cfg.num_kv_heads, cfg.head_dim))
    # ring attention is ported (parallel.ring_attention): outside a process
    # group it raises, naming the missing group
    with pytest.raises(RuntimeError, match="process group"):
        layers.attention(q, k, k, backend="ring")
    with pytest.raises(ValueError, match="backend"):
        layers.attention(q, k, k, backend="splash")
    # the dense layer's fake-quantized activations are ported: at 16 bits they
    # pass the rows through, at 4 they move the output
    gen = torch.Generator().manual_seed(0)
    lp = {"act_bits_dense": torch.tensor([16.0, 16.0]),
          "mlp_gate_up": torch.randn((64, 256), generator=gen),
          "mlp_down": torch.randn((128, 64), generator=gen)}
    x = torch.randn((1, 2, 64), generator=gen)
    plain = {k: v for k, v in lp.items() if k != "act_bits_dense"}
    ds2 = configs.tiny_ds2()
    torch.testing.assert_close(layers.dense_mlp_block(x, lp, ds2),
                               layers.dense_mlp_block(x, plain, ds2))
    lp["act_bits_dense"] = torch.tensor([4.0, 4.0])
    assert not torch.allclose(layers.dense_mlp_block(x, lp, ds2),
                              layers.dense_mlp_block(x, plain, ds2))
    with pytest.raises(ValueError, match="decode_attn"):
        MoEImpl(decode_attn="splash").use_fused_decode()


def test_new_modules_import_no_jax():
    """The full forward, the MLA serving path, the read-only decode
    attention, the crossover bench and chip_smoke.py import neither jax nor
    the JAX package."""
    import subprocess
    import sys

    mods = ["mxmoe_tpu_torch.models.model", "mxmoe_tpu_torch.models.layers",
            "mxmoe_tpu_torch.serving.decode", "mxmoe_tpu_torch.serving.decode_attention",
            "mxmoe_tpu_torch.serving.kv_cache", "mxmoe_tpu_torch.bench.headline",
            "mxmoe_tpu_torch.bench.decode_attn_crossover", "chip_smoke"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'mxmoe_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
