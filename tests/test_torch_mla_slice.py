"""Port parity for DeepSeek-V2-style serving (MLA attention over the
128-padded K cache, a dense first layer, shared experts): the port's
``forward_cached`` / ``Engine`` against the JAX package's (Pallas kernels in
interpret mode), on ``tiny_ds2`` with v_head_dim 128 so that the reference's
fused decode path is legal (its gate needs 128-aligned cache widths; the K
width 24 pads to 128), from one JAX init carried over by
``params_from_jax``.

Tolerances: float32 weights with a bf16 cache: logits atol 2e-3 (|logits| ~
1e-1): f32 matmuls sum in other orders in XLA and torch, which can move a
cached K/V element across a bf16 rounding boundary. With the int8 cache,
atol 2e-2: such an element may cross an int8 code boundary (one step is
1/127 of the vector's maximum). Mixed-packed experts: atol 2e-2 and equal
greedy tokens, as the mixed serving slice. Cached decode against the
port's own full forward: rtol = atol = 6e-4, the reference's bound for the
same check (tests/test_serving.py)."""

import dataclasses
import functools

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
from mxmoe_tpu.serving import decode as jax_decode
from mxmoe_tpu.serving import kv_cache as jax_kv
from mxmoe_tpu.serving.engine import Engine as JaxEngine
from mxmoe_tpu.serving.engine import EngineConfig as JaxEngineConfig
from mxmoe_tpu_torch.models import configs, model
from mxmoe_tpu_torch.models.layers import MoEImpl
from mxmoe_tpu_torch.ops import kernels
from mxmoe_tpu_torch.params_from_jax import params_from_jax
from mxmoe_tpu_torch.quant.qparams import quantize_lm_head
from mxmoe_tpu_torch.serving import decode, kv_cache
from mxmoe_tpu_torch.serving.bench_serving import (alternating_mixed_config,
                                                   quantize_for_serving)
from mxmoe_tpu_torch.serving.engine import Engine, EngineConfig

KW = dict(v_head_dim=128)


def _cfgs():
    return (dataclasses.replace(jax_configs.tiny_ds2(4, 3), **KW),
            dataclasses.replace(configs.tiny_ds2(4, 3), **KW))


@pytest.fixture(scope="module")
def models():
    cfg_j, cfg_t = _cfgs()
    params_j = jax_model.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), "cpu")
    return cfg_j, cfg_t, params_j, params_t


def test_mla_cache_shapes_equal_the_reference(models):
    cfg_j, cfg_t = models[0], models[1]
    assert kv_cache.mla_cache_k_dim(cfg_t) == jax_kv.mla_cache_k_dim(cfg_j) == 128
    assert kv_cache.mla_cache_k_dim(configs.DEEPSEEK_V2_LITE) == 256
    for init_t, init_j in ((kv_cache.init_kv_cache, jax_kv.init_kv_cache),
                           (kv_cache.init_quant_kv_cache, jax_kv.init_quant_kv_cache)):
        ct, cj = init_t(cfg_t, 2, 16, device="cpu"), init_j(cfg_j, 2, 16)
        for f in dataclasses.fields(ct):
            a, b = getattr(ct, f.name), getattr(cj, f.name)
            assert tuple(a.shape) == tuple(b.shape), f.name
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype), f.name


def _steps(cfg, seed):
    rng = np.random.default_rng(seed)
    b, s = 2, 12
    return [(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             np.asarray([12, 7], np.int32))] + [
        (rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32),
         np.asarray([1, 1], np.int32)) for _ in range(3)]


@pytest.mark.parametrize("int8_kv", [False, True])
@pytest.mark.parametrize("decode_attn", ["fused", "xla"])
def test_forward_cached_vs_jax(models, int8_kv, decode_attn):
    cfg_j, cfg_t, params_j, params_t = models
    impl_j = JaxMoEImpl(decode_attn=decode_attn, interpret=True)
    impl_t = MoEImpl(decode_attn=decode_attn)
    if int8_kv:
        cj = jax_kv.init_quant_kv_cache(cfg_j, 2, 32)
        ct = kv_cache.init_quant_kv_cache(cfg_t, 2, 32, device="cpu")
        atol = 2e-2
    else:
        cj = jax_kv.init_kv_cache(cfg_j, 2, 32)
        ct = kv_cache.init_kv_cache(cfg_t, 2, 32, device="cpu")
        atol = 2e-3
    fwd_j = jax.jit(lambda p, t, c, v: jax_decode.forward_cached(
        p, t, c, cfg_j, impl_j, valid_lengths=v))
    kernels.reset_launch_counts()
    for i, (tk, vl) in enumerate(_steps(cfg_t, 1)):
        lj, cj = fwd_j(params_j, jnp.asarray(tk), cj, jnp.asarray(vl))
        lt, ct = decode.forward_cached(params_t, torch.from_numpy(tk), ct, cfg_t,
                                       impl_t, valid_lengths=torch.from_numpy(vl))
        lj = np.asarray(lj)
        for r in range(2):           # rows past a slot's valid length are padding
            np.testing.assert_allclose(lt.numpy()[r, :vl[r]], lj[r, :vl[r]],
                                       rtol=0, atol=atol, err_msg=f"step {i}")
        np.testing.assert_array_equal(ct.lengths.numpy(), np.asarray(cj.lengths))
    assert all(n == 0 for n in kernels.launches.values())
    # every layer's cache, the dense layer 0 included, holds the same K / V
    if int8_kv:
        assert np.abs(ct.k_q.numpy().astype(int) - np.asarray(cj.k_q)).max() <= 1
        np.testing.assert_allclose(ct.k_sc.numpy(), np.asarray(cj.k_sc), rtol=5e-3)
    else:
        np.testing.assert_allclose(ct.k.float().numpy(),
                                   np.asarray(cj.k.astype(jnp.float32)),
                                   rtol=0, atol=2e-2)
        np.testing.assert_allclose(ct.v.float().numpy(),
                                   np.asarray(cj.v.astype(jnp.float32)),
                                   rtol=0, atol=2e-2)
        # the K cache's padded tail stays zero
        assert not ct.k[..., cfg_t.qk_head_dim:].any()


@pytest.mark.parametrize("decode_attn", ["fused", "xla"])
def test_cached_decode_equals_the_full_forward(decode_attn):
    """MLA + dense first layer: cached decode == full re-forward (the port's
    copy of the reference's test_ds2_mla_decode_matches_full_forward)."""
    cfg_j = jax_configs.tiny_ds2(num_experts=4, num_layers=3)
    cfg = configs.tiny_ds2(num_experts=4, num_layers=3)
    params = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(cfg_j, jax.random.PRNGKey(7),
                                          dtype=jnp.float32)), "cpu")
    full = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (1, 10)).astype(np.int32))
    impl = MoEImpl(decode_attn=decode_attn)
    cache = kv_cache.init_kv_cache(cfg, 1, 32, torch.float32, "cpu")
    logits_p, cache = decode.forward_cached(params, full[:, :6], cache, cfg, impl)
    outs = [logits_p[:, 5]]
    for i in range(6, 10):
        logits, cache = decode.forward_cached(params, full[:, i:i + 1], cache, cfg,
                                              impl)
        outs.append(logits[:, 0])
    got = torch.stack(outs, dim=1)
    ref = model.forward_logits(params, full, cfg)[:, 5:10]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=6e-4, atol=6e-4)


def test_engine_generation_equals_greedy_reforwards():
    """The port's copy of the reference's test_ds2_engine_generation: the
    Engine's tokens are those of greedy full re-forwards."""
    cfg_j = jax_configs.tiny_ds2(num_experts=4, num_layers=3)
    cfg = configs.tiny_ds2(num_experts=4, num_layers=3)
    params = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(cfg_j, jax.random.PRNGKey(9),
                                          dtype=jnp.float32)), "cpu")
    eng = Engine(params, cfg, EngineConfig(batch_slots=1, max_len=64,
                                           prefill_chunk=8))
    rid = eng.submit([3, 5, 7], max_new_tokens=5)
    got = eng.run_to_completion()[rid]
    assert len(got) == 5
    seq = [3, 5, 7]
    for tok in got:
        logits = model.forward_logits(params, torch.tensor([seq], dtype=torch.int32),
                                      cfg)
        assert tok == int(logits[0, -1].argmax())
        seq.append(tok)


def _jax_alternating(cfg):
    s4, s8 = (jax_schemes.parse_scheme(s) for s in ("w4a4_g-1_sym", "w8a8_g-1_sym"))
    experts = {str(e): jax_schemes.QExpertConfig(*([(s4, s8)[e % 2]] * 3))
               for e in range(cfg.num_experts)}
    experts[str(cfg.num_experts)] = jax_schemes.QExpertConfig(*([s8] * 3))
    return jax_schemes.QModelConfig(layers={
        str(l): jax_schemes.QLayerConfig(experts=dict(experts))
        for l in range(cfg.num_moe_layers)})


def test_mixed_config_counts_the_moe_layers(models):
    """quantize_for_serving builds its QModelConfig over the MoE layers:
    ds2's dense first layer keeps its float MLP."""
    cfg_j, cfg_t, _, params_t = models
    assert (alternating_mixed_config(cfg_t.num_moe_layers, cfg_t.num_experts).to_dict()
            == _jax_alternating(cfg_j).to_dict())
    q, impl = quantize_for_serving(params_t, cfg_t, "mixed-packed",
                                   decode_attn="xla")
    assert q["layers"]["act_bits_gateup"].shape == (cfg_t.num_moe_layers,
                                                    cfg_t.num_experts)
    assert q["dense_layers"] is params_t["dense_layers"]
    assert impl.decode_attn == "xla" and impl.quant == "mixed"


def test_mixed_packed_int8_head_engine_vs_jax(models):
    """Mixed-packed routed experts, the w8a8 shared expert, the int8 KV cache
    and the int8 lm_head: the JAX Engine and the port's give the same greedy
    tokens, and the cached forward's logits agree."""
    cfg_j, cfg_t, params_j, _ = models
    qj = jax_qparams.quantize_lm_head(jax_qparams.quantize_model_experts_mixed(
        params_j, cfg_j, _jax_alternating(cfg_j), pack_w4=True))
    qt = params_from_jax(jax.tree_util.tree_map(np.asarray, qj), "cpu")
    assert "lm_head_q" in qt and "expert_gate_up_qcat" in qt["layers"]
    impl_j = JaxMoEImpl(quant="mixed", interpret=True, decode_attn="fused")
    impl_t = MoEImpl(quant="mixed")
    ecfg = dict(batch_slots=2, max_len=64, prefill_chunk=16, int8_kv=True)
    ej = JaxEngine(qj, cfg_j, JaxEngineConfig(**ecfg), impl_j)
    et = Engine(qt, cfg_t, EngineConfig(**ecfg), impl_t)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg_t.vocab_size, n).tolist() for n in (21, 9)]
    rid_j = [ej.submit(p, max_new_tokens=6) for p in prompts]
    rid_t = [et.submit(p, max_new_tokens=6) for p in prompts]
    out_j, out_t = ej.run_to_completion(chunk=3), et.run_to_completion(chunk=3)
    assert [out_t[r] for r in rid_t] == [out_j[r] for r in rid_j]

    cj = jax_kv.init_quant_kv_cache(cfg_j, 2, 32)
    ct = kv_cache.init_quant_kv_cache(cfg_t, 2, 32, device="cpu")
    fwd_j = jax.jit(lambda p, t, c, v: jax_decode.forward_cached(
        p, t, c, cfg_j, impl_j, valid_lengths=v))
    for i, (tk, vl) in enumerate(_steps(cfg_t, 2)):
        lj, cj = fwd_j(qj, jnp.asarray(tk), cj, jnp.asarray(vl))
        lt, ct = decode.forward_cached(qt, torch.from_numpy(tk), ct, cfg_t, impl_t,
                                       valid_lengths=torch.from_numpy(vl))
        lj = np.asarray(lj)
        for r in range(2):
            np.testing.assert_allclose(lt.numpy()[r, :vl[r]], lj[r, :vl[r]],
                                       rtol=0, atol=2e-2, err_msg=f"step {i}")
    # the port's int8 head is its own quantize_lm_head's
    head = quantize_lm_head(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params_j), "cpu"))
    assert torch.equal(head["lm_head_q"], qt["lm_head_q"])


@pytest.mark.parametrize("name,quant", [
    ("tiny_ds2", "mixed-packed"), ("tiny_ds2", "w8a8_g-1_sym"), ("tiny_ds2", "none"),
    ("tiny_qwen2_moe", "flex-packed"), ("tiny_mixtral", "mixed"),
])
def test_layerwise_init_quantizes_as_the_whole_model(name, quant):
    """``init_for_serving`` draws and quantizes one MoE layer at a time; its
    params equal, bit for bit, the whole-model quantizer's over the same
    layer-by-layer draws (ragged buffers, scales, act bits and markers), and
    the float model never exists whole."""
    from mxmoe_tpu_torch.models.model import init_params
    from mxmoe_tpu_torch.serving.bench_serving import init_for_serving

    cfg = getattr(configs, name)()
    if name == "tiny_qwen2_moe":            # g128 flex families need K >= 128
        cfg = dataclasses.replace(cfg, hidden_size=256, moe_intermediate_size=128)
    got, impl = init_for_serving(
        cfg, torch.Generator().manual_seed(3),
        functools.partial(quantize_for_serving, quant=quant), "cpu")
    floats = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    want, impl_w = quantize_for_serving(floats, cfg, quant)
    assert impl == impl_w
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    for group in ("layers", "dense_layers"):
        for k, v in want.get(group, {}).items():
            assert got[group][k].shape == v.shape and torch.equal(got[group][k], v), k
    for k in ("embed", "lm_head", "final_norm"):
        assert torch.equal(got[k], want[k])


def test_layer_stacks_grow_a_longer_ragged_buffer_with_zero_rows():
    """A later layer whose ragged buffer has more rows grows the stack; the
    shorter layers' tails are zero, as ``pack_ragged_stack`` pads."""
    from mxmoe_tpu_torch.models.model import _put_layer

    stacks = {}
    a = torch.arange(8, dtype=torch.int8).reshape(1, 4, 2)
    b = torch.arange(12, dtype=torch.int8).reshape(1, 6, 2) + 20
    _put_layer(stacks, {"x_qcat": a, "norm": torch.ones((1, 3))}, 0, 2)
    _put_layer(stacks, {"x_qcat": b, "norm": torch.ones((1, 3)) * 2}, 1, 2)
    assert stacks["x_qcat"].shape == (2, 6, 2)
    assert torch.equal(stacks["x_qcat"][0, :4], a[0])
    assert not stacks["x_qcat"][0, 4:].any()
    assert torch.equal(stacks["x_qcat"][1], b[0])
    assert torch.equal(stacks["norm"], torch.tensor([[1.0] * 3, [2.0] * 3]))
