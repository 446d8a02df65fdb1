"""Port parity for the mixed-precision packed serving slice with an int8 KV
cache: the JAX Engine (Pallas kernels in interpret mode) against the port's
Engine (the kernels' plain versions) on the same weights, at tiny widths
(2 layers, 8 experts, top-2, alternating w4a4 / w8a8 experts nibble-packed
into the ragged buffer, shared expert real-quantized w8a8).

Tolerances: greedy tokens are equal. Logits of the cached forward agree to
atol 2e-2 (|logits| ~ 1): f32 matmuls sum in other orders in XLA and torch,
which can move an activation across a rounding boundary of its 4-bit code
(one step is 1/7 of the row's maximum, against 1/127 for the uniform w8a8
slice and its 2e-3) or a cached K/V element across an int8 boundary. For
the same reason the caches after the run agree to one code step, and the
scales to rtol 5e-3: layer 1's K/V inherit layer 0's flipped codes (read:
6.7e-4). Bitwise equality of the cache write on the same inputs is pinned
in test_torch_kv_quant.py. Within the port, int8-stored and
packed params give bitwise equal logits."""

import dataclasses
import subprocess
import sys

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
from mxmoe_tpu.serving import decode as jax_decode
from mxmoe_tpu.serving import kv_cache as jax_kv
from mxmoe_tpu.serving.engine import Engine as JaxEngine
from mxmoe_tpu.serving.engine import EngineConfig as JaxEngineConfig
from mxmoe_tpu_torch.models import configs
from mxmoe_tpu_torch.models.layers import MoEImpl, moe_block
from mxmoe_tpu_torch.models.model import head_logits
from mxmoe_tpu_torch.ops import kernels
from mxmoe_tpu_torch.params_from_jax import params_from_jax
from mxmoe_tpu_torch.quant.schemes import parse_scheme
from mxmoe_tpu_torch.serving import decode, kv_cache
from mxmoe_tpu_torch.serving.bench_serving import (alternating_mixed_config,
                                                   quantize_for_serving)
from mxmoe_tpu_torch.serving.engine import Engine, EngineConfig

LOGIT_ATOL = 2e-2


def _cfgs():
    kw = dict(hidden_size=256, num_heads=4, num_kv_heads=2, head_dim=128)
    return (dataclasses.replace(jax_configs.tiny_qwen2_moe(8, 2), **kw),
            dataclasses.replace(configs.tiny_qwen2_moe(8, 2), **kw))


def _jax_alternating(cfg):
    s4, s8 = (jax_schemes.parse_scheme(s) for s in ("w4a4_g-1_sym", "w8a8_g-1_sym"))
    experts = {str(e): jax_schemes.QExpertConfig(*([(s4, s8)[e % 2]] * 3))
               for e in range(cfg.num_experts)}
    experts[str(cfg.num_experts)] = jax_schemes.QExpertConfig(*([s8] * 3))
    return jax_schemes.QModelConfig(layers={
        str(l): jax_schemes.QLayerConfig(experts=dict(experts))
        for l in range(cfg.num_layers)})


@pytest.fixture(scope="module")
def models():
    cfg_j, cfg_t = _cfgs()
    float_j = jax_model.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    params_j = jax_quantize_mixed(float_j, cfg_j, _jax_alternating(cfg_j), pack_w4=True)
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), "cpu")
    float_t = params_from_jax(jax.tree_util.tree_map(np.asarray, float_j), "cpu")
    impl_j = JaxMoEImpl(kind="ragged", quant="mixed", interpret=True,
                        decode_attn="fused")
    return cfg_j, cfg_t, params_j, params_t, impl_j, MoEImpl(quant="mixed"), float_t


def test_alternating_config_matches_reference_entry_point(models):
    cfg_j, cfg_t = models[0], models[1]
    got = alternating_mixed_config(cfg_t.num_layers, cfg_t.num_experts)
    assert got.to_dict() == _jax_alternating(cfg_j).to_dict()
    bare = alternating_mixed_config(1, 4, shared_quant=False)
    assert sorted(bare.layer(0).experts) == ["0", "1", "2", "3"]


def test_engine_greedy_tokens_equal(models):
    cfg_j, cfg_t, params_j, params_t, impl_j, impl_t, _ = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg_t.vocab_size, n).tolist() for n in (21, 9)]
    ej = JaxEngine(params_j, cfg_j, JaxEngineConfig(
        batch_slots=2, max_len=64, prefill_chunk=16, int8_kv=True), impl_j)
    kernels.reset_launch_counts()
    et = Engine(params_t, cfg_t, EngineConfig(
        batch_slots=2, max_len=64, prefill_chunk=16, int8_kv=True), impl_t)
    assert isinstance(et.cache, kv_cache.QuantKVCache)
    rid_j = [ej.submit(p, max_new_tokens=6) for p in prompts]
    rid_t = [et.submit(p, max_new_tokens=6) for p in prompts]
    out_j = ej.run_to_completion(chunk=3)
    out_t = et.run_to_completion(chunk=3)
    assert [out_t[r] for r in rid_t] == [out_j[r] for r in rid_j]
    assert all(len(out_t[r]) == 6 for r in rid_t)
    assert all(n == 0 for n in kernels.launches.values()), kernels.launches
    np.testing.assert_array_equal(et.cache.lengths.numpy(), np.asarray(ej.cache.lengths))


def test_forward_cached_logits_and_cache_close(models):
    cfg_j, cfg_t, params_j, params_t, impl_j, impl_t, _ = models
    rng = np.random.default_rng(1)
    b, s = 2, 12
    toks = rng.integers(0, cfg_t.vocab_size, (b, s)).astype(np.int32)
    cj = jax_kv.init_quant_kv_cache(cfg_j, b, 32)
    ct = kv_cache.init_quant_kv_cache(cfg_t, b, 32, device="cpu")
    steps = [(toks, np.asarray([12, 7], np.int32))] + [
        (rng.integers(0, cfg_t.vocab_size, (b, 1)).astype(np.int32),
         np.asarray([1, 1], np.int32)) for _ in range(3)]
    fwd_j = jax.jit(lambda p, t, c, v: jax_decode.forward_cached(
        p, t, c, cfg_j, impl_j, valid_lengths=v))
    for i, (tk, vl) in enumerate(steps):
        lj, cj = fwd_j(params_j, jnp.asarray(tk), cj, jnp.asarray(vl))
        lt, ct = decode.forward_cached(params_t, torch.from_numpy(tk), ct, cfg_t,
                                       impl_t, valid_lengths=torch.from_numpy(vl))
        lj = np.asarray(lj)
        for r in range(b):   # rows past a slot's valid length are padding
            np.testing.assert_allclose(lt.numpy()[r, :vl[r]], lj[r, :vl[r]],
                                       rtol=0, atol=LOGIT_ATOL, err_msg=f"step {i}")
        np.testing.assert_array_equal(ct.lengths.numpy(), np.asarray(cj.lengths))
    assert isinstance(ct, kv_cache.QuantKVCache)
    for name in ("k_q", "v_q"):
        d = np.abs(getattr(ct, name).numpy().astype(np.int32)
                   - np.asarray(getattr(cj, name)).astype(np.int32))
        assert d.max() <= 1, name
        assert (d != 0).mean() < 1e-3, name
    for name in ("k_sc", "v_sc"):
        np.testing.assert_allclose(getattr(ct, name).numpy(),
                                   np.asarray(getattr(cj, name)), rtol=5e-3, atol=0)


def test_int8_stored_and_packed_logits_bitwise(models):
    """The product claim: packing w4 experts changes bytes, not outputs."""
    _, cfg_t, _, _, _, _, float_t = models
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg_t.vocab_size, (2, 10)).astype(np.int32))
    logits = {}
    for quant in ("mixed", "mixed-packed"):
        params, impl = quantize_for_serving(float_t, cfg_t, quant)
        assert ("expert_gate_up_qcat" in params["layers"]) == (quant == "mixed-packed")
        cache = kv_cache.init_quant_kv_cache(cfg_t, 2, 24, device="cpu")
        lg, cache = decode.forward_cached(params, toks, cache, cfg_t, impl)
        out = [lg]
        for _ in range(3):
            lg, cache = decode.forward_cached(
                params, lg[:, -1:].argmax(-1).to(torch.int32), cache, cfg_t, impl)
            out.append(lg)
        logits[quant] = torch.cat(out, dim=1)
    assert torch.equal(logits["mixed"], logits["mixed-packed"])
    # the float shared expert (--no-shared-quant) still runs
    params, impl = quantize_for_serving(float_t, cfg_t, "mixed-packed", shared_quant=False)
    assert "shared_gate_up" in params["layers"]
    lg, _ = decode.forward_cached(params, toks, kv_cache.init_kv_cache(cfg_t, 2, 24, device="cpu"),
                                  cfg_t, impl)
    assert torch.isfinite(lg).all()


def test_uniform_packed_w4_matches_int8_stored(models):
    """convert's pack step: a uniform w4a8 model served from _q_packed (K5's
    path) gives bitwise the logits of its int8-stored codes (K2's path)."""
    from mxmoe_tpu_torch.models.convert import pack_int4_experts

    _, cfg_t, _, _, _, _, float_t = models
    qcfg = parse_scheme("w4a8_g-1_sym")
    params, impl = quantize_for_serving(float_t, cfg_t, "w4a8_g-1_sym")
    packed = pack_int4_experts(params, qcfg)
    assert "expert_gate_up_q" not in packed["layers"]
    toks = torch.arange(14, dtype=torch.int32).reshape(2, 7)
    a, _ = decode.forward_cached(params, toks, kv_cache.init_kv_cache(cfg_t, 2, 16, device="cpu"),
                                 cfg_t, impl)
    b, _ = decode.forward_cached(packed, toks, kv_cache.init_kv_cache(cfg_t, 2, 16, device="cpu"),
                                 cfg_t, impl)
    assert torch.equal(a, b)


def _layer(models, l=0):
    params_t = models[3]
    return {k: v[l] for k, v in params_t["layers"].items()}


def test_unported_branches_raise_with_their_roadmap_item(models):
    """Malformed layers raise; the branches that raised before they were
    ported (flex over the packed buffer, the bf16 path, the int8 head, the
    fake-quantized shared expert) now give their result (the name stays)."""
    cfg_t, impl_t = models[1], models[5]
    x = torch.zeros((1, 3, cfg_t.hidden_size))
    lp = _layer(models)
    # a flex (grouped / asymmetric) family over the ragged packed buffer: the
    # per-channel scales replicated over two k-groups, every expert per token
    g = 2
    flex = dict(lp, act_gsize_gateup=torch.full((cfg_t.num_experts, g), -1.0),
                expert_gate_up_sc=lp["expert_gate_up_sc"].repeat(1, g, 1))
    xr = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, 3, cfg_t.hidden_size)).astype(np.float32))
    torch.testing.assert_close(moe_block(xr, flex, cfg_t, impl_t),
                               moe_block(xr, lp, cfg_t, impl_t), rtol=1e-5, atol=1e-6)
    # grouped scales that no flex marker announces are a malformed layer
    grouped_sc = dict(lp, expert_down_sc=lp["expert_down_sc"].repeat(1, 2, 1))
    with pytest.raises(ValueError, match="act_gsize_down"):
        moe_block(x, grouped_sc, cfg_t, impl_t)
    uniform = {k: v for k, v in lp.items()
               if not k.startswith("act_bits") and "_qcat" not in k}
    uniform["expert_gate_up_q_packed"] = torch.zeros(
        (cfg_t.num_experts, 128, 64), dtype=torch.int8)
    # packed w x a storage serves per-channel symmetric weights only
    with pytest.raises(ValueError, match="packed w x a"):
        moe_block(x, uniform, cfg_t, MoEImpl(quant=parse_scheme("w4a4_g128_sym")))
    with pytest.raises(ValueError, match="packed w x a"):
        moe_block(x, uniform, cfg_t, MoEImpl(quant=dataclasses.replace(
            parse_scheme("w4a8_g-1_sym"), w_sym=False)))
    with pytest.raises(NotImplementedError, match="asymmetric per-token activations"):
        moe_block(x, uniform, cfg_t, MoEImpl(quant=dataclasses.replace(
            parse_scheme("w4a8_g-1_sym"), a_sym=False)))
    with pytest.raises(ValueError, match="needs mixed params"):
        moe_block(x, uniform, cfg_t, impl_t)
    # quant=None takes the float path, which serves float expert weights (the
    # dense oracle agrees with it) and refuses a layer that holds none
    with pytest.raises(ValueError, match="no float expert weights"):
        moe_block(x, lp, cfg_t, MoEImpl())
    float_t = models[6]
    flp = {k: v[0] for k, v in float_t["layers"].items()}
    torch.testing.assert_close(moe_block(xr, flp, cfg_t, MoEImpl()),
                               moe_block(xr, flp, cfg_t, MoEImpl(kind="dense")),
                               rtol=1e-5, atol=1e-6)
    # fake-quantized activations over float expert weights are ported: at 16
    # bits they pass the rows through
    e = cfg_t.num_experts
    fq16 = dict(flp, act_bits_gateup=torch.full((e,), 16.0),
                act_bits_down=torch.full((e,), 16.0))
    torch.testing.assert_close(moe_block(xr, fq16, cfg_t, MoEImpl()),
                               moe_block(xr, flp, cfg_t, MoEImpl()))
    # the fake-quantized shared expert (float weights beside act_bits_shared)
    # is ported: at 16 bits its act quant passes the rows through
    fake_shared = {k: v for k, v in lp.items() if not k.startswith("shared_")}
    fake_shared.update(shared_gate_up=flp["shared_gate_up"],
                       shared_down=flp["shared_down"], shared_gate=flp["shared_gate"],
                       act_bits_shared=torch.tensor([16.0, 16.0]))
    no_shared = {k: v for k, v in fake_shared.items() if k != "act_bits_shared"}
    torch.testing.assert_close(moe_block(xr, fake_shared, cfg_t, impl_t),
                               moe_block(xr, no_shared, cfg_t, impl_t), rtol=0, atol=0)
    # the int8 head: within one 8-bit step of the float head on both operands
    from mxmoe_tpu_torch.quant.qparams import quantize_lm_head
    head8 = quantize_lm_head(float_t)
    assert "lm_head" not in head8 and head8["lm_head_q"].dtype == torch.int8
    want = head_logits(float_t, xr, cfg_t)
    got = head_logits(head8, xr, cfg_t)
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 0.02 * want.abs().max()
    # --quant none: float params pass through with the default MoEImpl
    params, impl = quantize_for_serving(float_t, cfg_t, "none")
    assert params is float_t and impl == MoEImpl()


@pytest.mark.parametrize("extra", [["--quant", "mixed-packed", "--int8-kv"],
                                   ["--quant", "w8a8_g-1_sym"],
                                   ["--quant", "none"],
                                   ["--quant", "w8a8_g-1_sym", "--int8-head"]],
                         ids=["mixed-packed-int8kv", "w8a8", "none", "int8-head"])
def test_bench_serving_entry_point_on_cpu(models, monkeypatch, capsys, extra):
    """main() at tiny widths on the CPU: one JSON line with the reference's
    keys."""
    import json

    from mxmoe_tpu_torch.serving import bench_serving

    monkeypatch.setattr(configs, "config_for", lambda name: models[1])
    bench_serving.main(["--layers", "2", "--slots", "2", "--max-len", "64",
                        "--prefill", "8", "--device", "cpu", *extra])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == {"model", "layers", "slots", "quant", "int8_head", "int8_kv",
                        "prefill_ms", "prefill_tokens_per_s", "decode_attn",
                        "decode_step_ms", "decode_tokens_per_s", "device"}
    assert res["int8_kv"] is ("--int8-kv" in extra) and res["device"] == "cpu"
    assert res["int8_head"] is ("--int8-head" in extra)
    assert res["decode_tokens_per_s"] > 0 and res["prefill_ms"] > 0


def test_new_modules_import_no_jax():
    mods = ["mxmoe_tpu_torch.serving.bench_serving", "mxmoe_tpu_torch.models.convert",
            "mxmoe_tpu_torch.ops.gmm_mixed_packed", "mxmoe_tpu_torch.ops.gmm_w4a8_packed",
            "mxmoe_tpu_torch.serving.kv_cache", "mxmoe_tpu_torch.serving.decode_attention",
            "mxmoe_tpu_torch.quant.packing", "mxmoe_tpu_torch.quant.schemes"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'mxmoe_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
