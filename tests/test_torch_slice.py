"""Port parity for the whole serving slice: the JAX Engine (all three Pallas
kernels in interpret mode) against the port's Engine (their plain
versions) on the same weights, plus the port's import hygiene.

Tolerances: greedy tokens are equal. Logits of the cached forward agree to
atol 2e-3 (|logits| ~ 1): f32 matmuls sum in other orders in XLA and
torch, which can move an activation across an int8 rounding boundary and
shift one expert output by one code step."""

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
from mxmoe_tpu.quant.qparams import quantize_model_experts_uniform as jax_quantize
from mxmoe_tpu.quant.schemes import parse_scheme as jax_parse_scheme
from mxmoe_tpu.serving import decode as jax_decode
from mxmoe_tpu.serving import kv_cache as jax_kv
from mxmoe_tpu.serving.engine import Engine as JaxEngine
from mxmoe_tpu.serving.engine import EngineConfig as JaxEngineConfig
from mxmoe_tpu_torch.models import configs
from mxmoe_tpu_torch.models.layers import MoEImpl
from mxmoe_tpu_torch.ops import kernels
from mxmoe_tpu_torch.params_from_jax import params_from_jax
from mxmoe_tpu_torch.quant.schemes import parse_scheme
from mxmoe_tpu_torch.serving import decode, kv_cache
from mxmoe_tpu_torch.serving.engine import Engine, EngineConfig

SCHEME = "w8a8_g-1_sym"
LOGIT_ATOL = 2e-3


def _cfgs():
    kw = dict(hidden_size=256, num_heads=4, num_kv_heads=2, head_dim=128)
    return (dataclasses.replace(jax_configs.tiny_qwen2_moe(8, 2), **kw),
            dataclasses.replace(configs.tiny_qwen2_moe(8, 2), **kw))


@pytest.fixture(scope="module")
def models():
    cfg_j, cfg_t = _cfgs()
    params_j = jax_quantize(jax_model.init_params(cfg_j, jax.random.PRNGKey(0),
                                                  dtype=jnp.float32),
                            jax_parse_scheme(SCHEME))
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), "cpu")
    impl_j = JaxMoEImpl(kind="ragged", quant=jax_parse_scheme(SCHEME),
                        interpret=True, decode_attn="fused")
    impl_t = MoEImpl(quant=parse_scheme(SCHEME))
    return cfg_j, cfg_t, params_j, params_t, impl_j, impl_t


def test_engine_greedy_tokens_equal(models):
    cfg_j, cfg_t, params_j, params_t, impl_j, impl_t = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg_t.vocab_size, n).tolist() for n in (21, 9)]
    ej = JaxEngine(params_j, cfg_j, JaxEngineConfig(batch_slots=2, max_len=64,
                                                    prefill_chunk=16), impl_j)
    kernels.reset_launch_counts()
    et = Engine(params_t, cfg_t, EngineConfig(batch_slots=2, max_len=64,
                                              prefill_chunk=16), impl_t)
    rid_j = [ej.submit(p, max_new_tokens=6) for p in prompts]
    rid_t = [et.submit(p, max_new_tokens=6) for p in prompts]
    out_j = ej.run_to_completion(chunk=3)
    out_t = et.run_to_completion(chunk=3)
    assert [out_t[r] for r in rid_t] == [out_j[r] for r in rid_j]
    assert all(len(out_t[r]) == 6 for r in rid_t)
    # CPU tensors never launch a kernel
    assert all(n == 0 for n in kernels.launches.values()), kernels.launches


def test_forward_cached_logits_close(models):
    cfg_j, cfg_t, params_j, params_t, impl_j, impl_t = models
    rng = np.random.default_rng(1)
    b, s = 2, 12
    toks = rng.integers(0, cfg_t.vocab_size, (b, s)).astype(np.int32)
    valid = np.asarray([12, 7], np.int32)
    cj = jax_kv.init_kv_cache(cfg_j, b, 32)
    ct = kv_cache.init_kv_cache(cfg_t, b, 32, device="cpu")
    steps = [(toks, valid)] + [
        (rng.integers(0, cfg_t.vocab_size, (b, 1)).astype(np.int32),
         np.asarray([1, 1], np.int32)) for _ in range(3)]
    for i, (tk, vl) in enumerate(steps):
        lj, cj = jax_decode.forward_cached(params_j, jnp.asarray(tk), cj, cfg_j,
                                           impl_j, valid_lengths=jnp.asarray(vl))
        lt, ct = decode.forward_cached(params_t, torch.from_numpy(tk), ct, cfg_t,
                                       impl_t, valid_lengths=torch.from_numpy(vl))
        lj = np.asarray(lj)
        for r in range(b):   # rows past a slot's valid length are padding
            np.testing.assert_allclose(lt.numpy()[r, :vl[r]], lj[r, :vl[r]],
                                       rtol=0, atol=LOGIT_ATOL, err_msg=f"step {i}")
        np.testing.assert_array_equal(ct.lengths.numpy(), np.asarray(cj.lengths))
    np.testing.assert_allclose(ct.k.float().numpy(),
                               np.asarray(cj.k.astype(jnp.float32)),
                               rtol=0, atol=2e-2)


def test_port_imports_no_jax():
    mods = ["mxmoe_tpu_torch", "mxmoe_tpu_torch.serving.generate",
            "mxmoe_tpu_torch.serving.engine", "mxmoe_tpu_torch.serving.decode",
            "mxmoe_tpu_torch.models.layers", "mxmoe_tpu_torch.models.model",
            "mxmoe_tpu_torch.quant.qparams", "mxmoe_tpu_torch.ops.act_quant",
            "mxmoe_tpu_torch.ops.gmm_w8a8", "mxmoe_tpu_torch.ops.kernels",
            "mxmoe_tpu_torch.params_from_jax", "mxmoe_tpu_torch.utils.device"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'mxmoe_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
