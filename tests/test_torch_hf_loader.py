"""The port's HF loader (``models/hf_loader.py``) and checkpoint writer
(``models/synth_ckpt.py``) against the JAX package: the same shards give the
same params leaf for leaf (f32 and bf16 leaves, bitwise), a live
``transformers`` model gives the same params and the port's forward matches
its logits."""

import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mxmoe_tpu.models import configs as jax_configs
from mxmoe_tpu.models import hf_loader as jax_loader
from mxmoe_tpu_torch.models import configs, hf_loader, synth_ckpt
from mxmoe_tpu_torch.models.layers import MoEImpl
from mxmoe_tpu_torch.models.model import forward_logits
from mxmoe_tpu_torch.utils.safetensors_io import ShardedDir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = {"qwen2_moe": (configs.tiny_qwen2_moe, jax_configs.tiny_qwen2_moe, 4, 2),
          "mixtral": (configs.tiny_mixtral, jax_configs.tiny_mixtral, 4, 2),
          "ds2": (configs.tiny_ds2, jax_configs.tiny_ds2, 4, 3)}
SHARD_DTYPES = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16}


def _cfgs(name):
    mk_t, mk_j, e, layers = MODELS[name]
    return mk_t(num_experts=e, num_layers=layers), mk_j(num_experts=e, num_layers=layers)


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.contiguous().numpy()


def _assert_same_tree(got: dict, ref: dict, path=""):
    assert sorted(got) == sorted(ref), path
    for k, r in ref.items():
        if isinstance(r, dict):
            _assert_same_tree(got[k], r, f"{path}{k}.")
            continue
        g = _np(got[k])
        r = np.asarray(r)
        assert g.dtype == r.dtype and g.shape == r.shape, (path + k, g.dtype, r.dtype)
        # bit patterns: bf16 and f32 leaves bitwise
        np.testing.assert_array_equal(g.view(np.uint8), np.ascontiguousarray(r).view(np.uint8),
                                      err_msg=path + k)


@pytest.mark.parametrize("shard", list(SHARD_DTYPES))
@pytest.mark.parametrize("name", list(MODELS))
def test_params_from_safetensors_vs_jax(tmp_path, name, shard):
    """Shards in f32 / f16 / bf16, loaded as f32 and as bf16. The JAX loader
    reads shards through numpy, which has no bf16: bf16 shards are held
    against its ``params_from_state_dict`` on the same values."""
    cfg_t, cfg_j = _cfgs(name)
    ckpt = str(tmp_path / "hf")
    synth_ckpt.make_checkpoint(cfg_t, ckpt, seed=3, dtype=SHARD_DTYPES[shard])
    sd = ShardedDir(ckpt)
    sd_np = {k: _np(sd[k]) for k in sd}
    for dtype_t, dtype_j in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = hf_loader.params_from_safetensors(ckpt, cfg_t, dtype=dtype_t)
        if shard == "bf16":
            ref = jax_loader.params_from_state_dict(sd_np, cfg_j, dtype_j, as_numpy=True)
        else:
            ref = jax_loader.params_from_safetensors(ckpt, cfg_j, dtype=dtype_j,
                                                     as_numpy=True)
        _assert_same_tree(got, ref)
        if dtype_t == torch.bfloat16 and shard == "bf16":
            # bf16 stays bf16 from the file: no widened copy
            assert got["layers"]["expert_gate_up"].dtype == torch.bfloat16


def test_missing_lm_head_is_the_embedding(tmp_path):
    cfg_t, cfg_j = _cfgs("qwen2_moe")
    synth_ckpt.make_checkpoint(cfg_t, str(tmp_path), seed=1, dtype=torch.float32)
    sd = {k: v for k, v in ShardedDir(str(tmp_path)).items() if k != "lm_head.weight"}
    got = hf_loader.params_from_state_dict(sd, cfg_t)
    ref = jax_loader.params_from_state_dict({k: v.numpy() for k, v in sd.items()},
                                            cfg_j, jnp.float32, as_numpy=True)
    assert torch.equal(got["lm_head"], got["embed"].T)
    _assert_same_tree(got, ref)


@pytest.mark.parametrize("name", ["qwen2_moe", "ds2"])
def test_synth_ckpt_f16_is_the_tool_bitwise(tmp_path, name):
    """``synth_ckpt`` draws the values of ``tools/make_synth_ckpt.py`` in its
    order: with f16 shards, every tensor bitwise (the shard split too)."""
    spec = importlib.util.spec_from_file_location(
        "make_synth_ckpt", os.path.join(ROOT, "tools", "make_synth_ckpt.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    cfg_t, cfg_j = _cfgs(name)
    (tool.make_ds2_like if name == "ds2" else tool.make_qwen2_moe_like)(
        cfg_j, str(tmp_path / "tool"), seed=5)
    nbytes = synth_ckpt.make_checkpoint(cfg_t, str(tmp_path / "port"), seed=5,
                                        dtype=torch.float16)
    tool_files = sorted(os.listdir(tmp_path / "tool"))
    port_files = sorted(os.listdir(tmp_path / "port"))
    assert tool_files == port_files
    assert nbytes == sum(os.path.getsize(tmp_path / "port" / f) for f in port_files)
    a, b = ShardedDir(str(tmp_path / "tool")), ShardedDir(str(tmp_path / "port"))
    assert sorted(a) == sorted(b)
    for k in a:
        assert os.path.basename(a.index[k].path) == os.path.basename(b.index[k].path)
        assert torch.equal(a[k], b[k]), k


def _hf_model(name, cfg):
    pytest.importorskip("transformers")
    if name == "qwen2_moe":
        from transformers import Qwen2MoeConfig, Qwen2MoeForCausalLM

        hf_cfg = Qwen2MoeConfig(
            vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
            intermediate_size=cfg.hidden_size * 2, num_hidden_layers=cfg.num_layers,
            num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, moe_intermediate_size=cfg.moe_intermediate_size,
            shared_expert_intermediate_size=cfg.shared_expert_intermediate_size,
            num_experts=cfg.num_experts, num_experts_per_tok=cfg.top_k,
            norm_topk_prob=cfg.norm_topk_prob, decoder_sparse_step=1,
            rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_norm_eps,
            tie_word_embeddings=False, attention_dropout=0.0)
        cls = Qwen2MoeForCausalLM
    else:
        from transformers import MixtralConfig, MixtralForCausalLM

        hf_cfg = MixtralConfig(
            vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
            intermediate_size=cfg.moe_intermediate_size,
            num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
            num_key_value_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            num_local_experts=cfg.num_experts, num_experts_per_tok=cfg.top_k,
            rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_norm_eps,
            tie_word_embeddings=False, attention_dropout=0.0)
        cls = MixtralForCausalLM
    torch.manual_seed(0)
    with torch.no_grad():
        return cls(hf_cfg).eval()


@pytest.mark.parametrize("name", ["qwen2_moe", "mixtral"])
def test_params_from_torch_model_and_forward_vs_hf(name):
    """A tiny ``transformers`` model built from its config: the port's params
    bitwise the JAX package's, and the port's logits (dense and ragged)
    within the reference parity test's 2e-3 of the HF logits."""
    cfg_t, cfg_j = _cfgs(name)
    cfg_t = dataclasses.replace(cfg_t, num_experts=8 if name == "qwen2_moe" else 4)
    cfg_j = dataclasses.replace(cfg_j, num_experts=cfg_t.num_experts)
    hf = _hf_model(name, cfg_t)
    got = hf_loader.params_from_torch_model(hf, cfg_t)
    ref = jax_loader.params_from_torch_model(hf, cfg_j, dtype=jnp.float32)
    _assert_same_tree(got, {k: (v if isinstance(v, dict) else np.asarray(v))
                            for k, v in ref.items()} | {
        "layers": {k: np.asarray(v) for k, v in ref["layers"].items()}})
    tokens = np.random.default_rng(0).integers(0, cfg_t.vocab_size, size=(2, 12))
    with torch.no_grad():
        want = hf(torch.tensor(tokens)).logits.float()
        for kind in ("dense", "ragged"):
            logits = forward_logits(got, torch.tensor(tokens), cfg_t, MoEImpl(kind=kind))
            torch.testing.assert_close(logits, want, rtol=2e-3, atol=2e-3)
