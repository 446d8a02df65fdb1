"""Port parity for the accuracy anchor (``mxmoe_tpu_torch.eval.anchor``)
against the JAX package's ``mxmoe_tpu.eval.anchor``, and the cached decode
step at head dims inside and outside K3 / K3q's domain.

Tolerances: the loss rel 1e-5 and its gradients rtol 1e-4 / atol 1e-6 of
``jax.grad`` (f32, sums in other orders); the learning rate optax's at every
step within 1e-7 (both evaluate the same closed form in float64 / float32);
three AdamW steps within rtol 1e-4 / atol 1e-5 of optax's adamw. The decode
step's logits within 2e-3 of JAX's, as the MLA slice's bf16-cache bound."""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mxmoe_tpu.eval import anchor as jax_anchor
from mxmoe_tpu.models import configs as jax_configs
from mxmoe_tpu.models import model as jax_model
from mxmoe_tpu.models.layers import MoEImpl as JaxMoEImpl
from mxmoe_tpu.serving import decode as jax_decode
from mxmoe_tpu.serving import kv_cache as jax_kv
from mxmoe_tpu_torch.eval import anchor
from mxmoe_tpu_torch.models import configs
from mxmoe_tpu_torch.models.layers import MoEImpl
from mxmoe_tpu_torch.params_from_jax import params_from_jax
from mxmoe_tpu_torch.serving import decode, decode_attention, kv_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_anchor_config_equals_the_reference():
    assert (dataclasses.asdict(anchor.anchor_config())
            == dataclasses.asdict(jax_anchor.anchor_config()))
    assert (dataclasses.asdict(anchor.anchor_config(512))
            == dataclasses.asdict(jax_anchor.anchor_config(512)))


def _tiny(seed):
    cfg_j = jax_configs.tiny_qwen2_moe(num_experts=4, num_layers=2)
    cfg_t = configs.tiny_qwen2_moe(num_experts=4, num_layers=2)
    params_j = jax_model.init_params(cfg_j, jax.random.PRNGKey(seed), dtype=jnp.float32)
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), "cpu")
    return cfg_j, cfg_t, params_j, params_t


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(cfg_j):
    """JAX's loss and gradients, compiled once for the tests' shapes."""
    return jax.jit(jax.value_and_grad(lambda p, t: jax_anchor._loss_fn(
        p, t, cfg_j, JaxMoEImpl(kind="dense"))))


def _batch(cfg, seed, b=2, s=16):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def test_loss_and_gradients_vs_jax():
    cfg_j, cfg_t, params_j, params_t = _tiny(0)
    toks = _batch(cfg_t, 1)
    loss_j, grads_j = _jax_value_and_grad(cfg_j)(params_j, jnp.asarray(toks))
    for t in anchor._leaves(params_t):
        t.requires_grad_(True)
    loss_t = anchor._loss_fn(params_t, torch.from_numpy(toks), cfg_t, MoEImpl(kind="dense"))
    loss_t.backward()
    assert abs(float(loss_t.detach()) - float(loss_j)) / float(loss_j) < 1e-5
    gj, pt = _flat(grads_j), _flat(params_t)
    assert set(gj) == set(pt)
    for name, g in gj.items():
        np.testing.assert_allclose(pt[name].grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("steps", [10, 1200])
def test_lr_schedule_equals_optax(steps):
    lr = 3e-3
    warmup = min(100, max(1, steps // 10))
    ref = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps, lr * 0.05)
    w = torch.zeros(1, requires_grad=True)
    w.grad = torch.zeros(1)
    opt, sched = anchor.make_optimizer({"w": w}, lr, warmup, steps)
    for i in range(steps + 3):
        want = float(ref(i))
        assert abs(anchor.warmup_cosine_lr(i, lr, warmup, steps) - want) <= 1e-7
        assert abs(opt.param_groups[0]["lr"] - want) <= 1e-7, i
        opt.step()
        sched.step()


def test_three_adamw_steps_vs_optax():
    """Three steps from the same params and batches. The optimizer is held
    on identical gradients (JAX's, each step): after three steps the params
    within rtol 1e-4 / atol 1e-5 of optax's adamw. Trained on its own
    autograd gradients, the port's loss on a fourth batch is within rel 1e-5
    of JAX's (per-leaf params are not compared there: the k bias's gradients
    are ~1e-7, where f32 noise of ~1e-9 moves Adam's normalized update by a
    few percent)."""
    cfg_j, cfg_t, params_j, params_t = _tiny(2)
    lr, warmup, steps = 3e-3, 2, 10
    batches = [_batch(cfg_t, 10 + i) for i in range(4)]
    impl_j, impl_t = JaxMoEImpl(kind="dense"), MoEImpl(kind="dense")

    opt_j = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps,
                                                           lr * 0.05),
                        weight_decay=0.01)
    state = opt_j.init(params_j)
    fed = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), "cpu")
    own = params_t
    for tree in (fed, own):
        for t in anchor._leaves(tree):
            t.requires_grad_(True)
    (opt_f, sched_f), (opt_o, sched_o) = (anchor.make_optimizer(tree, lr, warmup, steps)
                                          for tree in (fed, own))
    for toks in batches[:3]:
        _, grads = _jax_value_and_grad(cfg_j)(params_j, jnp.asarray(toks))
        upd, state = opt_j.update(grads, state, params_j)
        params_j = optax.apply_updates(params_j, upd)
        gflat, fflat = _flat(grads), _flat(fed)
        for name, g in gflat.items():
            fflat[name].grad = torch.from_numpy(np.array(g))
        opt_f.step()
        sched_f.step()
        loss = anchor._loss_fn(own, torch.from_numpy(toks), cfg_t, impl_t)
        opt_o.zero_grad(set_to_none=True)
        loss.backward()
        opt_o.step()
        sched_o.step()
    pj, pf = _flat(params_j), _flat(fed)
    for name, v in pj.items():
        np.testing.assert_allclose(pf[name].detach().numpy(), np.asarray(v), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    with torch.no_grad():
        loss_t = float(anchor._loss_fn(own, torch.from_numpy(batches[3]), cfg_t, impl_t))
    loss_j = float(jax_anchor._loss_fn(params_j, jnp.asarray(batches[3]), cfg_j, impl_j))
    assert abs(loss_t - loss_j) / loss_j < 1e-5, (loss_t, loss_j)


# the reference's result keys for methods=("rtn",) at 5 bits
ANCHOR_KEYS = {"train_loss", "steps", "config", "corpus", "ppl_fp", "ppl_unigram_floor",
               "ppl_w8a8_rtn", "ppl_w4a4_rtn", "ppl_w4a4_rtn_mseclip", "ppl_mixed_w5_rtn",
               "ppl_realexec_w8a8", "ppl_realexec_w4a4", "ppl_realexec_mixed_w5",
               "ppl_realexec_decode_mixed_w5"}


@pytest.fixture
def one_thread():
    """One intra-op thread for the test's many small ops: 2.6x less CPU time
    than the default (all cores), which the parallel test run shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_run_anchor_writes_under_out_only(tmp_path, capsys, one_thread):
    root_files = set(os.listdir(REPO))
    with open(os.path.join(REPO, "ACCURACY.md"), "rb") as f:
        accuracy = f.read()
    out = tmp_path / "anchor"
    res = anchor.run_anchor(steps=2, out_dir=str(out), methods=("rtn",),
                            eval_windows=2, seqlen=32, device="cpu")
    assert ANCHOR_KEYS <= set(res) and set(res) - ANCHOR_KEYS == {"train_seconds"}
    assert json.loads((out / "results.json").read_text()) == res
    assert "serving decode + int8 KV + int8 head" in (out / "ACCURACY.md").read_text()
    assert (out / "anchor_rtn_mixed.json").exists() and (out / "moe-gate.json").exists()
    assert all(np.isfinite(v) for k, v in res.items() if k.startswith("ppl_"))
    # the real rows through the kernels' plain versions track the fake rows
    assert abs(res["ppl_realexec_w8a8"] - res["ppl_w8a8_rtn"]) / res["ppl_w8a8_rtn"] < 5e-3
    assert set(os.listdir(REPO)) == root_files
    with open(os.path.join(REPO, "ACCURACY.md"), "rb") as f:
        assert f.read() == accuracy
    # a second run reads the trained weights back from the cache
    capsys.readouterr()
    again = anchor.run_anchor(steps=2, out_dir=str(out), methods=(), eval_windows=2,
                              seqlen=32, write_md=False, device="cpu")
    assert "loaded_params" in capsys.readouterr().out
    # the same weights (rel 1e-6: the reloaded tensors may take other CPU
    # matmul paths, a few f32 ulps of the logits)
    assert again["train_loss"] == res["train_loss"]
    assert abs(again["ppl_fp"] - res["ppl_fp"]) / res["ppl_fp"] < 1e-6


@pytest.mark.parametrize("dk, dv, quant, ok", [
    (16, 16, False, False), (24, 24, False, False), (32, 32, False, True),
    (32, 32, True, True), (64, 64, True, True), (128, 128, True, True),
    (256, 128, True, True), (256, 192, False, False), (128, 40, False, True),
    (128, 40, True, False), (512, 128, False, False)])
def test_supports_fused_decode(dk, dv, quant, ok):
    assert decode_attention.supports_fused_decode(dk, dv, quant) is ok


@pytest.mark.parametrize("head_dim, int8_kv", [(16, False), (16, True), (32, True)])
def test_decode_step_path_by_head_dim(monkeypatch, head_dim, int8_kv):
    """Every decode step goes through ``decode_attention_update_stacked``,
    whose plain version takes any head dim on the CPU (on the card a head dim
    outside K3 / K3q's domain raises: ``test_torch_cuda_kernels.py``); 16 and
    32 (the anchor's) match JAX's logits."""
    cfg_j = dataclasses.replace(jax_configs.tiny_qwen2_moe(4, 2), head_dim=head_dim)
    cfg_t = dataclasses.replace(configs.tiny_qwen2_moe(4, 2), head_dim=head_dim)
    params_j = jax_model.init_params(cfg_j, jax.random.PRNGKey(5), dtype=jnp.float32)
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), "cpu")
    calls = []
    real = decode.decode_attention_update_stacked

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(decode, "decode_attention_update_stacked", spy)
    b, s = 2, 32
    if int8_kv:
        cj, ct = (jax_kv.init_quant_kv_cache(cfg_j, b, s),
                  kv_cache.init_quant_kv_cache(cfg_t, b, s, device="cpu"))
    else:
        cj, ct = (jax_kv.init_kv_cache(cfg_j, b, s),
                  kv_cache.init_kv_cache(cfg_t, b, s, device="cpu"))
    toks = _batch(cfg_t, 6, b, 8)
    impl_j = JaxMoEImpl(interpret=True)
    for i in range(toks.shape[1]):
        step = toks[:, i:i + 1] if i else toks[:, :4]
        if 0 < i < 4:
            continue
        lj, cj = jax_decode.forward_cached(params_j, jnp.asarray(step), cj, cfg_j, impl_j)
        lt, ct = decode.forward_cached(params_t, torch.from_numpy(step), ct, cfg_t,
                                       MoEImpl())
        np.testing.assert_allclose(lt.float().numpy(), np.asarray(lj, np.float32),
                                   rtol=0, atol=2e-2 if int8_kv else 2e-3,
                                   err_msg=f"step {i}")
    # 4 decode steps, one call a layer each
    assert len(calls) == 4 * cfg_t.num_layers
