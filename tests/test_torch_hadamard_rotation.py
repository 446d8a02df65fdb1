"""The port's Hadamard constructions and rotations (``quant/hadamard.py``,
``quant/rotation.py``) against the JAX package: the +-1 factors and the
dense matrices bitwise, the transforms within 1e-5 relative in f32, the
rotations given the same Q within 1e-5 of the largest weight, the streamed
rotation equal to the full one, and the rotated model the original one."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mxmoe_tpu.models import configs as jax_configs
from mxmoe_tpu.models import model as jax_model
from mxmoe_tpu.quant import hadamard as jh
from mxmoe_tpu.quant import rotation as jr
from mxmoe_tpu_torch.models import configs, model
from mxmoe_tpu_torch.models.layers import MoEImpl
from mxmoe_tpu_torch.params_from_jax import params_from_jax
from mxmoe_tpu_torch.quant import hadamard as th
from mxmoe_tpu_torch.quant import rotation as tr

REL = 1e-5


def _close(got: torch.Tensor, ref, rel=REL):
    ref = np.asarray(ref, dtype=np.float32)
    g = got.float().numpy()
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(g - ref).max()) <= rel * scale, float(np.abs(g - ref).max()) / scale


@pytest.mark.parametrize("m", [1, 2, 4, 8, 12, 20, 28, 36, 40, 44, 60, 108, 140, 176])
def test_constructed_hadamard_bitwise(m):
    h = th._construct_hadamard(m)
    np.testing.assert_array_equal(h, jh._construct_hadamard(m))
    np.testing.assert_array_equal(h @ h.T, m * np.eye(m, dtype=np.int64))


@pytest.mark.parametrize("n", [2048, 1408, 2560, 14336, 3584, 5632, 64])
def test_get_had_factor_and_dense_matrix_bitwise(n):
    hk, k = th.get_had_factor(n)
    rk, rk_k = jh.get_had_factor(n)
    assert k == rk_k
    if k > 1:
        np.testing.assert_array_equal(hk, rk)
    if n <= 3584:
        for normalized in (True, False):
            got = th.hadamard_matrix(n, normalized=normalized)
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jh.hadamard_matrix(n, normalized=normalized)))


@pytest.mark.parametrize("n", [64, 128, 1408, 2560])
def test_fwht_and_matmul_hadU_vs_jax(n):
    x = np.random.default_rng(n).standard_normal((6, n)).astype(np.float32)
    if n & (n - 1) == 0:
        _close(th.fwht(torch.from_numpy(x)), jh.fwht(jnp.asarray(x)))
        _close(th.fwht(torch.from_numpy(x.T.copy()), axis=0),
               jh.fwht(jnp.asarray(x.T.copy()), axis=0))
    for normalize in (True, False):
        _close(th.matmul_hadU(torch.from_numpy(x), normalize),
               jh.matmul_hadU(jnp.asarray(x), normalize))
    # x @ H^T with the dense matrix, and norm preserving
    y = th.matmul_hadU(torch.from_numpy(x)).double()
    dense = torch.from_numpy(x).double() @ th.hadamard_matrix(n, torch.float64).T
    assert float((y - dense).abs().max()) <= 1e-4 * float(dense.abs().max())
    torch.testing.assert_close(y.norm(dim=-1), torch.from_numpy(x).double().norm(dim=-1),
                               rtol=1e-5, atol=0)
    assert th.matmul_hadU(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16


def _jax_signs(n, key):
    """The reference's +-1 vector: Q = diag(signs) @ H, so signs are Q's
    first column over H's."""
    q = np.asarray(jh.random_hadamard_matrix(n, key), np.float64)
    h = np.asarray(jh.hadamard_matrix(n), np.float64)
    return torch.from_numpy(np.sign(q[:, 0] / h[:, 0]).astype(np.float32))


@pytest.mark.parametrize("n", [64, 1408])
def test_random_hadamard_given_the_signs_is_the_reference(n):
    key = jax.random.PRNGKey(7)
    signs = _jax_signs(n, key)
    got = th.random_hadamard_matrix(n, signs=signs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jh.random_hadamard_matrix(n, key)))
    q = th.random_hadamard_matrix(n, torch.Generator().manual_seed(0)).double()
    torch.testing.assert_close(q @ q.T, torch.eye(n, dtype=torch.float64), atol=1e-5, rtol=0)
    assert set(th.random_signs(n, torch.Generator().manual_seed(1)).tolist()) <= {-1.0, 1.0}


def _setup(kind, seed):
    """Tiny float32 params (JAX-initialized, shared through params_from_jax)
    with non-trivial norm weights, and tokens."""
    mk_j = {"qwen2_moe": jax_configs.tiny_qwen2_moe, "ds2": jax_configs.tiny_ds2}[kind]
    mk_t = {"qwen2_moe": configs.tiny_qwen2_moe, "ds2": configs.tiny_ds2}[kind]
    layers = 3 if kind == "ds2" else 2
    cfg_j, cfg_t = mk_j(num_experts=4, num_layers=layers), mk_t(num_experts=4,
                                                               num_layers=layers)
    params = jax_model.init_params(cfg_j, jax.random.PRNGKey(seed), dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(seed)
    for sub in ("layers", "dense_layers"):
        if sub in params:
            for nm in ("input_norm", "post_attn_norm"):
                v = params[sub][nm]
                params[sub][nm] = (1.0 + 0.3 * rng.standard_normal(v.shape)).astype(np.float32)
    params["final_norm"] = (1.0 + 0.3 * rng.standard_normal(
        params["final_norm"].shape)).astype(np.float32)
    toks = rng.integers(0, cfg_t.vocab_size, size=(2, 12))
    return cfg_j, cfg_t, params, toks


def _close_tree(got, ref, rel=REL):
    for k, r in ref.items():
        if isinstance(r, dict):
            _close_tree(got[k], r, rel)
        else:
            _close(got[k], r, rel)


@pytest.mark.parametrize("kind", ["qwen2_moe", "ds2"])
def test_fuse_and_rotate_vs_jax_and_invariance(kind):
    cfg_j, cfg_t, params, toks = _setup(kind, 2)
    key = jax.random.PRNGKey(7)
    q = torch.from_numpy(np.array(jh.random_hadamard_matrix(cfg_t.hidden_size, key)))
    pt = params_from_jax(params, "cpu")
    fused = tr.fuse_layer_norms(pt)
    _close_tree(fused, jr.fuse_layer_norms(jax.tree_util.tree_map(jnp.asarray, params)))
    rot = tr.rotate_model_hadamard(params_from_jax(params, "cpu"), cfg_t, q=q)
    ref = jr.rotate_model_hadamard(jax.tree_util.tree_map(jnp.asarray, params), cfg_j, key)
    _close_tree(rot, ref)
    # contiguous, as the kernels take their operands (K11 on the rotated experts)
    assert all(v.is_contiguous() for sub in ("layers", "dense_layers") if sub in rot
               for v in rot[sub].values())
    assert tr.rotate_down_weights(pt["layers"]["expert_down"]).is_contiguous()
    # the rotated (and the fused) model is the original one
    impl = MoEImpl(kind="dense")
    want = model.forward_logits(pt, torch.from_numpy(toks), cfg_t, impl)
    for p, tol in ((fused, 2e-4), (rot, 2e-3)):
        got = model.forward_logits(p, torch.from_numpy(toks), cfg_t, impl)
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert float((rot["layers"]["wq"] - pt["layers"]["wq"]).abs().max()) > 1e-3


@pytest.mark.parametrize("kind", ["qwen2_moe", "ds2"])
def test_streamed_rotation_equals_full(kind):
    cfg_j, cfg_t, params, _ = _setup(kind, 3)
    q = th.random_hadamard_matrix(cfg_t.hidden_size, torch.Generator().manual_seed(4))
    full = tr.rotate_model_hadamard(params_from_jax(params, "cpu"), cfg_t, q=q)
    host = params_from_jax(params, "cpu")
    stream = tr.rotate_model_hadamard_host(host, cfg_t, q=q, device="cpu")
    assert stream["layers"] is host["layers"]             # in place, layer by layer
    _close_tree(stream, {k: (v if isinstance(v, dict) else v.numpy())
                         for k, v in full.items()} | {
        sub: {k: v.numpy() for k, v in full[sub].items()}
        for sub in ("layers", "dense_layers") if sub in full}, rel=2e-6)
    # and the reference's streamed form, same Q
    ref = jr.rotate_model_hadamard_host(
        jax.tree_util.tree_map(np.array, params), cfg_j, jax.random.PRNGKey(0))
    got = tr.rotate_model_hadamard_host(
        params_from_jax(params, "cpu"), cfg_t, device="cpu",
        q=th.random_hadamard_matrix(cfg_t.hidden_size,
                                    signs=_jax_signs(cfg_t.hidden_size,
                                                     jax.random.PRNGKey(0))))
    _close_tree(got, ref)


def test_streamed_rotation_keeps_the_storage_dtype():
    cfg_j, cfg_t, params, _ = _setup("qwen2_moe", 5)
    host = {k: (v.to(torch.bfloat16) if not isinstance(v, dict)
                else {kk: vv.to(torch.bfloat16) for kk, vv in v.items()})
            for k, v in params_from_jax(params, "cpu").items()}
    got = tr.rotate_model_hadamard_host(host, cfg_t, torch.Generator().manual_seed(0),
                                        device="cpu")
    for v in [got["embed"], got["lm_head"], got["final_norm"], *got["layers"].values()]:
        assert v.dtype == torch.bfloat16
    ref = jr.rotate_model_hadamard_host(
        jax.tree_util.tree_map(lambda a: np.array(a).astype(ml_dtypes.bfloat16), params),
        cfg_j, jax.random.PRNGKey(0))
    assert all(v.dtype == ml_dtypes.bfloat16 for v in jax.tree_util.tree_leaves(ref))


def test_online_hadamard_down_vs_jax_and_equivalence():
    rng = np.random.default_rng(3)
    h_act = rng.standard_normal((10, 48)).astype(np.float32)
    w = rng.standard_normal((2, 48, 32)).astype(np.float32)
    got_w = tr.rotate_down_weights(torch.from_numpy(w))
    _close(got_w, jr.rotate_down_weights(jnp.asarray(w)))
    _close(tr.online_hadamard_down(torch.from_numpy(h_act)),
           jr.online_hadamard_down(jnp.asarray(h_act)))
    # (h H) @ (H^T W) == h @ W, 3-D and 4-D stacks
    got = tr.online_hadamard_down(torch.from_numpy(h_act)) @ got_w[0]
    torch.testing.assert_close(got, torch.from_numpy(h_act @ w[0]), rtol=1e-4, atol=1e-4)
    w4 = torch.from_numpy(rng.standard_normal((1, 3, 48, 16)).astype(np.float32))
    torch.testing.assert_close(tr.rotate_down_weights(w4)[0, 1],
                               tr.rotate_down_weights(w4[0])[1], rtol=0, atol=0)
