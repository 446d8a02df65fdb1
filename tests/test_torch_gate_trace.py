"""Port parity for gate and activation tracing (``mxmoe_tpu_torch.trace.gate``)
against the JAX package on the CPU: tiny qwen2_moe (4 experts, 2 layers) and
tiny ds2 (the dense first layer runs before the traced MoE layers), one
numpy-seeded JAX init carried over by ``params_from_jax``.

``access_freq`` must equal the JAX package's, or differ only where a token's
k-th and (k+1)-th router logits lie within 1e-5 of each other (float32 sums
in another order may then pick the other expert). ``weights_sum`` within
1e-5 relative; the dumped ``moe-gate.json`` has the reference's keys, and
loads back. The activation statistics within 1e-5 relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.models import configs as jax_configs
from mxmoe_tpu.models import model as jax_model
from mxmoe_tpu.trace import gate as jax_gate
from mxmoe_tpu_torch.models import configs
from mxmoe_tpu_torch.params_from_jax import params_from_jax
from mxmoe_tpu_torch.trace import gate

MARGIN = 1e-5


def _setup(name, seed):
    cfg_j = getattr(jax_configs, name)(num_experts=4)
    cfg_t = getattr(configs, name)(num_experts=4)
    pj = jax_model.init_params(cfg_j, jax.random.PRNGKey(seed), dtype=jnp.float32)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    toks = np.random.default_rng(seed).integers(0, cfg_t.vocab_size, (3, 32)).astype(np.int32)
    return cfg_j, cfg_t, pj, pt, toks


def _near_ties(pt, toks, cfg) -> np.ndarray:
    """[L] tokens whose top-k boundary margin is below MARGIN."""
    x, cos, sin = gate._embed_and_dense(pt, torch.from_numpy(toks), cfg, "cpu")
    out = []
    for l, lp, x2d in gate._moe_layers(pt, x, cos, sin, cfg, "ragged_dot", "cpu"):
        s = torch.sort(x2d @ lp["router"], dim=-1, descending=True).values
        out.append(int((s[:, cfg.top_k - 1] - s[:, cfg.top_k] < MARGIN).sum()))
    return np.array(out)


@pytest.mark.parametrize("name", ["tiny_qwen2_moe", "tiny_ds2"])
def test_trace_gate_stats_match_jax(name, tmp_path):
    cfg_j, cfg_t, pj, pt, toks = _setup(name, 3)
    want = jax_gate.trace_gate_stats(pj, jnp.asarray(toks), cfg_j)
    got = gate.trace_gate_stats(pt, torch.from_numpy(toks), cfg_t, device="cpu")
    ties = _near_ties(pt, toks, cfg_t)
    d = np.abs(got.access_freq - want.access_freq).sum(axis=1)
    assert (d <= 2 * ties).all(), (d, ties)
    assert (got.access_freq.sum(axis=1) == toks.size * cfg_t.top_k).all()
    if not ties.any():
        np.testing.assert_array_equal(got.access_freq, want.access_freq)
        np.testing.assert_allclose(got.weights_sum, want.weights_sum, rtol=1e-5)
    for f in ("num_tokens", "num_samples", "topk", "nk", "num_shared_experts",
              "first_dense_layers", "dense_nk"):
        assert getattr(got, f) == getattr(want, f), f
    # the dumped JSON: the reference's schema, and the load round trip
    jax_gate.dump_gate_trace(want, str(tmp_path / "jax.json"))
    gate.dump_gate_trace(got, str(tmp_path / "torch" / "moe-gate.json"))
    a = jax_gate.load_gate_trace(str(tmp_path / "jax.json"))
    b = gate.load_gate_trace(str(tmp_path / "torch" / "moe-gate.json"))
    assert sorted(a) == sorted(b)
    assert sorted(a["layer-0"]) == sorted(b["layer-0"])
    assert sorted(a["layer-0"]["percentile_stats"]) == sorted(b["layer-0"]["percentile_stats"])
    for k in ("topk", "NK", "num_layers", "num_tokens", "num_samples",
              "num_shared_experts"):
        assert a[k] == b[k], k
    assert b["layer-1"]["access_freq"] == got.access_freq[1].tolist()
    if cfg_t.first_dense_layers:
        assert b["first_dense_layers"] == 1 and b["dense_NK"] == a["dense_NK"]


def test_trace_activation_stats_match_jax():
    cfg_j, cfg_t, pj, pt, toks = _setup("tiny_qwen2_moe", 4)
    want = jax_gate.trace_activation_stats(pj, jnp.asarray(toks), cfg_j)
    got = gate.trace_activation_stats(pt, torch.from_numpy(toks), cfg_t, device="cpu")
    for f in ("amax", "channel_amax", "percentiles"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    assert got.qs == want.qs


def test_percentiles_are_numpys_linear_ones():
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(1001).astype(np.float32))
    qs = (0.0, 12.5, 50.0, 99.9, 100.0)
    np.testing.assert_allclose(gate._percentiles(a, qs).numpy(),
                               np.percentile(a.numpy(), qs), rtol=1e-6)


def test_plots_say_whether_they_drew(tmp_path):
    tr = gate.GateTrace(access_freq=np.ones((2, 4), np.int64),
                        weights_sum=np.ones((2, 4)), num_tokens=2, num_samples=1,
                        topk=2, nk=(32, 64), num_shared_experts=0)
    try:
        import matplotlib  # noqa: F401
        have = True
    except ImportError:
        have = False
    assert gate.plot_gate_heatmap(tr, str(tmp_path / "h.png")) == have
    act = gate.ActivationTrace(amax=np.ones(2), channel_amax=np.ones((2, 8)),
                               percentiles=np.ones((2, 5)))
    assert gate.plot_activation_outliers(act, str(tmp_path / "a.png")) == have
    assert dataclasses.asdict(tr)["topk"] == 2
