"""Port parity for the calibration losses (``mxmoe_tpu_torch.quant.calibrate``:
``moe_calib_errors``, ``dense_calib_errors``, ``calibrate_model`` by rtn,
gptq, rtn-had and gptq-had, ``model_out_norm_errors``, the per-layer JSON
checkpoints and ``resume``) against the JAX package's on the CPU, for tiny
qwen2_moe (4 experts, 2 layers) and tiny ds2 (its dense first layer as the
``dense-0`` pseudo-layer), from one numpy-seeded JAX init carried over by
``params_from_jax``; and against a per-expert brute-force oracle.

Bound: float32 weights; each loss entry within 1e-3 of its layer's largest
entry (the sums run in another order). The GPTQ cases calibrate on 256
tokens, so that each expert's Hessian has more rows than K: with fewer, the
damped Hessian is ill-conditioned and the two packages' float32 orders move
whole groups of codes apart. The '-had' methods
take the JAX package's Hadamard signs (``random_hadamard_matrix`` of
``PRNGKey(0)``, the matrix its layer-streamed calibration draws)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.models import configs as jax_configs
from mxmoe_tpu.models import model as jax_model
from mxmoe_tpu.quant import calibrate as jax_cal
from mxmoe_tpu.quant.hadamard import random_hadamard_matrix as jax_rhm
from mxmoe_tpu_torch.models import configs
from mxmoe_tpu_torch.ops.dispatch import route_topk
from mxmoe_tpu_torch.params_from_jax import params_from_jax
from mxmoe_tpu_torch.quant import calibrate
from mxmoe_tpu_torch.quant.rtn import fake_quant
from mxmoe_tpu_torch.quant.schemes import parse_scheme

REL = 1e-3
SCHEMES = ("w4a4_g-1_sym", "w4a16_g16_asym")


def _model(name, seed):
    cfg_j = getattr(jax_configs, name)(num_experts=4)
    cfg_t = getattr(configs, name)(num_experts=4)
    pj = jax_model.init_params(cfg_j, jax.random.PRNGKey(seed), dtype=jnp.float32)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    return cfg_j, cfg_t, pj, pt


def _tokens(cfg, seed=3, b=2, s=24):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _assert_layer_close(got: dict, want: dict):
    assert set(got) == set(want)
    for layer in want:
        assert set(got[layer]) == set(want[layer])
        w = np.array([want[layer][e] for e in sorted(want[layer])])
        g = np.array([got[layer][e] for e in sorted(want[layer])])
        assert w.shape == g.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=REL * np.abs(w).max(),
                                   err_msg=f"layer {layer}")


@pytest.fixture(scope="module")
def qwen():
    return _model("tiny_qwen2_moe", 0)


def _x2d(cfg, seed=1, t=48):
    return np.random.default_rng(seed).standard_normal((t, cfg.hidden_size)).astype(np.float32)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_moe_calib_errors_match_jax(qwen, scheme):
    cfg_j, cfg_t, pj, pt = qwen
    x = _x2d(cfg_t)
    lpj = {k: v[0] for k, v in pj["layers"].items()}
    lpt = {k: v[0] for k, v in pt["layers"].items()}
    qc = parse_scheme(scheme)
    from mxmoe_tpu.quant.schemes import parse_scheme as jparse

    want = np.asarray(jax_cal.moe_calib_errors(jnp.asarray(x), lpj, cfg_j, jparse(scheme)))
    got = calibrate.moe_calib_errors(torch.from_numpy(x), lpt, cfg_t, qc).numpy()
    assert got.shape == want.shape == (cfg_t.num_experts + 1, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())
    # one linear at a time gives the same columns
    for i, lin in enumerate(("gate", "up", "down")):
        one = calibrate.moe_calib_errors(torch.from_numpy(x), lpt, cfg_t, qc, only=lin)
        np.testing.assert_allclose(one.numpy()[:, 0], got[:, i], rtol=1e-6, atol=0)


def _moe_out_dense(x, lp, cfg, qc=None, target=None):
    """The routed experts' output, every expert on every token; ``target``
    (expert, linear) fake-quantized, weights and that linear's input."""
    n = cfg.moe_intermediate_size
    wg, wu = lp["expert_gate_up"][..., :n], lp["expert_gate_up"][..., n:]
    wd = lp["expert_down"]
    routing = route_topk(x @ lp["router"], cfg.top_k, cfg.norm_topk_prob,
                         cfg.routed_scaling_factor)

    def fq_w(w):
        return fake_quant(w.T, qc.w_bits, qc.w_gsize, qc.w_sym, qc.w_clip).T

    def fq_a(a):
        return a if qc.a_bits >= 16 else fake_quant(a, qc.a_bits, qc.a_gsize, qc.a_sym)

    outs = []
    for e in range(cfg.num_experts):
        g_w, u_w, d_w, xg, xu = wg[e], wu[e], wd[e], x, x
        hit = target is not None and target[0] == e
        if hit and target[1] == "gate":
            g_w, xg = fq_w(g_w), fq_a(x)
        if hit and target[1] == "up":
            u_w, xu = fq_w(u_w), fq_a(x)
        h = torch.nn.functional.silu(xg @ g_w) * (xu @ u_w)
        if hit and target[1] == "down":
            d_w, h = fq_w(d_w), fq_a(h)
        outs.append(h @ d_w)
    w = torch.zeros((x.shape[0], cfg.num_experts), dtype=x.dtype)
    w.scatter_add_(1, routing.expert_ids.long(), routing.weights.to(x.dtype))
    return torch.einsum("eth,te->th", torch.stack(outs), w)


def _oracle(x, lp, cfg, qc):
    fp = _moe_out_dense(x, lp, cfg)
    return np.array([[float(((_moe_out_dense(x, lp, cfg, qc, (e, lin)) - fp) ** 2).sum())
                      for lin in ("gate", "up", "down")] for e in range(cfg.num_experts)])


def _matches(err2, oracle) -> bool:
    return np.allclose(err2, oracle, rtol=2e-3, atol=1e-7)


def test_calib_errors_match_bruteforce_oracle_and_a_wrong_linear_fails(qwen):
    _, cfg, _, pt = qwen
    lp = {k: v[0] for k, v in pt["layers"].items()}
    x = torch.from_numpy(_x2d(cfg, seed=2))
    qc = parse_scheme("w4a8_g-1_sym")
    oracle = _oracle(x, lp, cfg, qc)
    got = calibrate.moe_calib_errors(x, lp, cfg, qc, backend="dense").numpy()
    assert _matches(got[:cfg.num_experts], oracle)
    # mutation: the gate column computed with the up weights quantized in the
    # gate's place must fail the same check
    n = cfg.moe_intermediate_size
    wrong = {"gate": calibrate._fq_weight(lp["expert_gate_up"][..., n:].contiguous(), qc)}
    bad = calibrate.moe_calib_errors(x, lp, cfg, qc, backend="dense",
                                     fq_weights=wrong).numpy()
    assert not _matches(bad[:cfg.num_experts], oracle)
    np.testing.assert_array_equal(bad[:, 1:], got[:, 1:])


def test_dense_calib_errors_match_jax():
    cfg_j, cfg_t, pj, pt = _model("tiny_ds2", 4)
    x = np.random.default_rng(5).standard_normal((40, cfg_t.hidden_size)).astype(np.float32)
    dj = {k: v[0] for k, v in pj["dense_layers"].items()}
    dt = {k: v[0] for k, v in pt["dense_layers"].items()}
    from mxmoe_tpu.quant.schemes import parse_scheme as jparse

    for scheme in SCHEMES:
        want = np.asarray(jax_cal.dense_calib_errors(jnp.asarray(x), dj, cfg_j,
                                                     jparse(scheme)))
        got = calibrate.dense_calib_errors(torch.from_numpy(x), dt, cfg_t,
                                           parse_scheme(scheme)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())


def _jax_calibrate(name, seed, method, tokens, tmp, **kw):
    from mxmoe_tpu.quant.schemes import parse_scheme as jparse

    cfg_j, cfg_t, pj, pt = _model(name, seed)
    schemes_j = {s: jparse(s) for s in SCHEMES}
    # the '-had' methods: the layer-streamed form, which draws PRNGKey(0)
    stage = method.endswith("-had")
    want = jax_cal.calibrate_model(pj, jnp.asarray(tokens), cfg_j, schemes_j,
                                   method=method, stage_host=stage)
    return cfg_t, pt, want


@pytest.mark.parametrize("method", ["rtn", "gptq", "rtn-had", "gptq-had"])
def test_calibrate_model_matches_jax(method, tmp_path):
    # GPTQ's Hessians need more rows than K to be well conditioned
    tokens = _tokens(jax_configs.tiny_qwen2_moe(), b=4, s=64)
    cfg, pt, want = _jax_calibrate("tiny_qwen2_moe", 7, method, tokens, tmp_path)
    rot = None
    if method.endswith("-had"):
        rot = torch.from_numpy(np.array(jax_rhm(cfg.hidden_size, jax.random.PRNGKey(0))))
    schemes = {s: parse_scheme(s) for s in SCHEMES}
    got = calibrate.calibrate_model(pt, torch.from_numpy(tokens), cfg, schemes,
                                    save_dir=str(tmp_path), model_id="tiny",
                                    method=method, device="cpu", rotation=rot,
                                    one_linear=method == "gptq", verbose=False)
    for s in SCHEMES:
        _assert_layer_close(got[s], want[s])
        path = os.path.join(str(tmp_path), f"tiny-MOE-layer_out_norm-{method}-{s}.json")
        with open(path) as f:
            assert json.load(f) == got[s]
    assert set(got[SCHEMES[0]]["0"]) == {str(e) for e in range(cfg.num_experts + 1)}


def test_calibrate_model_ds2_dense_pseudo_layer_matches_jax():
    tokens = _tokens(jax_configs.tiny_ds2(), seed=8)
    cfg, pt, want = _jax_calibrate("tiny_ds2", 9, "rtn", tokens, None)
    got = calibrate.calibrate_model(pt, torch.from_numpy(tokens), cfg,
                                    {s: parse_scheme(s) for s in SCHEMES},
                                    device="cpu", verbose=False)
    for s in SCHEMES:
        assert set(got[s]) == {"dense-0", "0", "1"}
        assert set(got[s]["dense-0"]) == {"0"}
        _assert_layer_close(got[s], want[s])


def test_resume_skips_calibrated_layers(qwen, tmp_path, monkeypatch):
    _, cfg, _, pt = qwen
    tokens = torch.from_numpy(_tokens(cfg, seed=11))
    schemes = {"w4a4_g-1_sym": parse_scheme("w4a4_g-1_sym")}
    first = calibrate.calibrate_model(pt, tokens, cfg, schemes, save_dir=str(tmp_path),
                                      model_id="m", device="cpu", verbose=False)
    loaded = calibrate.load_resumable(str(tmp_path), "m", "rtn", schemes)
    assert loaded == first
    calls = []
    real = calibrate.moe_calib_errors
    monkeypatch.setattr(calibrate, "moe_calib_errors",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    again = calibrate.calibrate_model(pt, tokens, cfg, schemes, save_dir=str(tmp_path),
                                      model_id="m", resume=True, device="cpu",
                                      verbose=False)
    assert again == first and not calls
    with pytest.raises(NotImplementedError):
        calibrate.fisher_errors()


def test_model_out_norm_errors_match_jax():
    from mxmoe_tpu.quant.schemes import parse_scheme as jparse

    cfg_j = jax_configs.tiny_qwen2_moe(num_experts=3, num_layers=2)
    cfg_t = configs.tiny_qwen2_moe(num_experts=3, num_layers=2)
    pj = jax_model.init_params(cfg_j, jax.random.PRNGKey(8), dtype=jnp.float32)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    tokens = _tokens(cfg_t, seed=9, b=1, s=24)
    want = jax_cal.model_out_norm_errors(pj, jnp.asarray(tokens), cfg_j,
                                         jparse("w3a16_g-1_sym"), layer_idx=0)
    got = calibrate.model_out_norm_errors(pt, torch.from_numpy(tokens), cfg_t,
                                          parse_scheme("w3a16_g-1_sym"), 0,
                                          device="cpu")
    assert got.shape == want.shape == (4, 3) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())
