"""The port's GPTQ (``quant/gptq.py``), MSE clip search and fake quant
(``quant/rtn.py``), calibration tokens (``quant/data.py``) and the GPTQ
real quantizer (``quant/quantizer.py``) against the JAX package.

Bitwise: the MSE clip search, ``fake_quant``, the calibration tokens, GPTQ
with an identity Hessian against RTN. Within stated bounds: per-expert
Hessians (summation order, rtol 1e-5) and the GPTQ sweep from the same W and
H. The sweep feeds each column's rounding error into the later columns, and
its products sum in XLA's order there and torch's here, so a tie can round a
column to the neighbouring code. Measured on these cases (CPU): 100 % of
the codes equal and every expert's proxy loss tr(dW H dW^T) within 5e-7 of
the reference's; the bounds below leave room for another CPU's summation
order: at least 99.9 % equal codes, no code off by more than one, proxy
losses within 1e-4 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.models import configs as jax_configs
from mxmoe_tpu.models import model as jax_model
from mxmoe_tpu.quant import data as jdata
from mxmoe_tpu.quant import gptq as jg
from mxmoe_tpu.quant import rtn as jrtn
from mxmoe_tpu.quant import schemes as jschemes
from mxmoe_tpu.quant.hadamard import random_hadamard_matrix as jax_random_hadamard
from mxmoe_tpu_torch.models import configs
from mxmoe_tpu_torch.params_from_jax import params_from_jax
from mxmoe_tpu_torch.quant import data, gptq, rtn, schemes
from mxmoe_tpu_torch.quant.quantizer import (make_moe_hessian_fn, proxy_loss,
                                             quantize_model_experts_mixed_gptq)

CODE_AGREEMENT_MIN = 0.999
PROXY_LOSS_REL = 1e-4


def _corr_case(seed=0, e=3, n=24, k=128, m=384):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((m, k)).astype(np.float32)
    x = base + 0.5 * np.roll(base, 1, axis=1)            # correlated columns
    w = rng.standard_normal((e, n, k)).astype(np.float32)
    h = np.asarray(jg.accumulate_hessian(jnp.asarray(x)))
    return w, np.stack([h] * e), x


def test_hessians_vs_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((67, 24)).astype(np.float32)
    gs = np.array([20, 0, 44, 3], np.int32)
    ref = np.asarray(jg.accumulate_hessian(jnp.asarray(x), jnp.asarray(gs), 4))
    got = gptq.accumulate_hessian(torch.from_numpy(x), torch.from_numpy(gs), 4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert float(got[1].abs().max()) == 0.0
    # the card's masked batched product (no host read of the sizes), in
    # chunks of one and of all experts
    for chunk in (67 * 24, 1 << 20):
        masked = 2.0 * gptq._masked_gram(torch.from_numpy(x), torch.from_numpy(gs), chunk)
        torch.testing.assert_close(masked, got, rtol=1e-5, atol=1e-5)
    part = gptq.accumulate_hessian(torch.from_numpy(x), torch.from_numpy(gs), 4,
                                   expert_slice=(2, 4))
    assert torch.equal(part, got[2:4])
    one = gptq.accumulate_hessian(torch.from_numpy(x))
    np.testing.assert_allclose(one.numpy(), np.asarray(jg.accumulate_hessian(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["w4a16_g-1_sym", "w3a16_g-1_asym", "w4a16_g32_asym",
                                  "w8a8_g-1_sym"])
def test_identity_hessian_is_rtn_bitwise(name):
    """With H = I and no damping, U = I and no error feeds forward: GPTQ's
    fake-quantized weights are RTN's, bit for bit (and the reference's)."""
    rng = np.random.default_rng(0)
    e, n, k = 2, 16, 64
    w = rng.standard_normal((e, n, k)).astype(np.float32)
    h = np.broadcast_to(np.eye(k, dtype=np.float32), (e, k, k)).copy()
    c = schemes.parse_scheme(name)
    res = gptq.gptq_quantize(torch.from_numpy(w), torch.from_numpy(h), c, percdamp=0.0,
                             static_groups=True)
    want = rtn.fake_quant(torch.from_numpy(w), c.w_bits, c.w_gsize, c.w_sym)
    assert torch.equal(res.w_fq, want)
    ref = jg.gptq_quantize(jnp.asarray(w), jnp.asarray(h), jschemes.parse_scheme(name),
                           percdamp=0.0, static_groups=True)
    np.testing.assert_array_equal(res.codes.numpy(), np.asarray(ref.codes))


def _check_agreement(res, ref, w, h):
    d = res.codes.numpy() - np.asarray(ref.codes)
    assert (d == 0).mean() >= CODE_AGREEMENT_MIN, (d == 0).mean()
    assert np.abs(d).max() <= 1
    lt = proxy_loss(res.w_fq.transpose(-1, -2), torch.from_numpy(w).transpose(-1, -2),
                    torch.from_numpy(h))
    lj = proxy_loss(torch.from_numpy(np.array(ref.w_fq)).transpose(-1, -2),
                    torch.from_numpy(w).transpose(-1, -2), torch.from_numpy(h))
    assert float(((lt - lj).abs() / lj).max()) <= PROXY_LOSS_REL


@pytest.mark.parametrize("opts", [{}, {"static_groups": True}, {"act_order": True},
                                  {"act_order": True, "static_groups": True}],
                         ids=["plain", "static", "actorder", "actorder-static"])
@pytest.mark.parametrize("name", ["w4a16_g-1_sym", "w3a16_g-1_asym", "w4a16_g32_sym",
                                  "w4a16_g32_asym_mse"])
def test_gptq_quantize_vs_jax(name, opts):
    w, h, x = _corr_case()
    c = schemes.parse_scheme(name)
    res = gptq.gptq_quantize(torch.from_numpy(w), torch.from_numpy(h), c, **opts)
    ref = jg.gptq_quantize(jnp.asarray(w), jnp.asarray(h), jschemes.parse_scheme(name),
                           **opts)
    _check_agreement(res, ref, w, h)
    assert res.scale.shape == tuple(np.asarray(ref.scale).shape)
    if c.w_gsize == -1 or opts.get("static_groups"):
        # scales from the original weights, outside the sweep: bitwise
        np.testing.assert_array_equal(res.scale.numpy(), np.asarray(ref.scale))
    # GPTQ beats RTN on the correlated rows
    rtn_fq = rtn.fake_quant(torch.from_numpy(w), c.w_bits, c.w_gsize, c.w_sym, c.w_clip)
    xt = torch.from_numpy(x)
    assert (float(((res.w_fq - torch.from_numpy(w)) @ xt.T).norm())
            < float(((rtn_fq - torch.from_numpy(w)) @ xt.T).norm()))


def test_gptq_quantize_kn_and_non_dividing_k_vs_jax():
    """The [K, N] layout, K = 192 (no 128 block divides it: the gcd block)
    and a dead column."""
    rng = np.random.default_rng(1)
    k, n = 192, 40
    base = rng.standard_normal((256, k // 2)).astype(np.float32)
    x = np.concatenate([base, 0.5 * base + 0.1 * rng.standard_normal((256, k // 2))], -1)
    x[:, 7] = 0.0
    h = np.asarray(jg.accumulate_hessian(jnp.asarray(x)))[None]
    w = rng.standard_normal((1, k, n)).astype(np.float32)
    c = "w4a16_g-1_sym"
    res = gptq.gptq_quantize_kn(torch.from_numpy(w), torch.from_numpy(h),
                                schemes.parse_scheme(c))
    ref = jg.gptq_quantize_kn(jnp.asarray(w), jnp.asarray(h), jschemes.parse_scheme(c))
    assert res.codes.shape == (1, k, n) and res.scale.shape == (1, n, 1)
    assert float(res.w_fq[0, 7].abs().max()) == 0.0            # the dead column
    _check_agreement(gptq.GPTQResult(res.codes.transpose(-1, -2), res.scale, res.zp,
                                     res.w_fq.transpose(-1, -2)),
                     jg.GPTQResult(jnp.swapaxes(ref.codes, -1, -2), ref.scale, ref.zp,
                                   jnp.swapaxes(ref.w_fq, -1, -2)),
                     np.swapaxes(w, -1, -2), h)


def test_tri_inv_chunked_vs_full_and_jax():
    rng = np.random.default_rng(0)
    e, k = 2, 96
    a = rng.standard_normal((e, k, k))
    hm = a @ np.swapaxes(a, -1, -2) + k * np.eye(k)
    r_up = np.ascontiguousarray(np.linalg.cholesky(hm[..., ::-1, ::-1])[..., ::-1, ::-1])
    r32 = torch.from_numpy(r_up.astype(np.float32))
    full = gptq._tri_inv_chunked(r32)
    chunked = gptq._tri_inv_chunked(r32, max_rhs_elems=e * k * 32)
    torch.testing.assert_close(chunked, full, rtol=1e-5, atol=1e-5)
    ref = jg._tri_inv_chunked(jnp.asarray(r_up.astype(np.float32)))
    np.testing.assert_allclose(full.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(r32 @ full, torch.eye(k).expand(e, k, k), atol=1e-4, rtol=0)


def _group_err(x, scale, zp, bits, sym, gsize):
    """sum |W - Q(W)|^2.4 per group in float64, for given (scale, zp)."""
    upper, lower, _ = rtn.quant_ranges(bits, sym)
    g = x.shape[-1] if gsize == -1 else gsize
    xg = x.reshape(*x.shape[:-1], -1, g).astype(np.float64)
    s = np.where(scale == 0, 1.0, scale)[..., None].astype(np.float64)
    z = zp[..., None].astype(np.float64)
    q = np.round(np.clip((xg - z) / s, lower, upper))
    return (np.abs(q * s + z - xg) ** 2.4).sum(-1)


@pytest.mark.parametrize("bits,sym", [(4, True), (3, True), (8, True), (2, True),
                                      (4, False), (2, False), (8, False), (1.5, True),
                                      (1, False)])
def test_mse_clip_search_bitwise_vs_jax(bits, sym):
    """Scales, zero points and codes bitwise the reference's, but for groups
    where two grid points tie in float32: the reference's error (XLA's pow
    and sum) and the port's (torch's) then pick different points. Measured:
    one group over these cases (2-bit asymmetric, g32: 1 of 512 groups), its
    two candidates' errors 1.2e-7 apart; the test allows one group a case,
    a tie within 1e-6 in float64."""
    x = np.random.default_rng(0).standard_normal((16, 8, 128)).astype(np.float32)
    for gsize in (-1, 32):
        ref = [np.asarray(r) for r in jrtn.quantize(jnp.asarray(x), bits, gsize, sym,
                                                    clip="mse")]
        got = [g.numpy() for g in rtn.quantize(torch.from_numpy(x), bits, gsize, sym,
                                               clip="mse")]
        diff = (got[1] != ref[1]) | (got[2] != ref[2])
        assert diff.sum() <= 1, diff.sum()
        e_got = _group_err(x, got[1], got[2], bits, sym, gsize)[diff]
        e_ref = _group_err(x, ref[1], ref[2], bits, sym, gsize)[diff]
        assert np.all(np.abs(e_got - e_ref) <= 1e-6 * np.maximum(e_got, e_ref))
        g = x.shape[-1] if gsize == -1 else gsize
        same = np.repeat(~diff, g, axis=-1)
        np.testing.assert_array_equal(got[0][same], ref[0][same])


@pytest.mark.parametrize("name", ["w4a4_g-1_sym", "w4a4_g16_asym", "w8a8_g-1_asym",
                                  "w2a8_g-1_sym", "w4a16_g-1_sym_mse"])
def test_fake_quant_bitwise_vs_jax(name):
    x = np.random.default_rng(2).standard_normal((5, 64)).astype(np.float32)
    cj, ct = jschemes.parse_scheme(name), schemes.parse_scheme(name)
    np.testing.assert_array_equal(rtn.fake_quant_weight(torch.from_numpy(x), ct).numpy(),
                                  np.asarray(jrtn.fake_quant_weight(jnp.asarray(x), cj)))
    np.testing.assert_array_equal(rtn.fake_quant_act(torch.from_numpy(x), ct).numpy(),
                                  np.asarray(jrtn.fake_quant_act(jnp.asarray(x), cj)))
    xb = torch.from_numpy(x).bfloat16()
    assert rtn.fake_quant(xb, 4, -1, True).dtype == torch.bfloat16
    assert rtn.fake_quant(xb, 16, -1, True) is xb


def test_calibration_tokens_bitwise_vs_jax(tmp_path, monkeypatch):
    for args in ((4, 100, 512, 3), (2, 700, 151936, 42)):
        np.testing.assert_array_equal(data.synthetic_tokens(*args),
                                      jdata.synthetic_tokens(*args))
    np.testing.assert_array_equal(data.synthetic_markov_tokens(3, 50, 256, 1, 4, 2),
                                  jdata.synthetic_markov_tokens(3, 50, 256, 1, 4, 2))
    ids = np.arange(37, dtype=np.int64)
    np.testing.assert_array_equal(data._crop_samples(ids, 3, 60, 9),
                                  jdata._crop_samples(ids, 3, 60, 9))
    monkeypatch.delenv("MXMOE_CALIB_TEXT", raising=False)
    got = data.get_calibration_tokens(3, 40, vocab_size=300)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jdata.get_calibration_tokens(3, 40, vocab_size=300)))
    # a local text file through a tokenizer
    text = tmp_path / "calib.txt"
    text.write_text("a b c d e f g " * 40)
    monkeypatch.setenv("MXMOE_CALIB_TEXT", str(text))

    def tok(s):
        return {"input_ids": [ord(ch) for ch in s]}

    np.testing.assert_array_equal(
        data.get_calibration_tokens(2, 30, tokenizer=tok).numpy(),
        np.asarray(jdata.get_calibration_tokens(2, 30, dataset="local", tokenizer=tok)))
    with pytest.raises(NotImplementedError, match="download"):
        data.get_calibration_tokens(2, 30, dataset="wikitext2")


def _mixed_qmc(mod, e, layers, routed, shared):
    experts = {str(i): mod.QExpertConfig(*([mod.parse_scheme(routed[i % len(routed)])] * 3))
               for i in range(e)}
    if shared:
        experts[str(e)] = mod.QExpertConfig(*([mod.parse_scheme(shared)] * 3))
    return mod.QModelConfig(layers={str(l): mod.QLayerConfig(experts=dict(experts))
                                    for l in range(layers)})


def _tiny(seed=51):
    cfg_j = jax_configs.tiny_qwen2_moe(num_experts=4, num_layers=2)
    params_j = jax_model.init_params(cfg_j, jax.random.PRNGKey(seed), dtype=jnp.float32)
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), "cpu")
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(52), (2, 32), 0,
                                         cfg_j.vocab_size))
    return cfg_j, configs.tiny_qwen2_moe(num_experts=4, num_layers=2), params_j, params_t, toks


def test_moe_hessians_vs_jax():
    from mxmoe_tpu.quant.quantizer import make_moe_hessian_fn as jax_hessian_fn

    cfg_j, cfg_t, params_j, params_t, _ = _tiny()
    x = np.random.default_rng(0).standard_normal((40, cfg_t.hidden_size)).astype(np.float32)
    lp_j = jax.tree_util.tree_map(lambda a: a[0], params_j["layers"])
    lp_t = {k: v[0] for k, v in params_t["layers"].items()}
    ref = jax_hessian_fn(cfg_j, "ragged_dot")(jnp.asarray(x), lp_j)
    got = make_moe_hessian_fn(cfg_t, "ragged_dot")(torch.from_numpy(x), lp_t)
    assert sorted(got) == sorted(ref)
    for k in ref:
        r = np.asarray(ref[k])
        np.testing.assert_allclose(got[k].numpy(), r, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(r).max()), err_msg=k)


@pytest.mark.parametrize("case", ["flex-packed-had-actorder", "mixed-int8-shared-int8",
                                  "flex-fake-shared"])
def test_quantize_model_experts_mixed_gptq_vs_jax(case):
    """The layer-streamed GPTQ quantizer on a tiny model: the same keys and
    storage; codes within the agreement bound, every other leaf bitwise or
    within 1e-5 (scales) of the reference's. ``flex-fake-shared``: a grouped
    asymmetric shared expert, which GPTQ fake-quantizes."""
    routed, shared, kw = {
        "flex-packed-had-actorder": (("w4a4_g16_asym", "w8a8_g-1_sym"), "w8a8_g-1_sym",
                                     dict(pack_w4=True, hadamard=True, act_order=True)),
        "mixed-int8-shared-int8": (("w4a4_g-1_sym", "w8a8_g-1_sym"), "w8a8_g-1_sym", {}),
        "flex-fake-shared": (("w4a16_g16_asym", "w8a8_g-1_sym"), "w8a8_g16_asym", {}),
    }[case]
    cfg_j, cfg_t, params_j, params_t, toks = _tiny()
    from mxmoe_tpu.quant.quantizer import quantize_model_experts_mixed_gptq as jax_gptq

    key = jax.random.PRNGKey(3)
    ref = jax_gptq(params_j, cfg_j, _mixed_qmc(jschemes, 4, 2, routed, shared),
                   jnp.asarray(toks), rotation_key=key, **kw)["layers"]
    q = torch.from_numpy(np.array(jax_random_hadamard(cfg_t.hidden_size, key)))
    got = quantize_model_experts_mixed_gptq(
        params_t, cfg_t, _mixed_qmc(schemes, 4, 2, routed, shared),
        torch.from_numpy(toks), rotation=q, **kw)["layers"]
    assert sorted(got) == sorted(ref)
    if case == "flex-fake-shared":
        assert "shared_gate_up_q" not in got and "act_bits_shared" in got
    for k in ref:
        r, g = np.asarray(ref[k]), got[k]
        assert str(g.dtype).split(".")[-1] == str(r.dtype).replace("float", "float"), k
        gn = g.numpy()
        if g.dtype == torch.int8:
            d = gn.astype(np.int32) - r.astype(np.int32)
            assert (d == 0).mean() >= CODE_AGREEMENT_MIN, (k, (d == 0).mean())
        elif g.dtype == torch.int32 or k.startswith("act_"):
            np.testing.assert_array_equal(gn, r, err_msg=k)
        else:
            np.testing.assert_allclose(gn, r, rtol=1e-5,
                                       atol=1e-5 * max(float(np.abs(r).max()), 1e-30),
                                       err_msg=k)


def test_gptq_refuses_dense_first_layers_and_fills_stats():
    cfg = configs.tiny_ds2(num_experts=4, num_layers=3)
    with pytest.raises(NotImplementedError, match="dense"):
        quantize_model_experts_mixed_gptq({"dense_layers": {}, "layers": {}}, cfg,
                                          None, torch.zeros((1, 4), dtype=torch.int32))
    _, cfg_t, _, params_t, toks = _tiny()
    stats = {}
    out = quantize_model_experts_mixed_gptq(
        params_t, dataclasses.replace(cfg_t), _mixed_qmc(schemes, 4, 2, ("w4a4_g-1_sym",
                                                                          "w8a8_g-1_sym"),
                                                          "w8a8_g-1_sym"),
        torch.from_numpy(toks), stats=stats)
    assert len(stats["layers"]) == 2 and all(s["sweep_s"] > 0 for s in stats["layers"])
    gl = torch.cat(stats["proxy"]["gptq"])
    rl = torch.cat(stats["proxy"]["rtn"])
    assert gl.numel() == 2 * 2 * 4 and float((gl <= rl).float().mean()) >= 0.5
    assert "expert_gate_up_qcat" not in out["layers"]
