"""Port parity for the fused serving slice: the aligned dispatch
(``MoEImpl.dispatch_align``) and the whole expert FFN in one launch
(``MoEImpl.fused_ffn``), the JAX package (Pallas in interpret mode) against
the port (the kernels' plain versions) on the same weights, at tiny widths.

Tolerances: the dispatch layout is exact (sizes, token ids) and the combine
weights equal to 3e-7 (XLA's and torch's exp). ``moe_block`` outputs (f32,
|y| ~ 0.1-1) agree with the JAX package within 2e-3 absolute: the router's
f32 matmul sums in another order, and XLA's CPU sigmoid differs from torch's
in the last bits, either of which can move an activation code by one step
(1/127 of the row's amax for a8; 1/7 for the mixed layers' a4 rows, so
those take 2e-2, as the mixed slice). Within the port, a layer the fused
guard refuses runs bitwise as with ``fused_ffn=False``, and ``"auto"`` is
bitwise ``True`` at up to 2048 routed rows and ``False`` above. Cached
logits (|logits| ~ 1) within 2e-3 for w8a8 and 2e-2 for the mixed layers,
greedy tokens equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.models import configs as jax_configs
from mxmoe_tpu.models import model as jax_model
from mxmoe_tpu.models.layers import MoEImpl as JaxMoEImpl
from mxmoe_tpu.models.layers import moe_block as jax_moe_block
from mxmoe_tpu.ops import dispatch as jd
from mxmoe_tpu.quant import qparams as jax_qparams
from mxmoe_tpu.quant import schemes as jax_schemes
from mxmoe_tpu.serving import decode as jax_decode
from mxmoe_tpu.serving import kv_cache as jax_kv
from mxmoe_tpu_torch.models import configs
from mxmoe_tpu_torch.models.layers import MoEImpl, moe_block
from mxmoe_tpu_torch.ops import dispatch as td
from mxmoe_tpu_torch.ops import kernels
from mxmoe_tpu_torch.params_from_jax import params_from_jax
from mxmoe_tpu_torch.quant.schemes import parse_scheme
from mxmoe_tpu_torch.serving import decode, kv_cache

W8A8 = "w8a8_g-1_sym"
MIX = ("w4a4_g-1_sym", "w8a8_g-1_sym")
FLEX_DOWN = ("w8a8_g-1_sym", "w4a4_g16_asym")


def _jax_qmc(schemes, num_layers, num_experts):
    experts = {str(e): jax_schemes.QExpertConfig(
        *([jax_schemes.parse_scheme(schemes[e % len(schemes)])] * 3))
        for e in range(num_experts)}
    return jax_schemes.QModelConfig(layers={
        str(l): jax_schemes.QLayerConfig(experts=dict(experts))
        for l in range(num_layers)})


def _quantized(params_j, cfg_j, quant, pack=False):
    """(JAX params, port params, JAX quant, port quant) of one scheme."""
    if quant == W8A8:
        qj = jax_schemes.parse_scheme(W8A8)
        pj = jax_qparams.quantize_model_experts_uniform(params_j, qj)
        qt = parse_scheme(W8A8)
    else:
        pj = jax_qparams.quantize_model_experts_mixed(
            params_j, cfg_j, _jax_qmc(quant, cfg_j.num_layers, cfg_j.num_experts),
            pack_w4=pack)
        qj = qt = "mixed"
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    return pj, pt, qj, qt


@pytest.fixture(scope="module")
def block_model():
    """The reference test's moe_block set-up: 4 experts, top-2, H 64,
    expert N 128 (the JAX fused kernel takes N a multiple of 128), 64 tokens."""
    cfg_j = dataclasses.replace(jax_configs.tiny_qwen2_moe(4, 1),
                                moe_intermediate_size=128)
    cfg_t = dataclasses.replace(configs.tiny_qwen2_moe(4, 1),
                                moe_intermediate_size=128)
    params_j = jax_model.init_params(cfg_j, jax.random.PRNGKey(31), dtype=jnp.float32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(32), (1, 64, cfg_j.hidden_size),
                                     jnp.float32))
    return cfg_j, cfg_t, params_j, x


def _layer0(params):
    return {k: v[0] for k, v in params["layers"].items()}


def _run_jax(x, lp, cfg, quant, **kw):
    impl = JaxMoEImpl(kind="ragged", quant=quant, interpret=True, **kw)
    return np.asarray(jax_moe_block(jnp.asarray(x), lp, cfg, impl))


def _run_torch(x, lp, cfg, quant, **kw):
    return moe_block(torch.from_numpy(np.array(x)), lp, cfg, MoEImpl(quant=quant, **kw))


def test_make_dispatch_aligned_equal_to_jax():
    """The reference test's layout (40 tokens, 8 experts, top-2, align 16) and
    the fused path's (align 32): sizes, token ids and weights."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((40, 8)).astype(np.float32)
    rj = jd.route_topk(jnp.asarray(logits), 2, False)
    rt = td.route_topk(torch.from_numpy(logits), 2, False)
    for align in (16, 32):
        dj, dt = jd.make_dispatch(rj, 8, align=align), td.make_dispatch(rt, 8, align=align)
        sizes = dt.group_sizes.numpy()
        assert (sizes % align == 0).all()
        assert dt.token_ids.shape[0] == 40 * 2 + 8 * (align - 1) >= sizes.sum()
        for field in ("group_sizes", "token_ids"):
            np.testing.assert_array_equal(getattr(dt, field).numpy(),
                                          np.asarray(getattr(dj, field)), err_msg=field)
        np.testing.assert_allclose(dt.combine_weights.numpy(),
                                   np.asarray(dj.combine_weights), rtol=3e-7, atol=0)


@pytest.mark.parametrize("sizes,rows", [([2, 0, 1], 6), ([2, 1, 0], 5),
                                        ([0, 0, 0], 4), ([0, 2, 0], 4),
                                        ([64, 0, 32, 96], 224), ([3, 5], 8)])
def test_expert_of_rows_is_the_reference_repeat(sizes, rows):
    """The rows past sum(sizes) take the last expert, as jnp.repeat with
    total_repeat_length fills them; the old repeat_interleave(output_size=)
    refused any such layout."""
    want = np.asarray(jnp.repeat(jnp.arange(len(sizes), dtype=jnp.int32),
                                 jnp.asarray(sizes), total_repeat_length=rows))
    got = td.expert_of_rows(torch.tensor(sizes, dtype=torch.int32), rows)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("quant,pack", [(W8A8, False), (MIX, False), (MIX, True)],
                         ids=["w8a8", "mixed", "mixed-packed"])
def test_moe_block_aligned_two_launch_vs_jax(block_model, quant, pack):
    """dispatch_align=32 without fusion: the two-launch branches over the
    padded layout (the mixed ones need the row_expert repair), against the
    JAX package and against the port's unaligned dispatch."""
    cfg_j, cfg_t, params_j, x = block_model
    pj, pt, qj, qt = _quantized(params_j, cfg_j, quant, pack)
    lj, lt = _layer0(pj), _layer0(pt)
    got = _run_torch(x, lt, cfg_t, qt, dispatch_align=32)
    tol = 2e-3 if quant == W8A8 else 2e-2
    np.testing.assert_allclose(got.numpy(), _run_jax(x, lj, cfg_j, qj, dispatch_align=32),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(got.numpy(), _run_torch(x, lt, cfg_t, qt).numpy(),
                               rtol=2e-4, atol=2e-4)


def test_moe_block_aligned_float_path_vs_jax(block_model):
    """The float path over an aligned layout (the reference test's align 16)."""
    cfg_j, cfg_t, params_j, x = block_model
    lj = _layer0(params_j)
    lt = _layer0(params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), "cpu"))
    got = _run_torch(x, lt, cfg_t, None, dispatch_align=16)
    np.testing.assert_allclose(got.numpy(), _run_jax(x, lj, cfg_j, None, dispatch_align=16),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), _run_torch(x, lt, cfg_t, None).numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("quant,pack", [(W8A8, False), (MIX, False), (MIX, True)],
                         ids=["w8a8-k12", "mixed-k12", "mixed-packed-k13"])
def test_moe_block_fused_vs_jax(block_model, quant, pack):
    cfg_j, cfg_t, params_j, x = block_model
    pj, pt, qj, qt = _quantized(params_j, cfg_j, quant, pack)
    lj, lt = _layer0(pj), _layer0(pt)
    got = _run_torch(x, lt, cfg_t, qt, dispatch_align=32, fused_ffn=True)
    tol = 2e-3 if quant == W8A8 else 2e-2
    np.testing.assert_allclose(
        got.numpy(), _run_jax(x, lj, cfg_j, qj, dispatch_align=32, fused_ffn=True),
        rtol=0, atol=tol)
    # against the port's two-launch path: the reference test's bound
    np.testing.assert_allclose(
        got.numpy(), _run_torch(x, lt, cfg_t, qt, dispatch_align=32).numpy(),
        rtol=3e-2, atol=3e-2)
    # fused_ffn alone implies the 32-row aligned dispatch
    assert torch.equal(got, _run_torch(x, lt, cfg_t, qt, fused_ffn=True))


@pytest.mark.parametrize("pack", [False, True], ids=["int8-stored", "packed"])
def test_moe_block_flex_down_falls_through(block_model, pack):
    """A flex down family: the guard refuses the per-channel fused kernels, so
    fused_ffn=True runs bitwise as fused_ffn=False, and as the JAX package."""
    cfg_j, cfg_t, params_j, x = block_model
    pj, pt, qj, qt = _quantized(params_j, cfg_j, FLEX_DOWN, pack)
    lj, lt = _layer0(pj), _layer0(pt)
    assert "act_gsize_down" in lt or "act_gsize_gateup" in lt
    got = _run_torch(x, lt, cfg_t, qt, dispatch_align=32, fused_ffn=True)
    assert torch.equal(got, _run_torch(x, lt, cfg_t, qt, dispatch_align=32))
    np.testing.assert_allclose(
        got.numpy(), _run_jax(x, lj, cfg_j, qj, dispatch_align=32, fused_ffn=True),
        rtol=0, atol=2e-2)


def test_fused_auto_is_a_decode_rule(block_model):
    """"auto" fuses at up to 2048 routed rows (tokens x top-k) and not above,
    bitwise the explicit choices."""
    cfg_j, cfg_t, params_j, _ = block_model
    _, pt, _, qt = _quantized(params_j, cfg_j, W8A8)
    lt = _layer0(pt)
    rng = np.random.default_rng(0)
    for tokens, fused in ((1024, True), (1025, False)):
        x = rng.standard_normal((1, tokens, cfg_t.hidden_size)).astype(np.float32)
        got = _run_torch(x, lt, cfg_t, qt, fused_ffn="auto")
        assert torch.equal(got, _run_torch(x, lt, cfg_t, qt, fused_ffn=fused)), tokens


def test_combine_masks_garbage_in_padding_rows():
    """The fused kernels leave padding rows unwritten: NaN there must not
    reach token 0, which the padding rows alias. The aligned combine adds
    the routed rows only, bitwise as the unaligned layout's combine."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 4)).astype(np.float32)
    rt = td.route_topk(torch.from_numpy(logits), 2, False)
    dt, du = td.make_dispatch(rt, 4, align=32), td.make_dispatch(rt, 4)
    rows = torch.from_numpy(rng.standard_normal((12, 8)).astype(np.float32))
    out = torch.full((dt.token_ids.shape[0], 8), float("nan"))
    out[dt.real_rows] = rows
    got = td.combine_tokens(out, dt, 6)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, td.combine_tokens(rows, du, 6))


@pytest.fixture(scope="module")
def cached_model():
    kw = dict(hidden_size=256, num_heads=4, num_kv_heads=2, head_dim=128,
              moe_intermediate_size=128)
    cfg_j = dataclasses.replace(jax_configs.tiny_qwen2_moe(8, 2), **kw)
    cfg_t = dataclasses.replace(configs.tiny_qwen2_moe(8, 2), **kw)
    params_j = jax_model.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    return cfg_j, cfg_t, params_j


@pytest.mark.parametrize("quant,pack,fused", [(W8A8, False, True),
                                              (MIX, True, True),
                                              (MIX, False, "auto")],
                         ids=["w8a8-on", "mixed-packed-on", "mixed-auto"])
def test_forward_cached_fused_vs_jax(cached_model, quant, pack, fused):
    cfg_j, cfg_t, params_j = cached_model
    pj, pt, qj, qt = _quantized(params_j, cfg_j, quant, pack)
    impl_j = JaxMoEImpl(kind="ragged", quant=qj, interpret=True, decode_attn="fused",
                        fused_ffn=fused)
    impl_t = MoEImpl(quant=qt, fused_ffn=fused)
    rng = np.random.default_rng(1)
    b, s = 2, 12
    steps = [(rng.integers(0, cfg_t.vocab_size, (b, s)).astype(np.int32),
              np.asarray([12, 7], np.int32))] + [
        (rng.integers(0, cfg_t.vocab_size, (b, 1)).astype(np.int32),
         np.asarray([1, 1], np.int32)) for _ in range(3)]
    cj = jax_kv.init_kv_cache(cfg_j, b, 32, jnp.float32)
    ct = kv_cache.init_kv_cache(cfg_t, b, 32, dtype=torch.float32, device="cpu")
    fwd_j = jax.jit(lambda p, t, c, v: jax_decode.forward_cached(
        p, t, c, cfg_j, impl_j, valid_lengths=v))
    tol = 2e-3 if quant == W8A8 else 2e-2
    kernels.reset_launch_counts()
    for i, (tk, vl) in enumerate(steps):
        lj, cj = fwd_j(pj, jnp.asarray(tk), cj, jnp.asarray(vl))
        lt, ct = decode.forward_cached(pt, torch.from_numpy(tk), ct, cfg_t, impl_t,
                                       valid_lengths=torch.from_numpy(vl))
        lj = np.asarray(lj)
        for r in range(b):   # rows past a slot's valid length are padding
            np.testing.assert_allclose(lt.numpy()[r, :vl[r]], lj[r, :vl[r]],
                                       rtol=0, atol=tol, err_msg=f"step {i}")
            np.testing.assert_array_equal(lt.numpy()[r, :vl[r]].argmax(-1),
                                          lj[r, :vl[r]].argmax(-1))
    assert sum(kernels.launches.values()) == 0


@pytest.mark.parametrize("flag,want", [("off", False), ("on", True), ("auto", "auto")])
@pytest.mark.parametrize("quant", ["w8a8_g-1_sym", "mixed-packed", "none"])
def test_bench_serving_fused_ffn_flag(cached_model, flag, want, quant):
    """--fused-ffn reaches the MoEImpl that quantize_for_serving builds, for
    every family, as the reference's flag does."""
    from mxmoe_tpu_torch.serving import bench_serving

    args = bench_serving.make_parser().parse_args(["--quant", quant, "--fused-ffn", flag])
    _, cfg_t, params_j = cached_model
    floats = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), "cpu")
    _, impl = bench_serving.quantize_for_serving(
        floats, cfg_t, args.quant, fused_ffn=bench_serving.FUSED_FFN[args.fused_ffn])
    assert impl.fused_ffn == want and impl.dispatch_align is None
