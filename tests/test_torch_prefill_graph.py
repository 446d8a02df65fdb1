"""The compiled prefill chunk and teacher-forced step
(``mxmoe_tpu_torch/serving/graph.py``: ``PrefillGraph``,
``TeacherForcedGraph``) on the CPU, where their bodies run eagerly (a card
captures the same bodies: the card cases in ``test_torch_cuda_kernels.py``
and ``chip_smoke.py``'s ``prefill_graph`` checks).

(a) The chunk write without a host read (``kv_cache._chunk_writes``) equals
    the JAX ``scatter_layer_cache`` / ``scatter_layer_cache_quant`` (jitted,
    as every serving entry point reaches them) bitwise: partial chunks,
    writes past S_max, slots with ``valid`` False, a chunk longer than
    S_max, and a chunk whose dropped writes a naive clamp would send onto a
    kept one; one slot's targets are distinct.
(b) ``forward_cached`` at S_new 8 reads nothing on the host (the decode
    step's ``HostReadGuard``, the kernels' plain versions exempt): GQA and
    MLA, bf16 and int8 caches, a mixed-packed MoE. The chunk write that
    selected its writes with ``torch.nonzero`` is caught.
(c) ``Engine.submit`` (the staging chunk graph, then the copy into the
    slot) and ``submit_batch`` (the full-width chunk graph) give the JAX
    Engine's greedy tokens over prompts of several chunks with a ragged last
    chunk, and over an arrival beside an active slot.
(d) ``eval_ppl_decode``'s step body: its nll equal to the eager twin's and
    within 1e-5 relative (f32 rounding) of the JAX ``eval_ppl_decode``'s, a
    ragged last batch of windows included.
(e) The fused FFN's cluster sizes, the literals the card case holds the
    built library's ``ffn_cluster`` to (8 CTAs at qwen2_moe's and ds2's N
    1408, 16 at qwen2_moe_57b's 2560): each CTA's share of h units fits the
    12 a CTA holds, which 8 CTAs at 2560 would not; the 16-CTA split of N
    2560 / H 3584 bitwise the K12 plain version.

Tolerances: cache writes bitwise (the same values cast or quantized by the
same f32 arithmetic); tokens equal; the decode nll as stated in (d)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.eval import evaluator as jax_ev
from mxmoe_tpu.models import configs as jax_configs
from mxmoe_tpu.models.layers import MoEImpl as JaxMoEImpl
from mxmoe_tpu.serving import kv_cache as jax_kv
from mxmoe_tpu.serving.engine import Engine as JaxEngine
from mxmoe_tpu.serving.engine import EngineConfig as JaxEngineConfig
from mxmoe_tpu_torch.eval import evaluator
from mxmoe_tpu_torch.models import configs
from mxmoe_tpu_torch.models.layers import MoEImpl
from mxmoe_tpu_torch.ops import gmm_ffn
from mxmoe_tpu_torch.serving import decode, graph, kv_cache
from mxmoe_tpu_torch.serving.bench_serving import quantize_for_serving
from mxmoe_tpu_torch.serving.engine import Engine, EngineConfig
from mxmoe_tpu_torch.models.model import init_params
from test_torch_ffn_split import ffn_column_split, ffn_split_plain
from test_torch_graph_step import HostReadGuard, _exempt_plain_versions, _tiny

# -- (a) the chunk write against the JAX scatter -------------------------------

S_MAX = 8
# (lengths [4], valid [4], S_new): a partial chunk and one past S_max beside
# an invalid slot; the clamp case (slot 0: 3 kept at 5-7, 3 dropped, which a
# clamp to S_max - 1 would send onto position 7); a full slot; S_new = S_max;
# a chunk longer than S_max
WRITE_CASES = {
    "partial_and_overflow": ([0, 6, 3, 2], [1, 1, 0, 1], 4),
    "clamp_meets_kept": ([5, 0, 8, 7], [1, 1, 1, 0], 6),
    "whole_cache": ([0, 3, 8, 1], [1, 0, 1, 1], S_MAX),
    "longer_than_cache": ([0, 2, 5, 8], [1, 1, 1, 0], S_MAX + 3),
}


def _write_case(name, seed, n_kv=2, hd=16):
    lengths, valid, s_new = WRITE_CASES[name]
    rng = np.random.default_rng(seed)
    new_k = rng.standard_normal((4, s_new, n_kv, hd)).astype(np.float32)
    new_v = rng.standard_normal((4, s_new, n_kv, hd)).astype(np.float32)
    return (np.asarray(lengths, np.int32), np.asarray(valid, np.int32), new_k, new_v,
            (2, 4, n_kv, S_MAX, hd))


@pytest.mark.parametrize("name", sorted(WRITE_CASES))
def test_chunk_write_bf16_equals_jax_scatter(name):
    lengths, valid, new_k, new_v, shape = _write_case(name, 1)
    rng = np.random.default_rng(2)
    base_k = rng.standard_normal(shape).astype(np.float32)
    base_v = rng.standard_normal(shape).astype(np.float32)
    jk, jv = jax.jit(jax_kv.scatter_layer_cache, static_argnums=2)(
        jnp.asarray(base_k, jnp.bfloat16), jnp.asarray(base_v, jnp.bfloat16), 1,
        jnp.asarray(new_k), jnp.asarray(new_v), jnp.asarray(lengths),
        jnp.asarray(valid).astype(bool))
    tk = torch.from_numpy(base_k).to(torch.bfloat16)
    tv = torch.from_numpy(base_v).to(torch.bfloat16)
    args = [torch.from_numpy(a) for a in (new_k, new_v, lengths, valid)]
    with HostReadGuard():
        kv_cache.scatter_layer_cache(tk, tv, 1, *args[:3], valid=args[3])
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    # layer 0 and the invalid slots kept every byte
    assert torch.equal(tk[0], torch.from_numpy(base_k[0]).to(torch.bfloat16))
    for b in np.flatnonzero(valid == 0):
        assert torch.equal(tk[1, b], torch.from_numpy(base_k[1, b]).to(torch.bfloat16))


@pytest.mark.parametrize("name", sorted(WRITE_CASES))
def test_chunk_write_int8_equals_jax_scatter_quant(name):
    lengths, valid, new_k, new_v, shape = _write_case(name, 3)
    rng = np.random.default_rng(4)
    codes = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
    scales = [rng.random(shape[:4]).astype(np.float32) for _ in range(2)]
    want = jax.jit(jax_kv.scatter_layer_cache_quant, static_argnums=4)(
        jnp.asarray(codes[0]), jnp.asarray(scales[0]), jnp.asarray(codes[1]),
        jnp.asarray(scales[1]), 1, jnp.asarray(new_k), jnp.asarray(new_v),
        jnp.asarray(lengths), jnp.asarray(valid).astype(bool))
    got = [torch.from_numpy(a.copy()) for a in (codes[0], scales[0], codes[1], scales[1])]
    args = [torch.from_numpy(a) for a in (new_k, new_v, lengths, valid)]
    with HostReadGuard():
        kv_cache.scatter_layer_cache_quant(*got, 1, *args[:3], valid=args[3])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", sorted(WRITE_CASES))
def test_chunk_write_targets_are_distinct(name):
    """No two writes of one ``index_put_`` meet (their order on a card is
    undefined): one slot's S_new targets are distinct, and a dropped write
    lands on no kept position; a clamp to S_max - 1 would collide where the
    case says so."""
    lengths, valid, s_new = WRITE_CASES[name]
    s_new = min(s_new, S_MAX)
    bi, pi, keep = kv_cache._chunk_writes(s_new, S_MAX, torch.tensor(lengths),
                                          torch.tensor(valid))
    assert bi.shape == (4, 1) and pi.shape == keep.shape == (4, s_new)
    for b in range(4):
        tgt = pi[b].tolist()
        assert len(set(tgt)) == s_new and all(0 <= t < S_MAX for t in tgt)
        kept = {t for t, k in zip(tgt, keep[b].tolist()) if k}
        assert kept == {p for p in range(lengths[b], min(lengths[b] + s_new, S_MAX))
                        if valid[b]}
    if name == "clamp_meets_kept":
        clamped = (torch.tensor(lengths)[:, None] + torch.arange(6)).clamp(max=S_MAX - 1)
        assert len(set(clamped[0].tolist())) < 6


# -- (b) forward_cached at S_new > 1 reads nothing on the host ----------------

def _mixed_model(model: str, int8_kv: bool):
    cfg = _tiny(model)
    floats = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params, impl = quantize_for_serving(floats, cfg, "mixed-packed")
    init = kv_cache.init_quant_kv_cache if int8_kv else kv_cache.init_kv_cache
    return cfg, params, impl, init(cfg, 4, 24, device="cpu")


def _old_scatter(full_k, full_v, layer, new_k, new_v, lengths, valid=None):
    """The chunk write before the masked one: its kept writes selected by a
    boolean ``torch.nonzero``, read on the host."""
    pos = lengths.long()[:, None] + torch.arange(new_k.shape[1])
    keep = pos < full_k.shape[3]
    if valid is not None:
        keep &= valid.bool()[:, None]
    bi, si = torch.nonzero(keep, as_tuple=True)
    full_k[layer, bi, :, pos[bi, si], :] = new_k[bi, si].to(full_k.dtype)
    full_v[layer, bi, :, pos[bi, si], :] = new_v[bi, si].to(full_v.dtype)
    return full_k, full_v


@pytest.mark.parametrize("model", ["qwen2_moe", "ds2"], ids=["gqa", "mla"])
@pytest.mark.parametrize("int8_kv", [False, True], ids=["bf16", "int8"])
def test_prefill_chunk_reads_nothing_on_the_host(model, int8_kv, monkeypatch):
    cfg, params, impl, cache = _mixed_model(model, int8_kv)
    rng = np.random.default_rng(5)
    cache.lengths.copy_(torch.tensor([0, 3, 20, 24], dtype=torch.int32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32))
    valid = torch.tensor([8, 5, 8, 0], dtype=torch.int32)
    chunk = graph.PrefillGraph(params, cfg, impl, cache, 8)
    chunk.load(toks, valid)
    guard = HostReadGuard()
    _exempt_plain_versions(monkeypatch, guard)
    with guard:
        logits = chunk.run()
    assert logits.shape == (4, 8, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    assert cache.lengths.tolist() == [8, 8, 24, 24]
    if not int8_kv:
        # the write that read its selection on the host is caught
        monkeypatch.setattr(decode, "scatter_layer_cache", _old_scatter)
        with guard, pytest.raises(AssertionError, match="host read"):
            chunk.run()


# -- (c) the Engine's captured prefill against the JAX Engine -------------------

@pytest.fixture(scope="module")
def float_models():
    """A tiny float32 qwen2_moe, one seeded init handed to both packages
    (the port's init: the JAX init's first compile takes ~10 s here; no
    interpret-mode kernel on the JAX side, whose compiles would dominate
    these tests' time)."""
    cfg_j, cfg_t = jax_configs.tiny_qwen2_moe(8, 2), configs.tiny_qwen2_moe(8, 2)
    params_t = init_params(cfg_t, torch.Generator().manual_seed(4), dtype=torch.float32,
                           device="cpu")
    params_j = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params_t)
    return cfg_j, cfg_t, params_j, params_t


def test_engine_submit_and_submit_batch_match_the_jax_engine(float_models):
    """Prompts of 19 (three chunks of 8, the last ragged) and 11 tokens
    through ``submit``, then 13 and 6 at once through ``submit_batch``
    beside the slot still active, arrivals into freed slots: the same
    greedy tokens and lengths as the JAX Engine (its decode attention the
    plain einsum, the port's K3's plain version)."""
    cfg_j, cfg_t, params_j, params_t = float_models
    impl_j = JaxMoEImpl(kind="ragged", decode_attn="xla")
    impl_t = MoEImpl()
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg_t.vocab_size, n).tolist() for n in (19, 11, 13, 6)]
    ecfg = dict(batch_slots=3, max_len=48, prefill_chunk=8)
    ej = JaxEngine(params_j, cfg_j, JaxEngineConfig(**ecfg), impl_j)
    et = Engine(params_t, cfg_t, EngineConfig(**ecfg), impl_t)
    rids = []
    for e in (ej, et):
        r = [e.submit(prompts[0], max_new_tokens=2), e.submit(prompts[1], max_new_tokens=4)]
        e.step()                                # the first request finishes
        r += e.submit_batch(prompts[2:], max_new_tokens=2)
        rids.append((r, e.run_to_completion()))
    (r_j, out_j), (r_t, out_t) = rids
    assert [out_t[r] for r in r_t] == [out_j[r] for r in r_j]
    np.testing.assert_array_equal(et.cache.lengths.numpy(), np.asarray(ej.cache.lengths))
    assert et._slot_prefill is not None and et._batch_prefill is not None


# -- (d) the teacher-forced step ------------------------------------------------

def test_teacher_forced_step_nll_and_ppl(float_models):
    """The summed nll against the JAX ``eval_ppl_decode``'s at f32 rounding
    (1e-5 relative; its ppl is ``exp(nll / n)`` in f64, so ``log(ppl) * n``
    is its nll): at random init the ppl sits near the vocabulary size and
    hardly depends on the cache, while the nll moves 4e-4 relative when
    the step's attention reads one cache position off."""
    cfg_j, cfg_t, params_j, params_t = float_models
    toks = np.random.default_rng(7).integers(0, cfg_t.vocab_size, (3, 8)).astype(np.int32)
    impl_t = MoEImpl(kind="ragged")
    captured = evaluator.decode_nll(params_t, toks, cfg_t, impl_t, batch=2)
    eager = evaluator.decode_nll(params_t, toks, cfg_t, impl_t, batch=2, captured=False)
    assert captured == eager and captured[1] == 3 * 7
    got = evaluator.eval_ppl_decode(params_t, toks, cfg_t, impl_t, batch=2)
    ref = jax_ev.eval_ppl_decode(params_j, toks, cfg_j, JaxMoEImpl(kind="ragged"),
                                 batch=3)
    nll, n = captured
    assert got == float(np.exp(nll / n))
    ref_nll = float(np.log(ref)) * n
    assert abs(nll - ref_nll) / ref_nll < 1e-5, (nll, ref_nll)


# -- (e) the fused FFN's cluster at qwen2_moe_57b's widths ----------------------

# the CTAs of the kernels' cluster at each model's N (``test_fused_ffn_width_domain``
# holds the built library to them) and the h units a CTA holds at most
# (``FFN_MAX_HU`` in csrc/gmm_ffn_tile.cuh)
CLUSTER_OF = {"qwen2_moe": 8, "ds2": 8, "qwen2_moe_57b": 16}
MAX_HU = 12


def test_fused_ffn_cluster_sizes():
    def units(n, c):
        return max(-(-(c1 - c0) // 16) for c0, c1 in ffn_column_split(n, c))

    for name, c in CLUSTER_OF.items():
        n = configs.config_for(name).moe_intermediate_size
        assert units(n, c) <= MAX_HU, name
    assert units(2560, 8) == 20 > MAX_HU          # why qwen2_moe_57b takes 16
    assert units(1408, 8) == 11


def test_sixteen_cta_split_at_qwen2_moe_57b_widths_is_k12_plain():
    """The 16-CTA cluster's split of N 2560 (10 h units a CTA) and H 3584
    (14 down units) over a tile straddling two experts, bitwise the K12
    plain version (K cut to 64: the split is over N and H)."""
    k, n, h = 64, 2560, 3584
    rng = np.random.default_rng(8)
    sizes = [3, 0, 20]
    m, e = sum(sizes) + 4, len(sizes)
    aq = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    asc = torch.from_numpy((rng.random((m, 1)) * 0.02 + 1e-3).astype(np.float32))
    wgu = torch.from_numpy(rng.integers(-127, 128, (e, k, 2 * n), dtype=np.int8))
    sgu = torch.from_numpy((rng.random((e, 1, 2 * n)) * 2e-4 + 1e-5).astype(np.float32))
    wd = torch.from_numpy(rng.integers(-127, 128, (e, n, h), dtype=np.int8))
    sd = torch.from_numpy((rng.random((e, 1, h)) * 2e-3 + 1e-5).astype(np.float32))
    gs = torch.tensor(sizes, dtype=torch.int32)
    bits = torch.tensor([8, 4, 6], dtype=torch.int32)
    ref = gmm_ffn.gmm_ffn_w8a8_plain(aq, asc, wgu, sgu, wd, sd, gs, bits)
    got = ffn_split_plain(aq, asc, lambda i: wgu[i], sgu, lambda i: wd[i], sd, gs, bits,
                          torch.bfloat16, cluster=CLUSTER_OF["qwen2_moe_57b"])
    assert torch.equal(got, ref)
