"""The compiled decode step (``mxmoe_tpu_torch/serving/graph.py``) on the
CPU, where its body runs eagerly (a card captures the same body: the card
tests in ``test_torch_cuda_kernels.py`` and ``chip_smoke.py``'s ``graph``
phase).

(a) The body that a CUDA graph holds reads nothing on the host: it runs
    under a ``TorchDispatchMode`` that raises on every op whose result the
    host must read (``_local_scalar_dense``, ``nonzero``, boolean indexing,
    ``masked_select``, a tensor made from host data, ...), once for every
    scheme family the smoke serves. The kernels' plain versions alone are
    exempt: they stand in for the kernels on the CPU and read their
    metadata on the host by design.
(b) The port's ``Engine.step`` / ``step_chunk`` on the static-buffer path
    give the JAX ``Engine``'s greedy tokens on the same weights, prompts
    and slot churn, and keep one cache (``lengths`` included) for life.
(c) The sync-free decode write (``S_new == 1``) equals the JAX
    ``scatter_layer_cache`` / ``scatter_layer_cache_quant`` (jitted, as
    every serving entry point reaches it) bitwise at the drop cases: a full
    slot, an invalid slot, a slot at ``S_max - 1``.
(d) Launch counting across capture and replay, with a stub graph.

Tolerances: tokens equal; the cache writes bitwise (the same values are
cast or quantized by the same f32 arithmetic)."""

import dataclasses

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
from mxmoe_tpu.serving import kv_cache as jax_kv
from mxmoe_tpu.serving.engine import Engine as JaxEngine
from mxmoe_tpu.serving.engine import EngineConfig as JaxEngineConfig
from mxmoe_tpu_torch.models import configs
from mxmoe_tpu_torch.models.convert import pack_int4_experts
from mxmoe_tpu_torch.models.layers import MoEImpl
from mxmoe_tpu_torch.models.model import init_params
from mxmoe_tpu_torch.ops import kernels
from mxmoe_tpu_torch.params_from_jax import params_from_jax
from mxmoe_tpu_torch.quant.qparams import quantize_lm_head
from mxmoe_tpu_torch.quant.schemes import parse_scheme
from mxmoe_tpu_torch.serving import decode, graph, kv_cache
from mxmoe_tpu_torch.serving.bench_serving import quantize_for_serving
from mxmoe_tpu_torch.serving.engine import Engine, EngineConfig

from _torch_host_guard import HostReadGuard, exempt_plain_versions


def _exempt_plain_versions(monkeypatch, guard):
    """Every kernel's plain version runs with the guard off."""
    exempt_plain_versions(guard, monkeypatch.setattr)


def _tiny(model: str):
    """Two layers at widths every scheme takes (K % 128 for g128)."""
    if model == "ds2":
        return dataclasses.replace(configs.tiny_ds2(4, 2), hidden_size=128)
    return dataclasses.replace(configs.tiny_qwen2_moe(8, 2), hidden_size=256,
                               moe_intermediate_size=256,
                               shared_expert_intermediate_size=256, head_dim=64)


# family -> (model, --quant name, pack w4, int8 KV, int8 head, MoEImpl fields,
# temperature)
FAMILIES = {
    "uniform": ("qwen2_moe", "w8a8_g-1_sym", False, False, False, {}, 0.0),
    "packed_w4": ("qwen2_moe", "w4a8_g-1_sym", True, False, False, {}, 0.0),
    "mixed_packed_int8kv": ("qwen2_moe", "mixed-packed", False, True, False, {}, 0.0),
    "a16": ("qwen2_moe", "w4a16_g-1_sym", False, False, False, {}, 0.0),
    "a16_packed": ("qwen2_moe", "w4a16_g128_asym", True, False, False, {}, 0.0),
    "grouped": ("qwen2_moe", "w4a4_g128_sym", False, False, False, {}, 0.0),
    "asym": ("qwen2_moe", "w8a8_g-1_asym", False, False, False, {}, 0.0),
    "flex": ("qwen2_moe", "flex", False, False, False, {}, 0.0),
    "flex_wo": ("qwen2_moe", "flex-wo", False, False, False, {}, 0.0),
    "flex_packed": ("qwen2_moe", "flex-packed", False, True, False, {}, 0.0),
    "mixed_wo": ("qwen2_moe", "mixed-wo", False, False, False, {}, 0.0),
    "bf16_k11": ("qwen2_moe", "none", False, False, False,
                 {"gmm_backend": "pallas"}, 0.0),
    "bf16_stock": ("qwen2_moe", "none", False, False, False, {}, 0.0),
    "fused_mixed": ("qwen2_moe", "mixed-packed", False, True, False,
                    {"fused_ffn": True}, 0.0),
    "fused_uniform": ("qwen2_moe", "w8a8_g-1_sym", False, False, False,
                      {"fused_ffn": True}, 0.0),
    "fused_auto": ("qwen2_moe", "w8a8_g-1_sym", False, False, False,
                   {"fused_ffn": "auto"}, 0.0),
    "aligned": ("qwen2_moe", "w8a8_g-1_sym", False, False, False,
                {"dispatch_align": 32}, 0.0),
    "xla": ("qwen2_moe", "w8a8_g-1_sym", False, False, False,
            {"decode_attn": "xla"}, 0.0),
    "xla_int8kv": ("qwen2_moe", "mixed-packed", False, True, False,
                   {"decode_attn": "xla"}, 0.0),
    "mla": ("ds2", "mixed-packed", False, True, True, {}, 0.0),
    "mla_xla": ("ds2", "w8a8_g-1_sym", False, False, False, {"decode_attn": "xla"},
                0.0),
    "int8_head": ("qwen2_moe", "w8a8_g-1_sym", False, False, True, {}, 0.0),
    "sampled": ("qwen2_moe", "w8a8_g-1_sym", False, False, False, {}, 0.8),
}


def _served(family: str):
    model, quant, pack, int8_kv, head, impl_kw, temperature = FAMILIES[family]
    cfg = _tiny(model)
    floats = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params, impl = quantize_for_serving(floats, cfg, quant)
    if pack:
        params = pack_int4_experts(params, impl.quant)
    if head:
        params = quantize_lm_head(params)
    init = kv_cache.init_quant_kv_cache if int8_kv else kv_cache.init_kv_cache
    return cfg, params, dataclasses.replace(impl, **impl_kw), init, temperature


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_decode_step_body_reads_nothing_on_the_host(family, monkeypatch):
    cfg, params, impl, init, temperature = _served(family)
    b, s_max = 4, 24
    cache = init(cfg, b, s_max, device="cpu")
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 6)).astype(np.int32))
    # prefill (one host read a chunk by design); slot 3 full, slot 2 empty
    _, c = decode.forward_cached(params, prompt, cache, cfg, impl,
                                 valid_lengths=torch.tensor([6, 3, 0, 6], dtype=torch.int32))
    cache.lengths.copy_(c.lengths)
    cache.lengths[3] = s_max
    step = graph.DecodeGraph(params, cfg, impl, cache, temperature, 50 if temperature else 0,
                             torch.Generator().manual_seed(3))
    step.load(torch.from_numpy(rng.integers(0, cfg.vocab_size, b).astype(np.int32)),
              torch.tensor([1, 1, 0, 1], dtype=torch.int32))
    guard = HostReadGuard()
    _exempt_plain_versions(monkeypatch, guard)
    with guard:
        out = step.run(2)
    assert out.shape == (b, 2) and bool(((out >= 0) & (out < cfg.vocab_size)).all())
    assert cache.lengths.tolist() == [8, 5, 0, s_max]
    assert step.logits.shape == (b, 1, cfg.vocab_size)


def test_the_guard_sees_a_host_read():
    """The guard is live: the prefill's boolean selection and ``.item()``
    raise under it."""
    x = torch.arange(6)
    with HostReadGuard(), pytest.raises(AssertionError, match="host read"):
        torch.nonzero(x > 2)
    with HostReadGuard(), pytest.raises(AssertionError, match="host read"):
        x.sum().item()
    with HostReadGuard(), pytest.raises(AssertionError, match="host read"):
        x[x > 2]


def test_sampler_draws_multinomials_tokens():
    """``sample_tokens`` writes ``torch.multinomial``'s one-sample path out
    (without its host check): the same tokens from the same generator."""
    logits = torch.randn((4, 300), generator=torch.Generator().manual_seed(0)) * 4
    for seed in range(4):
        got = decode.sample_tokens(logits, torch.Generator().manual_seed(seed), 0.8, 50)
        scaled = logits / 0.8
        cutoff = torch.topk(scaled, 50, dim=-1).values[:, -1:]
        probs = torch.softmax(scaled.masked_fill(scaled < cutoff, float("-inf")), -1)
        want = torch.multinomial(probs, 1, generator=torch.Generator().manual_seed(seed))
        assert torch.equal(got, want[:, 0].to(torch.int32))


# -- (b) the Engine against the JAX Engine ---------------------------------

SCHEME = "w8a8_g-1_sym"


@pytest.fixture(scope="module")
def engines_models():
    kw = dict(hidden_size=256, num_heads=4, num_kv_heads=2, head_dim=128)
    cfg_j = dataclasses.replace(jax_configs.tiny_qwen2_moe(8, 2), **kw)
    cfg_t = dataclasses.replace(configs.tiny_qwen2_moe(8, 2), **kw)
    params_j = jax_quantize(jax_model.init_params(cfg_j, jax.random.PRNGKey(4),
                                                  dtype=jnp.float32),
                            jax_parse_scheme(SCHEME))
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), "cpu")
    impl_j = JaxMoEImpl(kind="ragged", quant=jax_parse_scheme(SCHEME),
                        interpret=True, decode_attn="fused")
    return cfg_j, cfg_t, params_j, params_t, impl_j, MoEImpl(quant=parse_scheme(SCHEME))


def test_engine_step_and_step_chunk_match_the_jax_engine(engines_models):
    """Step, chunks of 3 and 2, arrivals into freed slots: the same greedy
    tokens, the cache's buffers the same objects throughout."""
    cfg_j, cfg_t, params_j, params_t, impl_j, impl_t = engines_models
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg_t.vocab_size, n).tolist() for n in (19, 7, 11, 4)]
    ecfg = dict(batch_slots=2, max_len=48, prefill_chunk=8)
    ej = JaxEngine(params_j, cfg_j, JaxEngineConfig(**ecfg), impl_j)
    et = Engine(params_t, cfg_t, EngineConfig(**ecfg), impl_t)
    buffers = [id(getattr(et.cache, f.name)) for f in dataclasses.fields(et.cache)]
    # (prompt, max_new) arrivals, then the ops both engines run
    plan = [("submit", 0, 5), ("submit", 1, 9), ("step",), ("chunk", 3),
            ("submit", 2, 4), ("step",), ("chunk", 2), ("submit", 3, 6),
            ("chunk", 3), ("chunk", 3), ("step",), ("chunk", 4)]
    rids_j, rids_t = [], []
    for op in plan:
        if op[0] == "submit":
            rids_j.append(ej.submit(prompts[op[1]], max_new_tokens=op[2]))
            rids_t.append(et.submit(prompts[op[1]], max_new_tokens=op[2]))
        elif op[0] == "step":
            assert et.step() == ej.step()
        else:
            assert et.step_chunk(op[1]) == ej.step_chunk(op[1])
    out_j, out_t = ej.run_to_completion(chunk=2), et.run_to_completion(chunk=2)
    assert [out_t[r] for r in rids_t] == [out_j[r] for r in rids_j]
    assert [id(getattr(et.cache, f.name)) for f in dataclasses.fields(et.cache)] == buffers
    np.testing.assert_array_equal(et.cache.lengths.numpy(), np.asarray(ej.cache.lengths))


# -- (c) the sync-free decode write against the JAX scatter ------------------

def _drop_case(seed: int, n_kv: int = 2, s_max: int = 8, hd: int = 16):
    rng = np.random.default_rng(seed)
    lengths = np.asarray([3, s_max, 5, s_max - 1], np.int32)   # slot 1 full
    valid = np.asarray([1, 1, 0, 1], np.int32)                 # slot 2 invalid
    new_k = rng.standard_normal((4, 1, n_kv, hd)).astype(np.float32)
    new_v = rng.standard_normal((4, 1, n_kv, hd)).astype(np.float32)
    return lengths, valid, new_k, new_v, (2, 4, n_kv, s_max, hd)


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_write_bf16_equals_jax_scatter(seed):
    lengths, valid, new_k, new_v, shape = _drop_case(seed)
    rng = np.random.default_rng(seed + 10)
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
    # the full and the invalid slot kept their history, the last one landed
    np.testing.assert_array_equal(tk[1, 1].float().numpy(),
                                  torch.from_numpy(base_k[1, 1]).to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(tk[1, 2].float().numpy(),
                                  torch.from_numpy(base_k[1, 2]).to(torch.bfloat16).float().numpy())
    assert torch.equal(tk[1, 3, :, -1], torch.from_numpy(new_k[3, 0]).to(torch.bfloat16))


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_write_int8_equals_jax_scatter_quant(seed):
    lengths, valid, new_k, new_v, shape = _drop_case(seed)
    rng = np.random.default_rng(seed + 20)
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
    np.testing.assert_array_equal(got[0][1, 1].numpy(), codes[0][1, 1])
    np.testing.assert_array_equal(got[1][1, 2].numpy(), scales[0][1, 2])


# -- (d) launch counts across capture and replay -----------------------------

class StubGraph:
    """``capture_begin`` / ``capture_end`` / ``replay`` of a CUDA graph,
    recording the calls."""

    def __init__(self):
        self.calls = []

    def capture_begin(self):
        self.calls.append("begin")

    def capture_end(self):
        self.calls.append("end")

    def replay(self):
        self.calls.append("replay")


def test_capture_counts_at_replay_not_at_capture():
    kernels.reset_launch_counts()
    kernels.launches["gmm_w8a8"] = 5

    def body():
        kernels.launches["gmm_w8a8"] += 2
        kernels.launches["quantize_rows"] += 1

    stub = StubGraph()
    counts = graph.capture(stub, body)
    assert stub.calls == ["begin", "end"]
    assert counts == {"gmm_w8a8": 2, "quantize_rows": 1}
    assert kernels.launches["gmm_w8a8"] == 5 and kernels.launches["quantize_rows"] == 0
    for _ in range(3):
        stub.replay()
        kernels.add_launches(counts)
    assert kernels.launches["gmm_w8a8"] == 11 and kernels.launches["quantize_rows"] == 3
    kernels.reset_launch_counts()


def test_a_failed_capture_ends_it_and_counts_nothing():
    kernels.reset_launch_counts()

    def body():
        kernels.launches["gmm_w8a8"] += 4
        raise RuntimeError("refused")

    stub = StubGraph()
    with pytest.raises(RuntimeError, match="refused"):
        graph.capture(stub, body)
    assert stub.calls == ["begin", "end"]
    assert kernels.launches["gmm_w8a8"] == 0


def test_shared_counters_are_not_grown_under_capture(monkeypatch):
    """Tickets and the grid barrier a graph holds exist before its capture:
    growing them inside one raises."""
    dev = torch.device("cpu")
    have = kernels.tickets(dev, 1).numel()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert kernels.tickets(dev, have).numel() == have       # no growth: fine
    with pytest.raises(RuntimeError, match="capture"):
        kernels.tickets(dev, have + 1)
    monkeypatch.setattr(kernels, "_barriers", {})
    with pytest.raises(RuntimeError, match="capture"):
        kernels.grid_barrier(dev)


def test_grown_tickets_keep_the_buffer_a_graph_holds(monkeypatch):
    """Growing the tickets after a capture replaces the buffer but never
    frees the old one: a graph captured against it replays on it, all zero,
    for the life of the process."""
    monkeypatch.setattr(kernels, "_tickets", {})
    monkeypatch.setattr(kernels, "_retired_tickets", [])
    dev = torch.device("cpu")
    held = kernels.tickets(dev, 8)
    ptr, size = held.data_ptr(), held.numel()
    del held
    grown = kernels.tickets(dev, size + 1)
    assert grown.numel() >= size + 1 and not grown.any()
    assert [t.data_ptr() for t in kernels._retired_tickets] == [ptr]
    assert kernels.tickets(dev, size + 1) is grown          # no growth: kept
    assert len(kernels._retired_tickets) == 1
