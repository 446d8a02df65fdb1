"""The compiled mesh Engine on the CPU: ``Engine(mesh)`` with
``cuda_graphs=True`` on 4 gloo ranks, where the graph objects
(``serving/graph.py``: ``DecodeGraph``, ``PrefillGraph``, ``FollowGraph``)
run their bodies eagerly, as on one device; a card captures the same bodies
with their NCCL collectives (``test_torch_mesh_graph_card.py`` and
``chip_smoke.py``'s ``ep`` phase).

The pool, the JAX ``Engine(mesh)`` references and the case table are
``test_torch_serving_mesh.py``'s. Held here:

(a) the captured mesh Engine's greedy tokens equal the eager one's
    (``cuda_graphs=False``) and the JAX mesh Engine's: ``submit`` into a
    slot of every rank (each rank owns one prompt and replays a follower
    graph for each of the three others), twice, with chunked decode; and
    ``submit_batch``;
(b) at a capacity factor that drops assignments, ``dropped_assignments()``
    is the same in both modes; a graph's warm-up and its restore leave the
    EP block's drop buffer, the cache and the static inputs as they found
    them;
(c) the EP block, its shared expert run while its first exchange is in
    flight, is bitwise the block written out synchronously;
(d) the mesh graphs' bodies read nothing on the host (the guard of
    ``_torch_host_guard``);
(e) graphs over the host-staged transport raise.

Tolerances: tokens and drop counts equal; the block bitwise."""

import numpy as np
import pytest

import _torch_ep_tasks as tasks
from test_torch_serving_mesh import (CASES, CHUNK, PROMPTS, TIMEOUT, WORLD,  # noqa: F401
                                     _spec, pool, references)

GRAPH_CASES = ("uniform", "packed-mixed")
UNIFORM = {"quant": "w8a8_g-1_sym"}
# every prefill chunk drops assignments at this capacity (decode may)
DROPPING_CAP = 0.5


def _case(name):
    e, layers, _, _, _, _, max_len, max_new, impl_kw = CASES[name]
    return (_spec(e, layers), impl_kw,
            dict(batch_slots=WORLD, max_len=max_len, prefill_chunk=CHUNK), max_new,
            float(e))


@pytest.mark.parametrize("name", GRAPH_CASES)
def test_captured_mesh_engine_equals_eager_and_jax(pool, references, name):
    """``submit`` puts prompt r into slot r, which rank r owns: every rank
    prefills one prompt through its staging graph and follows the three
    others' (one follower graph for each); the second round replays every
    graph the first made; decode in chunks of 3."""
    spec, impl_kw, ecfg, max_new, cap = _case(name)
    params, ref = references[name]
    got = pool.run(tasks.engine_modes, WORLD, spec, params, impl_kw, ecfg, PROMPTS,
                   max_new, cap, False, None, 3, False, 2, timeout=TIMEOUT)
    for rank, by_mode in enumerate(got):
        for mode in (True, False):
            assert by_mode[mode][4]["rounds"] == [ref, ref], (rank, mode)
        assert by_mode[True][4]["follow"] == [o for o in range(WORLD) if o != rank]
        assert by_mode[True][4]["graphs"] == ["_graph", "_slot_prefill"]
        assert by_mode[False][4]["follow"] == [] and by_mode[False][4]["graphs"] == []


@pytest.mark.parametrize("name", GRAPH_CASES)
def test_captured_mesh_submit_batch_equals_jax(pool, references, name):
    spec, impl_kw, ecfg, max_new, cap = _case(name)
    params, _ = references[name]
    got = pool.run(tasks.engine_modes, WORLD, spec, params, impl_kw, ecfg, PROMPTS,
                   max_new, cap, True, timeout=TIMEOUT)
    want = references[f"batch:{name}"]
    for by_mode in got:
        assert by_mode[True][0] == by_mode[False][0] == want
        assert by_mode[True][4]["graphs"] == ["_graph", "_batch_prefill"]


def test_captured_mesh_drops_what_the_eager_one_drops(pool, references):
    """The drop counter is one buffer added to in place, so the graphs'
    replays count what the eager calls count."""
    spec, _, ecfg, max_new, _ = _case("uniform")
    params, _ = references["uniform"]
    got = pool.run(tasks.engine_modes, WORLD, spec, params, UNIFORM, ecfg, PROMPTS,
                   max_new, DROPPING_CAP, False, None, 3, True, timeout=TIMEOUT)
    for mode in (True, False):
        assert len({g[mode][4]["dropped"] for g in got}) == 1
    dropped = got[0][True][4]["dropped"]
    assert dropped == got[0][False][4]["dropped"] > 0
    assert got[0][True][0] == got[0][False][0]


def test_graph_warmup_leaves_the_drop_buffer_as_found(pool, references):
    """Each graph's warm-up body routes rows (the decode step's inactive
    slots, the chunks' padding), so it drops at this capacity; its restore
    puts the buffer back, and the cache and static inputs are as before."""
    spec, _, ecfg, _, _ = _case("uniform")
    params, _ = references["uniform"]
    got = pool.run(tasks.warmup_drops, WORLD, spec, params, UNIFORM, ecfg, PROMPTS,
                   DROPPING_CAP, timeout=TIMEOUT)
    for rank, out in enumerate(got):
        assert set(out) == {"decode", "batch", "owner" if rank == WORLD - 1 else "follow"}
        for name, rec in out.items():
            before, grown, after = rec["drops"]
            assert after == before and rec["state_kept"], (rank, name, rec)
        # the batch chunk routes 16 assignments into 8 capacity slots a rank
        assert out["batch"]["drops"][1] > out["batch"]["drops"][0]


@pytest.mark.parametrize("layout", ["blocks", "rows"])
def test_shared_expert_under_the_exchange_is_the_synchronous_block(pool, references,
                                                                   layout):
    """The uniform block (K1 + K2 dispatch, w8a8 shared expert) on 4 ranks:
    its JAX row blocks (a decode step), or 8 rows on rank 1 and 4 on rank 3
    moved to the row blocks and back (one slot's prefill); the shared expert
    runs after the first exchange is issued and before it is waited for, and
    the output is bitwise the synchronous block's."""
    params, _ = references["uniform"]
    lp = {k: v[0] for k, v in params["layers"].items()}
    cfg_h = tasks.model_config(_spec(8, 2)).hidden_size
    x = np.random.default_rng(5).standard_normal((12, cfg_h)).astype(np.float32)
    counts = [0, 8, 0, 4]
    got = pool.run(tasks.shared_under_exchange, WORLD, _spec(8, 2), lp, x, 8.0, counts,
                   layout, timeout=TIMEOUT)
    for rank, (bitwise, events, rows) in enumerate(got):
        assert bitwise, rank
        assert events[0] == "issue"
        if rows:
            assert events.index("issue") < events.index("shared") < events.index("wait")
        else:
            assert "shared" not in events


def test_mesh_graph_bodies_read_nothing_on_the_host(pool, references):
    """Every mesh graph's body (the batch chunk, the staging chunk, the
    follower, the decode step) under the host-read guard, packed mixed
    experts (K4 over the rank's ragged buffer)."""
    spec, impl_kw, ecfg, _, _ = _case("packed-mixed")
    params, _ = references["packed-mixed"]
    got = pool.run(tasks.guarded_graph_bodies, WORLD, spec, params, impl_kw, ecfg,
                   PROMPTS, timeout=TIMEOUT)
    assert all(g == ["DecodeGraph", "FollowGraph", "PrefillGraph"] for g in got), got


def test_graphs_over_the_host_transport_raise():
    """The host-staged exchange copies through host memory inside every MoE
    block: ``cuda_graphs=True`` over it raises before anything is set up."""
    from mxmoe_tpu_torch.models import configs
    from mxmoe_tpu_torch.parallel.ep import EPConfig
    from mxmoe_tpu_torch.serving.engine import Engine, EngineConfig

    with pytest.raises(ValueError, match="cannot hold"):
        Engine({}, configs.tiny_qwen2_moe(8, 1), EngineConfig(), mesh=object(),
               ep_cfg=EPConfig(transport="host"))
