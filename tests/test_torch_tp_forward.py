"""Port parity for the tensor-parallel forward on torch.distributed: the
port's ``parallel.sharded.make_tp_forward`` over ``parallel.mesh.shard_params``
on ("data", "expert") meshes of 4 gloo ranks (one pool for the file,
``_torch_dist_pool``) against the JAX package's GSPMD forward,
``jax.jit(forward_logits)`` under the mesh over its ``shard_params``, on its
8-device CPU platform; the same numpy-seeded params (``params_from_jax``) and
tokens, float32, within 5e-4 (the JAX package's own tolerance for its
sharded forward, ``tests/test_ep.py``).

Also: ``param_shardings`` equal to the JAX specs key by key; the gate / up
block layout of a column-split gate_up (the ranks' blocks reassemble the
global tensor, and the contiguous cut gives other logits at ep 2); the
phantom experts of a non-divisible E; heads that "expert" does not divide
refused by name (a kept divergence: GSPMD pads such a shard);
``serving.graph.ForwardGraph`` on the CPU equal to its body, and refused
over the host-staged transport."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxmoe_tpu.models import configs as jcfgs
from mxmoe_tpu.models import model as jmodel
from mxmoe_tpu.models.layers import MoEImpl as JMoEImpl
from mxmoe_tpu.parallel import mesh as jmesh

import _torch_ep_tasks as tasks
from _torch_dist_pool import DistPool

WORLD = 4
TIMEOUT = 120.0
TOL = 5e-4
# GQA 8 / 4 heads: both the query and the kv heads and the shared expert's
# gate and up halves split at ep 2 and 4
# (pairs, not a dict: a spec keys the file's caches)
HEADS = (("num_heads", 8), ("num_kv_heads", 4))
FAMILIES = {"qwen2_moe": ("tiny_qwen2_moe", 8, 2, HEADS),
            "mixtral": ("tiny_mixtral", 4, 2, HEADS)}


@pytest.fixture(scope="module")
def pool():
    p = DistPool(WORLD)
    yield p
    p.close()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_cfg(spec):
    family, e, layers, kw = spec
    return dataclasses.replace(getattr(jcfgs, family)(e, layers), **dict(kw))


@functools.lru_cache(maxsize=None)
def _model(spec, seed):
    """(config, params, tokens [4, 16]) drawn with numpy from ``seed``: the
    JAX package's shapes and scales (matrices N(0, 0.4 / sqrt(fan_in)),
    embed / head N(0, 0.02)), norms near 1 and biases nonzero, so that their
    slices count too; one draw a spec and seed for the file."""
    cfg = _jax_cfg(spec)
    rng = np.random.default_rng(seed)

    def draw(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    layers = {}
    for name, shape in jmodel.layer_param_shapes(cfg).items():
        shape = (cfg.num_layers, *shape)
        if "norm" in name:
            layers[name] = 1.0 + draw(shape, 0.1)
        else:
            layers[name] = draw(shape, 0.4 / shape[-2] ** 0.5 if len(shape) > 2 else 0.1)
    params = {"embed": draw((cfg.vocab_size, cfg.hidden_size), 0.02),
              "layers": layers, "final_norm": 1.0 + draw((cfg.hidden_size,), 0.1),
              "lm_head": draw((cfg.hidden_size, cfg.vocab_size), 0.02)}
    toks = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    return cfg, jax.tree_util.tree_map(jnp.asarray, params), toks


@functools.lru_cache(maxsize=None)
def _gspmd_logits(spec, dp, ep):
    """The JAX package's tensor-parallel forward on ``_model(spec, 3)``:
    forward_logits jitted under a (dp, ep) mesh over its shard_params and
    data_sharding."""
    cfg, params, toks = _model(spec, 3)
    mesh = jmesh.make_mesh(dp * ep, ep=ep)
    impl = JMoEImpl(gmm_backend="ragged_dot")
    with mesh:
        out = jax.jit(lambda p, t: jmodel.forward_logits(p, t, cfg, impl))(
            jmesh.shard_params(params, mesh),
            jax.device_put(toks, jmesh.data_sharding(mesh)))
    return np.asarray(out)


def _gathered(got, dp, ep):
    """The data blocks in order, from the first rank of each expert group,
    after checking every rank of a group returned the same block."""
    for d in range(dp):
        for r in range(1, ep):
            np.testing.assert_array_equal(got[d * ep + r], got[d * ep])
    return np.concatenate([got[d * ep] for d in range(dp)])


class _StubMesh:
    """The DeviceMesh calls ``local_slice`` makes, for one rank's coordinates
    (no process group needed)."""

    def __init__(self, dp, ep, d, r):
        self.mesh_dim_names = ("data", "expert")
        self._size, self._rank = (dp, ep), {"data": d, "expert": r}

    def size(self, i):
        return self._size[i]

    def get_local_rank(self, name):
        return self._rank[name]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_param_shardings_are_the_jax_specs(family):
    """The port's specs, key by key, against ``_layer_specs`` and
    ``param_shardings`` of the JAX package."""
    from mxmoe_tpu_torch.parallel.mesh import data_sharding, param_shardings

    cfg = _jax_cfg(FAMILIES[family])
    # the specs read the tree's keys only: its shapes stand in for the arrays
    params = jax.eval_shape(lambda: jmodel.init_params(cfg, jax.random.PRNGKey(0),
                                                       dtype=jnp.float32))
    mesh = jmesh.make_mesh(4, ep=2)
    want = jmesh.param_shardings(params, mesh)
    got = param_shardings({"layers": dict.fromkeys(params["layers"])})
    assert set(got) == set(want)
    assert set(got["layers"]) == set(want["layers"]) == set(
        jmesh._layer_specs(params["layers"]))
    for k in ("embed", "final_norm", "lm_head"):
        assert tuple(got[k]) == tuple(want[k].spec), k
    for k, spec in want["layers"].items():
        assert tuple(got["layers"][k]) == tuple(spec.spec), k
    assert tuple(data_sharding()) == tuple(jmesh.data_sharding(mesh).spec)
    with pytest.raises(KeyError, match="expert_gate_up_q"):
        param_shardings({"layers": {"router": None, "expert_gate_up_q": None}})
    with pytest.raises(KeyError, match="lm_head_q"):
        param_shardings({"lm_head_q": None, "layers": {"router": None}})


@pytest.mark.parametrize("dp,ep", [(1, 4), (2, 2)])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tp_forward_matches_gspmd(pool, family, dp, ep):
    spec = FAMILIES[family]
    _, params, toks = _model(spec, 3)
    ref = _gspmd_logits(spec, dp, ep)
    got = pool.run(tasks.tp_forward, dp, ep, spec, _np(params), np.asarray(toks),
                   timeout=TIMEOUT)
    np.testing.assert_allclose(_gathered(got, dp, ep), ref, rtol=TOL, atol=TOL)


def test_gate_up_blocks_reassemble_the_global_tensor():
    """Rank r's columns of a fused gate_up are gate block r then up block r;
    over the ranks they are every column once, and every other leaf is the
    contiguous block of its spec."""
    from mxmoe_tpu_torch.parallel.mesh import P, gate_up_slice, local_slice, shard_params

    t = torch.arange(2 * 3 * 16, dtype=torch.float32).reshape(2, 3, 16)
    for ep in (2, 4):
        blocks = [gate_up_slice(t, P(None, None, "expert"), _StubMesh(1, ep, 0, r))
                  for r in range(ep)]
        assert all(b.shape == (2, 3, 16 // ep) for b in blocks)
        half = 16 // (2 * ep)
        torch.testing.assert_close(torch.cat([b[..., :half] for b in blocks], -1),
                                   t[..., :8], rtol=0, atol=0)
        torch.testing.assert_close(torch.cat([b[..., half:] for b in blocks], -1),
                                   t[..., 8:], rtol=0, atol=0)
    from mxmoe_tpu_torch.params_from_jax import params_from_jax

    _, params, _ = _model(FAMILIES["qwen2_moe"], 3)
    glob = params_from_jax(_np(params), "cpu")
    mesh = _StubMesh(2, 2, 1, 1)
    local = shard_params(glob, mesh)
    gu = glob["layers"]["shared_gate_up"]
    ns = gu.shape[-1] // 2
    torch.testing.assert_close(local["layers"]["shared_gate_up"],
                               torch.cat([gu[..., ns // 2:ns],
                                          gu[..., ns + ns // 2:]], -1), rtol=0, atol=0)
    for k in ("wq", "wo", "bq", "expert_down", "shared_down", "router"):
        torch.testing.assert_close(
            local["layers"][k],
            local_slice(glob["layers"][k], {"wq": P(None, None, "expert"),
                                            "wo": P(None, "expert", None),
                                            "bq": P(None, "expert"),
                                            "expert_down": P(None, "expert", None, None),
                                            "shared_down": P(None, "expert", None),
                                            "router": P(None, None, None)}[k], mesh),
            rtol=0, atol=0)


def test_contiguous_gate_up_cut_gives_other_logits(pool):
    """At ep 2 the contiguous column block of gate_up gives rank 0 every gate
    column and rank 1 every up column: the forward over it parts from
    GSPMD's logits; the gate / up blocks match them."""
    spec = FAMILIES["qwen2_moe"]
    _, params, toks = _model(spec, 3)
    ref = _gspmd_logits(spec, 2, 2)
    out = {layout: _gathered(pool.run(tasks.tp_forward, 2, 2, spec, _np(params),
                                      np.asarray(toks), layout, timeout=TIMEOUT), 2, 2)
           for layout in ("blocks", "contiguous")}
    np.testing.assert_allclose(out["blocks"], ref, rtol=TOL, atol=TOL)
    assert np.abs(out["contiguous"] - ref).max() > 100 * TOL


def test_non_divisible_experts_are_padded(pool):
    """E 6 over 4 ranks: two phantom experts pad the last ranks' blocks
    (the JAX package's device_put refuses the uneven split; the reference
    here is its forward on one device, the function GSPMD computes)."""
    spec = ("tiny_mixtral", 6, 2, HEADS)
    cfg, params, toks = _model(spec, 7)
    impl = JMoEImpl(gmm_backend="ragged_dot")
    ref = np.asarray(jax.jit(lambda p, t: jmodel.forward_logits(p, t, cfg, impl))(
        params, toks))
    got = pool.run(tasks.tp_forward, 1, 4, spec, _np(params), np.asarray(toks),
                   timeout=TIMEOUT)
    np.testing.assert_allclose(_gathered(got, 1, 4), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("heads,ep,named", [((4, 2), 4, "2 kv heads and 4 query heads"),
                                            ((28, 4), 8, "4 kv heads and 28 query heads")])
def test_heads_that_do_not_split_are_refused(heads, ep, named):
    """A kept divergence (ROADMAP queue C): GSPMD pads a head shard that
    "expert" does not divide; the port refuses it, naming both numbers."""
    from mxmoe_tpu_torch.models import configs
    from mxmoe_tpu_torch.parallel.sharded import tp_local_config

    cfg = dataclasses.replace(configs.tiny_qwen2_moe(8, 2), num_heads=heads[0],
                              num_kv_heads=heads[1])
    with pytest.raises(ValueError, match=f"{named} do not split over the {ep} ranks"):
        tp_local_config(cfg, ep)
    assert tp_local_config(cfg, heads[1]).num_kv_heads == 1
    with pytest.raises(ValueError, match="mla attention"):
        tp_local_config(configs.tiny_ds2(4, 3), 2)


def test_forward_graph_on_the_cpu_is_its_body():
    """On the CPU ``ForwardGraph`` runs its forward eagerly: the logits of
    every run are the forward's on the tokens given; a forward over the
    host-staged transport is refused."""
    from mxmoe_tpu_torch.models import configs
    from mxmoe_tpu_torch.models.layers import MoEImpl
    from mxmoe_tpu_torch.models.model import forward_logits, init_params
    from mxmoe_tpu_torch.serving.graph import ForwardGraph

    cfg = configs.tiny_qwen2_moe(8, 2)
    params = init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    impl = MoEImpl(gmm_backend="pallas")

    def forward(p, t):
        return forward_logits(p, t, cfg, impl)

    gen = torch.Generator().manual_seed(1)
    toks = [torch.randint(0, cfg.vocab_size, (2, 8), generator=gen, dtype=torch.int32)
            for _ in range(2)]
    g = ForwardGraph(forward, params, toks[0])
    with torch.inference_mode():
        for t in toks:
            assert torch.equal(g.run(t), forward(params, t))
        assert torch.equal(g.run(), forward(params, toks[1]))
    assert g.graph is None
    forward.transport = "host"
    with pytest.raises(ValueError, match="cannot hold"):
        ForwardGraph(forward, params, toks[0])
