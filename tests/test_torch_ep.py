"""Port parity for expert parallelism on torch.distributed: the port's EP MoE
blocks, sharded forward, (host, expert) group, ring attention and
sequence-parallel prefill on gloo ranks (one pool of 4 processes for the
file, ``_torch_dist_pool``) against the JAX package's ``shard_map`` versions
on its 8-device CPU mesh, same numpy-seeded inputs.

Tolerances are the JAX package's own tests' for the same case
(``tests/test_ep.py``, ``test_multihost.py``, ``test_ring_attention.py``):
2e-4 for the float block, the mixed forms (EP against one device) and the
(host, expert) group, 5e-3 for the int8 / a4 dispatch, 5e-4 for the sharded
forward and the SP prefill, 2e-4 for ring attention. The capacity drop counts
of each rank are equal to JAX's exactly (the logits are tie-free)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from mxmoe_tpu.models import configs as jcfgs
from mxmoe_tpu.models import model as jmodel
from mxmoe_tpu.parallel import ep as jep
from mxmoe_tpu.quant import qparams as jq
from mxmoe_tpu.quant.schemes import (QExpertConfig, QLayerConfig, QLinearConfig,
                                     QModelConfig, parse_scheme)

import _torch_ep_tasks as tasks
from _torch_dist_pool import DistPool

WORLD = 4
TIMEOUT = 120.0
FORM_TOL = {"bf16": 2e-4, "int8": 5e-3, "a4": 5e-3, "mixed": 2e-4,
            "mixed_packed": 2e-4, "flex": 2e-4, "flex_packed": 2e-4, "wo": 2e-4}
# the mixes of each form: (schemes alternating over the experts, pack_w4)
MIXES = {"mixed": (("w4a4_g-1_sym", "w8a8_g-1_sym"), False),
         "mixed_packed": (("w4a4_g-1_sym", "w8a8_g-1_sym"), True),
         "flex": (("w4a4_g16_asym", "w8a8_g-1_sym"), False),
         "flex_packed": (("w4a4_g16_asym", "w8a8_g-1_sym"), True),
         "wo": (("w4a16_g-1_sym", "w8a8_g-1_sym"), False)}


@pytest.fixture(scope="module")
def pool():
    p = DistPool(WORLD)
    yield p
    p.close()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_cfg(spec):
    family, e, layers, kw = spec
    return dataclasses.replace(getattr(jcfgs, family)(e, layers), **kw)


def _mesh(n, name="expert"):
    return Mesh(np.array(jax.devices()[:n]), axis_names=(name,))


def _layer(form, spec, seed):
    """The JAX package's one-layer params for ``form`` (numpy-convertible)."""
    cfg = _jax_cfg(spec)
    params = jmodel.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    if form in MIXES:
        schemes, pack = MIXES[form]
        qm = QModelConfig(layers={"0": QLayerConfig(experts={
            str(e): QExpertConfig(*([parse_scheme(schemes[e % 2])] * 3))
            for e in range(cfg.num_experts)})})
        params = jq.quantize_model_experts_mixed(params, cfg, qm, pack_w4=pack)
    lp = {k: v[0] for k, v in params["layers"].items()}
    if form in ("int8", "a4"):
        qc = QLinearConfig(w_bits=8, w_gsize=-1, w_sym=True, a_bits=8 if form == "int8" else 4)
        qg = jq.quantize_expert_weights(lp["expert_gate_up"], qc)
        qd = jq.quantize_expert_weights(lp["expert_down"], qc)
        lp = {"router": lp["router"], "expert_gate_up_q": qg.q,
              "expert_gate_up_sc": qg.scale, "expert_down_q": qd.q,
              "expert_down_sc": qd.scale}
    return cfg, lp


def _jax_block(form, cfg, lp, x, ep, cap):
    from mxmoe_tpu.quant.packing import shard_ragged_mixed

    mesh = _mesh(ep)
    if "expert_gate_up_qcat" in lp:
        # the per-shard packed layout the JAX Engine builds
        lp = dict(lp)
        for prefix, kdim in (("expert_gate_up", cfg.hidden_size),
                             ("expert_down", cfg.moe_intermediate_size)):
            cat, blk = shard_ragged_mixed(lp[f"{prefix}_qcat"], np.asarray(lp[f"{prefix}_blk"]),
                                          np.asarray(lp[f"{prefix}_pf"]), kdim, ep)
            lp[f"{prefix}_qcat"], lp[f"{prefix}_blk"] = cat, jnp.asarray(blk, jnp.int32)
    lp = jep.pad_expert_arrays(lp, cfg.num_experts, ep, axis=0)
    ep_cfg = jep.EPConfig(capacity_factor=cap, return_stats=True, wo_mix=form == "wo")
    with mesh:
        if form == "bf16":
            fn = jep.make_ep_moe_fn(cfg, mesh, ep_cfg)
            y, d = jax.jit(fn)(x, lp["router"], lp["expert_gate_up"], lp["expert_down"])
        elif form in ("int8", "a4"):
            make = jep.make_ep_moe_quant_fn if form == "int8" else jep.make_ep_moe_quant_a4_fn
            y, d = jax.jit(make(cfg, mesh, ep_cfg))(
                x, lp["router"], lp["expert_gate_up_q"], lp["expert_gate_up_sc"],
                lp["expert_down_q"], lp["expert_down_sc"])
        else:
            y, d = jax.jit(jep.make_ep_moe_mixed_dyn(cfg, mesh, ep_cfg))(x, lp)
    return np.asarray(y), np.asarray(d)


QWEN = ("tiny_qwen2_moe", 8, 1, {})
# (name, form, ep, model spec, seed, tokens, capacity factor)
# every form at ep 4 and all but the flex forms and the int8-stored mix at
# ep 2 (those three at ep 2 only under capacity drops, below)
CASES = [(f"{form}-ep{ep}", form, ep, QWEN, 5, 16 * ep, float(2 * ep))
         for form in FORM_TOL for ep in (2, 4)
         if ep == 4 or form not in ("mixed", "flex", "flex_packed")]
CASES += [
    # capacity drops: a quarter and a half of the assignments' expected load
    ("bf16-drops", "bf16", 4, QWEN, 6, 32, 0.25),
    ("int8-drops", "int8", 2, QWEN, 6, 32, 0.5),
    ("mixed-drops", "mixed", 4, QWEN, 6, 32, 0.5),
    ("mixed-drops-ep2", "mixed", 2, QWEN, 6, 32, 0.5),
    ("flex-drops", "flex", 2, QWEN, 6, 32, 0.5),
    ("flex_packed-drops", "flex_packed", 2, QWEN, 6, 32, 0.25),
    # non-divisible E: phantom experts (6 over 4 ranks -> 8)
    ("phantom6-mixed_packed", "mixed_packed", 4, ("tiny_qwen2_moe", 6, 1, {}), 7, 32, 6.0),
    # DeepSeek routing: a scaling factor, no renormalization
    ("ds2-bf16", "bf16", 4, ("tiny_ds2", 8, 2, {"routed_scaling_factor": 2.0}), 30, 32, 8.0),
]


@pytest.fixture(scope="module")
def references():
    """Every case's JAX inputs and shard_map outputs, computed once."""
    out = {}
    for name, form, ep, spec, seed, t, cap in CASES:
        cfg, lp = _layer(form, spec, seed)
        x = jax.random.normal(jax.random.PRNGKey(seed + 1), (t, cfg.hidden_size),
                              jnp.float32)
        out[name] = (_np(lp), np.asarray(x), _jax_block(form, cfg, lp, x, ep, cap))
    return out


@pytest.mark.parametrize("name,form,ep,spec,seed,t,cap", CASES, ids=[c[0] for c in CASES])
def test_ep_block_matches_shard_map(pool, references, name, form, ep, spec, seed, t, cap):
    lp, x, (y_ref, drops_ref) = references[name]
    got = pool.run(tasks.ep_block, ep, form, spec, lp, x, cap, timeout=TIMEOUT)[:ep]
    np.testing.assert_array_equal([d for _, d in got], drops_ref)
    if "drops" in name:
        assert drops_ref.sum() > 0, "the capacity dropped nothing: the case is too loose"
    np.testing.assert_allclose(np.concatenate([y for y, _ in got]), y_ref,
                               rtol=FORM_TOL[form], atol=FORM_TOL[form])


def test_block_moves_uneven_rows_to_the_jax_blocks(pool, references):
    """One slot's prefill: all rows on one rank, the others with none. The
    block spreads them to the JAX row blocks, so outputs and drops are the
    shard_map's on the same global rows."""
    lp, x, (y_ref, drops_ref) = references["mixed-drops"]
    counts = [0, 32, 0, 0]
    got = pool.run(tasks.block_rows, 4, QWEN, lp, x, 0.5, counts, timeout=TIMEOUT)
    assert sum(d for _, d in got) == drops_ref.sum() > 0
    np.testing.assert_allclose(got[1][0], y_ref, rtol=2e-4, atol=2e-4)
    assert all(y.shape == (0, x.shape[1]) for i, (y, _) in enumerate(got) if i != 1)


def test_capacity_factor_from_freq_matches_jax():
    from mxmoe_tpu_torch.parallel.ep import capacity_factor_from_freq, padded_num_experts

    for freq, ep, margin in ((np.ones(8), 4, 1.25), ([8.0, 8, 1, 1, 1, 1, 1, 1], 4, 1.0),
                             (np.arange(1, 61), 8, 1.5)):
        assert capacity_factor_from_freq(freq, ep, margin) == \
            jep.capacity_factor_from_freq(freq, ep, margin)
    assert padded_num_experts(60, 8) == jep.padded_num_experts(60, 8) == 64


@pytest.mark.parametrize("quantized", [False, True])
def test_sharded_forward_matches_jax(pool, quantized):
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from mxmoe_tpu.parallel.sharded import ep_param_shardings, make_sharded_forward
    from mxmoe_tpu.quant.qparams import quantize_model_experts_uniform

    ep, spec = 4, ("tiny_qwen2_moe", 8, 2, {})
    cfg = _jax_cfg(spec)
    params = jmodel.init_params(cfg, jax.random.PRNGKey(10), dtype=jnp.float32)
    if quantized:
        params = quantize_model_experts_uniform(params, parse_scheme("w8a8_g-1_sym"))
    toks = jax.random.randint(jax.random.PRNGKey(11), (ep, 16), 0, cfg.vocab_size)
    mesh = _mesh(ep)
    fwd = make_sharded_forward(cfg, mesh, quantized=quantized,
                               ep_cfg=jep.EPConfig(capacity_factor=float(2 * ep)))
    with mesh:
        ref = jax.jit(fwd)(jax.device_put(params, ep_param_shardings(params, mesh)),
                           jax.device_put(toks, NamedSharding(mesh, JP("expert", None))))
    got = pool.run(tasks.sharded_forward, ep, spec, _np(params), np.asarray(toks),
                   float(2 * ep), quantized, timeout=TIMEOUT)
    tol = 5e-3 if quantized else 5e-4
    np.testing.assert_allclose(np.concatenate(got), np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("form", ["bf16", "int8", "mixed"])
def test_host_expert_group_matches_jax(pool, form):
    """The (host, expert) 2 x 2 group: the EP block over the flattened pair
    against the JAX package's (2, 2) mesh."""
    from mxmoe_tpu.parallel.multihost import MultihostEPConfig, make_multihost_ep_fn

    cfg, lp = _layer(form if form != "bf16" else "bf16", QWEN, 2)
    x = jax.random.normal(jax.random.PRNGKey(3), (64, cfg.hidden_size), jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("host", "expert"))
    fn = make_multihost_ep_fn(cfg, mesh, MultihostEPConfig(
        capacity_factor=float(cfg.top_k * 4), quantized=form == "int8",
        mixed=form == "mixed", return_stats=True))
    args = {"bf16": ("expert_gate_up", "expert_down"),
            "int8": ("expert_gate_up_q", "expert_gate_up_sc", "expert_down_q",
                     "expert_down_sc"),
            "mixed": ("expert_gate_up_q", "expert_gate_up_sc", "expert_down_q",
                      "expert_down_sc", "act_bits_gateup", "act_bits_down")}[form]
    with mesh:
        y_ref, d_ref = jax.jit(fn)(x, lp["router"], *[lp[k] for k in args])
    got = pool.run(tasks.host_expert, form, QWEN, _np(lp), np.asarray(x),
                   float(cfg.top_k * 4), timeout=TIMEOUT)
    np.testing.assert_array_equal([d for _, d in got], np.asarray(d_ref))
    tol = 5e-3 if form == "int8" else 2e-4
    np.testing.assert_allclose(np.concatenate([y for y, _ in got]), np.asarray(y_ref),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("p,n_h,n_kv", [(4, 4, 4), (2, 8, 2)])
def test_ring_attention_matches_jax(pool, p, n_h, n_kv):
    from mxmoe_tpu.parallel.ring_attention import make_ring_attention_fn

    b, s, hd = 2, 16 * p, 16
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    q = jax.random.normal(k1, (b, s, n_h, hd), jnp.float32)
    k = jax.random.normal(k2, (b, s, n_kv, hd), jnp.float32)
    v = jax.random.normal(k3, (b, s, n_kv, hd), jnp.float32)
    mesh = _mesh(p, "seq")
    with mesh:
        ref = jax.jit(make_ring_attention_fn(mesh, "seq"))(q, k, v)
    got = pool.run(tasks.ring, p, np.asarray(q), np.asarray(k), np.asarray(v),
                   timeout=TIMEOUT)[:p]
    np.testing.assert_allclose(np.concatenate(got, axis=1), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


def test_sp_prefill_matches_jax(pool):
    from mxmoe_tpu.parallel.sharded import make_sp_prefill_forward

    p, spec = 4, ("tiny_qwen2_moe", 8, 2, {})
    cfg = _jax_cfg(spec)
    params = jmodel.init_params(cfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 8 * p), 0, cfg.vocab_size)
    ref = make_sp_prefill_forward(cfg, _mesh(p, "seq"))(params, toks)
    got = pool.run(tasks.sp_prefill, p, spec, _np(params), np.asarray(toks),
                   timeout=TIMEOUT)
    np.testing.assert_allclose(np.concatenate(got, axis=1), np.asarray(ref),
                               rtol=5e-4, atol=5e-4)


def test_ring_backend_outside_a_process_group_raises():
    import torch

    from mxmoe_tpu_torch.models.layers import attention

    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(RuntimeError, match="torch.distributed process group"):
        attention(q, q, q, backend="ring")
