"""Rank tasks of the port's expert-parallel CPU tests (run by
``_torch_dist_pool.DistPool`` on gloo ranks). Each task takes numpy inputs
made in the test process (the JAX package's global params and tokens), turns
them into this rank's tensors through the port's own sharding helpers, and
returns numpy results. Imports torch and the port only."""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh


def model_config(spec):
    """(family, num_experts, num_layers, overrides: a dict or its pairs) ->
    the port's config."""
    from mxmoe_tpu_torch.models import configs

    family, e, layers, kw = spec
    return dataclasses.replace(getattr(configs, family)(e, layers), **dict(kw))


def expert_mesh(ep: int, name: str = "expert"):
    """A 1-D mesh over ranks [0, ep) (every rank of the pool builds it)."""
    return DeviceMesh("cpu", list(range(ep)), mesh_dim_names=(name,))


def _local_layer(lp: dict, cfg, mesh, ep: int) -> dict:
    """One layer's global params -> this rank's: packed buffers resharded
    (shard_ragged_mixed), phantom experts padded, expert arrays sliced."""
    from mxmoe_tpu_torch.parallel.ep import pad_expert_arrays
    from mxmoe_tpu_torch.parallel.mesh import P, local_slice
    from mxmoe_tpu_torch.quant.packing import shard_ragged_mixed

    lp = dict(lp)
    for prefix, kdim in (("expert_gate_up", cfg.hidden_size),
                         ("expert_down", cfg.moe_intermediate_size)):
        if f"{prefix}_qcat" in lp:
            cat, blk = shard_ragged_mixed(lp[f"{prefix}_qcat"], lp[f"{prefix}_blk"],
                                          lp[f"{prefix}_pf"], kdim, ep)
            lp[f"{prefix}_qcat"] = cat
            lp[f"{prefix}_blk"] = torch.tensor(blk, dtype=torch.int32)
    lp = pad_expert_arrays(lp, cfg.num_experts, ep, axis=0)
    return {k: (local_slice(v, P("expert", *[None] * (v.dim() - 1)), mesh)
                if k.startswith("expert_") else v) for k, v in lp.items()}


def ep_block(rank, world, ep, form, spec, lp_np, x_np, cap):
    """One EP block form on this rank's row block -> (y_local, drops)."""
    from mxmoe_tpu_torch.params_from_jax import params_from_jax
    from mxmoe_tpu_torch.parallel import ep as tep

    mesh = expert_mesh(ep)
    if rank >= ep:
        return None
    cfg = model_config(spec)
    lp = _local_layer(params_from_jax(lp_np, "cpu"), cfg, mesh, ep)
    x = torch.from_numpy(x_np)
    t = x.shape[0] // ep
    x_local = x[rank * t:(rank + 1) * t]
    ep_cfg = tep.EPConfig(capacity_factor=cap, return_stats=True, wo_mix=form == "wo")
    quant = (lp["router"], lp.get("expert_gate_up_q"), lp.get("expert_gate_up_sc"),
             lp.get("expert_down_q"), lp.get("expert_down_sc"))
    if form == "bf16":
        y, d = tep.make_ep_moe_fn(cfg, mesh, ep_cfg)(
            x_local, lp["router"], lp["expert_gate_up"], lp["expert_down"])
    elif form == "int8":
        y, d = tep.make_ep_moe_quant_fn(cfg, mesh, ep_cfg)(x_local, *quant)
    elif form == "a4":
        y, d = tep.make_ep_moe_quant_a4_fn(cfg, mesh, ep_cfg)(x_local, *quant)
    elif form == "mixed_packed":
        ops = [lp[f"{p}_{n}"] for p in ("expert_gate_up", "expert_down")
               for n in ("qcat", "sc", "blk", "pf")]
        y, d = tep.make_ep_moe_mixed_fn(cfg, mesh, ep_cfg, packed=True)(
            x_local, lp["router"], *ops, lp["act_bits_gateup"], lp["act_bits_down"])
    else:      # mixed, flex, flex_packed, wo: the layout-driven wrapper
        y, d = tep.make_ep_moe_mixed_dyn(cfg, mesh, ep_cfg)(x_local, lp)
    return y.numpy(), int(d[0])


def block_rows(rank, world, ep, spec, lp_np, x_np, cap, counts):
    """EPMoEBlock with the rows laid out unevenly (``counts`` a rank) ->
    this rank's output rows and its drops."""
    from mxmoe_tpu_torch.params_from_jax import params_from_jax
    from mxmoe_tpu_torch.parallel import ep as tep

    mesh = expert_mesh(ep)
    if rank >= ep:
        return None
    cfg = model_config(spec)
    lp = _local_layer(params_from_jax(lp_np, "cpu"), cfg, mesh, ep)
    block = tep.make_ep_moe_block(cfg, mesh, "mixed",
                                  tep.EPConfig(capacity_factor=cap, return_stats=True))
    start = sum(counts[:rank])
    x = torch.from_numpy(x_np)[start:start + counts[rank]][None]
    with block.rows(counts):
        y = block(x, lp, dataclasses.replace(cfg, shared_expert_intermediate_size=0))
    return y[0].numpy(), int(block.dropped[0])


def sharded_forward(rank, world, ep, spec, params_np, toks_np, cap, quantized):
    """make_sharded_forward over this rank's batch block -> its logits."""
    from mxmoe_tpu_torch.params_from_jax import params_from_jax
    from mxmoe_tpu_torch.parallel.ep import EPConfig
    from mxmoe_tpu_torch.parallel.mesh import shard_params
    from mxmoe_tpu_torch.parallel.sharded import ep_param_shardings, make_sharded_forward

    mesh = expert_mesh(ep)
    if rank >= ep:
        return None
    cfg = model_config(spec)
    params = params_from_jax(params_np, "cpu")
    params = shard_params(params, mesh, ep_param_shardings(params, mesh))
    fwd = make_sharded_forward(cfg, mesh, quantized=quantized,
                               ep_cfg=EPConfig(capacity_factor=cap))
    toks = torch.from_numpy(toks_np)
    b = toks.shape[0] // ep
    with torch.inference_mode():
        return fwd(params, toks[rank * b:(rank + 1) * b]).numpy()


def host_expert(rank, world, form, spec, lp_np, x_np, cap):
    """make_multihost_ep_fn over a (host, expert) = (2, world/2) mesh."""
    from mxmoe_tpu_torch.params_from_jax import params_from_jax
    from mxmoe_tpu_torch.parallel.mesh import P, local_slice
    from mxmoe_tpu_torch.parallel.multihost import (MultihostEPConfig,
                                                    host_expert_mesh,
                                                    make_multihost_ep_fn)

    mesh = host_expert_mesh(n_hosts=2, device_type="cpu")
    cfg = model_config(spec)
    lp = params_from_jax(lp_np, "cpu")
    axes = ("host", "expert")
    lp = {k: (local_slice(v, P(axes, *[None] * (v.dim() - 1)), mesh)
              if k.startswith("expert_") else v) for k, v in lp.items()}
    x = torch.from_numpy(x_np)
    t = x.shape[0] // world
    x_local = x[rank * t:(rank + 1) * t]
    mh = MultihostEPConfig(capacity_factor=cap, quantized=form == "int8",
                           mixed=form == "mixed", return_stats=True)
    fn = make_multihost_ep_fn(cfg, mesh, mh)
    if form == "bf16":
        y, d = fn(x_local, lp["router"], lp["expert_gate_up"], lp["expert_down"])
    elif form == "int8":
        y, d = fn(x_local, lp["router"], lp["expert_gate_up_q"], lp["expert_gate_up_sc"],
                  lp["expert_down_q"], lp["expert_down_sc"])
    else:
        y, d = fn(x_local, lp["router"], lp["expert_gate_up_q"], lp["expert_gate_up_sc"],
                  lp["expert_down_q"], lp["expert_down_sc"], lp["act_bits_gateup"],
                  lp["act_bits_down"])
    return y.numpy(), int(d[0])


def ring(rank, world, p, q_np, k_np, v_np):
    """Ring attention over ranks [0, p) on this rank's sequence block."""
    from mxmoe_tpu_torch.parallel.ring_attention import make_ring_attention_fn

    mesh = expert_mesh(p, "seq")
    if rank >= p:
        return None
    s = q_np.shape[1] // p
    blk = [torch.from_numpy(a)[:, rank * s:(rank + 1) * s] for a in (q_np, k_np, v_np)]
    return make_ring_attention_fn(mesh, "seq")(*blk).numpy()


def sp_prefill(rank, world, p, spec, params_np, toks_np):
    """make_sp_prefill_forward over ranks [0, p) -> this rank's logits."""
    from mxmoe_tpu_torch.params_from_jax import params_from_jax
    from mxmoe_tpu_torch.parallel.sharded import make_sp_prefill_forward

    mesh = expert_mesh(p, "seq")
    if rank >= p:
        return None
    cfg = model_config(spec)
    fwd = make_sp_prefill_forward(cfg, mesh)
    toks = torch.from_numpy(toks_np)
    s = toks.shape[1] // p
    with torch.inference_mode():
        return fwd(params_from_jax(params_np, "cpu"),
                   toks[:, rank * s:(rank + 1) * s]).numpy()


def _impl(impl_kw: dict):
    from mxmoe_tpu_torch.models.layers import MoEImpl
    from mxmoe_tpu_torch.quant.schemes import parse_scheme

    kw = dict(impl_kw)
    if kw.get("quant") not in (None, "mixed"):
        kw["quant"] = parse_scheme(kw["quant"])
    return MoEImpl(**kw)


def engine(rank, world, ep, spec, params_np, impl_kw, ecfg_kw, prompts, max_new,
           cap, batch=False, gate_freq=None, chunk=0, stats=False, rounds=1):
    """The mesh Engine over ranks [0, ep) serving ``prompts`` (submit one by
    one, or submit_batch; ``rounds`` times, each after the last drained;
    decode in ``chunk``-step chunks when > 1) -> (greedy tokens of the first
    round, capacity factor, local cache slots, local expert count, {"rounds":
    every round's tokens, "dropped": dropped_assignments() (``stats``: the
    EP blocks count them), "follow": the owners of the rank's follower
    graphs, "graphs": the graphs made})."""
    from mxmoe_tpu_torch.params_from_jax import params_from_jax
    from mxmoe_tpu_torch.parallel.ep import EPConfig
    from mxmoe_tpu_torch.serving.engine import Engine, EngineConfig

    mesh = expert_mesh(ep)
    if rank >= ep:
        return None
    cfg = model_config(spec)
    ep_cfg = None if cap is None else EPConfig(capacity_factor=cap, return_stats=stats)
    eng = Engine(params_from_jax(params_np, "cpu"), cfg, EngineConfig(**ecfg_kw),
                 _impl(impl_kw), mesh=mesh, ep_cfg=ep_cfg, gate_freq=gate_freq)
    toks = []
    with torch.inference_mode():
        for _ in range(rounds):
            if batch:
                rids = eng.submit_batch(prompts, max_new_tokens=max_new)
            else:
                rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
            eng.run_to_completion(chunk=chunk)
            toks.append([eng.result(r) for r in rids])
    lp = eng.params["layers"]
    experts = next(v.shape[1] for k, v in lp.items()
                   if k.startswith("expert_") and not k.endswith("_qcat"))
    graphs = [name for name in ("_graph", "_slot_prefill", "_batch_prefill")
              if getattr(eng, name) is not None]
    return (toks[0], eng.ep_cfg.capacity_factor, eng.cache.lengths.shape[0], experts,
            {"rounds": toks, "dropped": eng.dropped_assignments(),
             "follow": sorted(eng._follow), "graphs": graphs})


def engine_modes(rank, world, *args):
    """``engine(rank, world, ep, spec, params_np, impl_kw, ecfg_kw, ...)``
    with ``cuda_graphs`` True (the graph objects; their bodies run eagerly
    on the CPU) and False -> {True: ..., False: ...}."""
    ep, spec, params_np, impl_kw, ecfg_kw, *rest = args
    return {mode: engine(rank, world, ep, spec, params_np, impl_kw,
                         {**ecfg_kw, "cuda_graphs": mode}, *rest)
            for mode in (True, False)}


def warmup_drops(rank, world, ep, spec, params_np, impl_kw, ecfg_kw, prompts, cap):
    """A graph's warm-up and its restore (``_Graphed._warmup``) on the mesh
    Engine's graphs after it served ``prompts`` (submit_batch, then one
    submit, then decode): for each graph the drop buffer before, after the
    warm-up's body, and after the restore; and whether the cache, the static
    inputs and the lengths came back as they were."""
    import dataclasses

    from mxmoe_tpu_torch.params_from_jax import params_from_jax
    from mxmoe_tpu_torch.parallel.ep import EPConfig
    from mxmoe_tpu_torch.serving.engine import Engine, EngineConfig
    from mxmoe_tpu_torch.serving.kv_cache import clone_cache

    mesh = expert_mesh(ep)
    if rank >= ep:
        return None
    eng = Engine(params_from_jax(params_np, "cpu"), model_config(spec),
                 EngineConfig(**ecfg_kw), _impl(impl_kw), mesh=mesh,
                 ep_cfg=EPConfig(capacity_factor=cap, return_stats=True))
    with torch.inference_mode():
        eng.submit_batch(prompts[:ep - 1], max_new_tokens=4)
        eng.submit(prompts[-1], max_new_tokens=4)          # into the last rank's slot
        eng.step()
        graphs = {"decode": eng._graph, "batch": eng._batch_prefill,
                  "owner" if rank == ep - 1 else "follow":
                  eng._slot_prefill if rank == ep - 1 else eng._follow[ep - 1]}
        out = {}
        for name, g in graphs.items():
            caches = [c for c in (eng.cache, getattr(g, "cache", None)) if c is not None]
            before_caches = [clone_cache(c) for c in caches]
            inputs = {k: getattr(g, k).clone() for k in ("tokens", "valid")
                      if hasattr(g, k)}
            before = int(eng._block.dropped[0])
            restore = g._warmup()
            grown = int(eng._block.dropped[0])
            restore()
            out[name] = {
                "drops": (before, grown, int(eng._block.dropped[0])),
                "state_kept": all(
                    torch.equal(getattr(c, f.name), getattr(b, f.name))
                    for c, b in zip(caches, before_caches)
                    for f in dataclasses.fields(c))
                and all(torch.equal(getattr(g, k), v) for k, v in inputs.items())}
    return out


def shared_under_exchange(rank, world, ep, spec, lp_np, x_np, cap, counts, layout):
    """The uniform EP block (its shared expert run while its first exchange
    is in flight) against the block written out synchronously (every
    exchange waited for, then the shared expert added), over ``x_np``'s
    rows laid out as the JAX row blocks (``layout`` "blocks") or as
    ``counts`` a rank under ``rows(counts)`` -> (bitwise equal, the block's
    exchanges issued ("issue"), waited for ("wait") and its shared expert
    ("shared") in order, the rank's rows)."""
    from mxmoe_tpu_torch.models.layers import shared_expert_ffn
    from mxmoe_tpu_torch.params_from_jax import params_from_jax
    from mxmoe_tpu_torch.parallel import ep as tep

    mesh = expert_mesh(ep)
    if rank >= ep:
        return None
    cfg = model_config(spec)
    lp = _local_layer(params_from_jax(lp_np, "cpu"), cfg, mesh, ep)
    block = tep.make_ep_moe_block(cfg, mesh, True, tep.EPConfig(capacity_factor=cap))
    comm = block.comm
    events = []
    issue, ffn = comm.all_to_all_async, tep.shared_expert_ffn

    class Logged:
        def __init__(self, work):
            self.work = work

        def wait(self):
            events.append("wait")
            return self.work.wait()

    def issue_logged(*a, **kw):
        events.append("issue")
        out, work = issue(*a, **kw)
        return out, Logged(work)

    def ffn_logged(*a, **kw):
        events.append("shared")
        return ffn(*a, **kw)

    x = torch.from_numpy(x_np)
    if layout == "blocks":
        t = x.shape[0] // ep
        mine = x[rank * t:(rank + 1) * t]
        rows = contextlib.nullcontext()
    else:
        start = sum(counts[:rank])
        mine = x[start:start + counts[rank]]
        rows = block.rows(counts)
    with torch.inference_mode():
        comm.all_to_all_async, tep.shared_expert_ffn = issue_logged, ffn_logged
        try:
            with rows:
                y = block(mine[None], lp, cfg)[0]
        finally:
            comm.all_to_all_async, tep.shared_expert_ffn = issue, ffn
        # the synchronous block
        if layout == "blocks":
            ref = tep.moe_ffn_ep_quant(mine, lp, cfg, block.ep_cfg, comm)
        else:
            with block.rows(counts):
                send, recv = block._splits()
            moved = comm.all_to_all(mine, recv, send)
            ref = comm.all_to_all(tep.moe_ffn_ep_quant(moved, lp, cfg, block.ep_cfg,
                                                       comm), send, recv)
        if mine.shape[0]:
            ref = ref + shared_expert_ffn(mine, lp, cfg)
    return bool(torch.equal(y, ref)), events, int(mine.shape[0])


def guarded_graph_bodies(rank, world, ep, spec, params_np, impl_kw, ecfg_kw, prompts):
    """The mesh Engine with its graphs' bodies run under
    ``_torch_host_guard.HostReadGuard`` (the kernels' plain versions
    exempt): submit_batch, a submit into each rank's slot (owner and
    follower graphs) and two decode steps -> the graphs' names whose body ran
    guarded."""
    from _torch_host_guard import HostReadGuard, exempt_plain_versions
    from mxmoe_tpu_torch.params_from_jax import params_from_jax
    from mxmoe_tpu_torch.serving import graph as tgraph
    from mxmoe_tpu_torch.serving.engine import Engine, EngineConfig

    mesh = expert_mesh(ep)
    if rank >= ep:
        return None
    replaced = []

    def set_(obj, name, value):
        replaced.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    guard = HostReadGuard()
    ran = set()
    replay = tgraph._Graphed._replay

    def guarded(self):
        ran.add(type(self).__name__)
        with guard:
            replay(self)

    try:
        exempt_plain_versions(guard, set_)
        set_(tgraph._Graphed, "_replay", guarded)
        eng = Engine(params_from_jax(params_np, "cpu"), model_config(spec),
                     EngineConfig(**ecfg_kw), _impl(impl_kw), mesh=mesh)
        with torch.inference_mode():
            eng.submit_batch(prompts[:1], max_new_tokens=3)
            for p in prompts[1:ep]:
                eng.submit(p, max_new_tokens=3)
            eng.step()
            eng.step_chunk(2)
    finally:
        for obj, name, value in reversed(replaced):
            setattr(obj, name, value)
    return sorted(ran)


def tp_forward(rank, world, dp, ep, spec, params_np, toks_np, layout="blocks"):
    """make_tp_forward over a ("data", "expert") = (dp, ep) mesh of every
    rank, on this rank's data block of the tokens -> its logits. ``layout``
    "blocks" slices the params by ``shard_params`` (gate block r, then up
    block r); "contiguous" cuts every split dim in one contiguous block,
    gate_up's columns too."""
    from mxmoe_tpu_torch.params_from_jax import params_from_jax
    from mxmoe_tpu_torch.parallel.mesh import local_slice, param_shardings, shard_params
    from mxmoe_tpu_torch.parallel.sharded import make_tp_forward
    from mxmoe_tpu_torch.models.layers import MoEImpl

    mesh = DeviceMesh("cpu", torch.arange(dp * ep).reshape(dp, ep),
                      mesh_dim_names=("data", "expert"))
    cfg = model_config(spec)
    params = params_from_jax(params_np, "cpu")
    if layout == "blocks":
        local = shard_params(params, mesh)
    else:
        specs = param_shardings(params, mesh)
        local = {k: ({n: local_slice(t, specs[k][n], mesh) for n, t in v.items()}
                     if isinstance(v, dict) else local_slice(v, specs[k], mesh))
                 for k, v in params.items()}
    toks = torch.from_numpy(toks_np)
    b = toks.shape[0] // dp
    d = mesh.get_local_rank("data")
    fwd = make_tp_forward(cfg, mesh, MoEImpl(gmm_backend="pallas"))
    with torch.inference_mode():
        return fwd(local, toks[d * b:(d + 1) * b]).numpy()
