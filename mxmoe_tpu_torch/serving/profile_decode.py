"""Where a decode step's or a prefill chunk's time goes on the card: the
eager step and the captured one (``graph.DecodeGraph``), or the eager chunk
and the captured one (``graph.PrefillGraph``), side by side, with
``torch.profiler`` over a few steady steps of a ``bench_serving``
configuration.

  python -m mxmoe_tpu_torch.serving.profile_decode --layers 24 --slots 4 \\
      --max-len 2048 --quant mixed-packed --int8-kv [--arm prefill --prefill 256] \\
      [--mesh 1]

The arguments and the set-up are ``bench_serving``'s. Two arms decode, each
from its own copy of one prefill's cache: ``eager`` (a ``forward_cached``
call a step) and ``captured`` (one replay of the captured step a step, what
``Engine`` and ``decode_scan`` run), in the order eager, captured,
captured, eager. Each turn times ``STEPS`` steps
with CUDA events ended by a synchronize (wall ms a step), then profiles
``STEPS`` more: the device time of all kernels a step (device ms), the busy
share the two make, the kernels the device ran a step, and the host's
launch calls a step (CUDA runtime launches, graph launches, copies and
sets, as the profiler records them).

With ``--arm prefill`` the two arms run ``bench_serving``'s chunk, all
slots' ``--prefill`` tokens from the empty cache (its lengths reset before
each chunk, so every chunk writes the same positions), each on its own copy
of the cache, ``PREFILL_STEPS`` chunks a window; then the time to the first
token of one ``TTFT_PROMPT``-token prompt through ``Engine.submit`` in
``TTFT_CHUNK``-token chunks (the chunks, the copy into the slot and the
first sample, ended by the host's read of the token), eager and captured
Engines in the same order (``ttft``).

With ``--mesh 1`` the same model is also served by a one-rank NCCL mesh
``Engine`` (its own process group on localhost; experts resharded for the
rank, the EP block in every MoE layer): its step (or chunk) eager and
captured, each on its own copy of the cache, timed in turns beside the
one-device captured one (``MESH_ORDER``); the prefill arm runs the chunk
inside ``EPMoEBlock.rows`` as ``Engine.submit`` does (with ``--slots 1``,
submit's chunk), and the time to the first token goes through the mesh
Engine's ``submit`` (``ttft`` with ``mesh``).

Prints one JSON line: each arm's turns and their means, the graph's
warm-up, capture and instantiate seconds, the peak device memory, and the
captured arm's device ms and launches a step by kernel name (the largest
first, the tail summed as ``other``; ``mesh_kernels`` the captured mesh
arm's). Needs a card: the numbers are device metrics.
"""

from __future__ import annotations

import json
import statistics
import subprocess

from . import bench_serving
from .kv_cache import clone_cache

STEPS = 16    # decode steps a timed or profiled window
PREFILL_STEPS = 4   # prefill chunks a timed or profiled window
TTFT_PROMPT, TTFT_CHUNK, TTFT_TURNS = 512, 256, 3
TOP = 16      # kernel names listed
ORDER = ("eager", "captured", "captured", "eager")
MESH_ORDER = ("mesh_eager", "mesh_captured", "captured", "captured",
              "mesh_captured", "mesh_eager")
# host-side calls that put work on the device
HOST_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch",
                     "cudaMemcpy", "cudaMemset")


def _kernel_name(name: str) -> str:
    # "void (anonymous namespace)::kernel<T, n>(args)" -> "kernel<T, n>"
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0][-96:]


def window(decode_steps, steps: int = STEPS) -> dict:
    """One turn of an arm: wall ms a step over ``steps`` steps (CUDA events
    ended by a synchronize), then ``steps`` more under ``torch.profiler``:
    device ms, kernels and host launch calls a step, and device ms and
    launches a step by kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    decode_steps(steps)
    end.record()
    end.synchronize()
    wall = start.elapsed_time(end) / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decode_steps(steps)
        torch.cuda.synchronize()
    by_name: dict[str, list[float]] = {}
    host_calls = 0
    # the profiler's raw records, as ``prof.events()`` keeps them (hidden
    # ones left out; a record's name demangled), without building its event
    # tree: 40x faster on a window of ~10^5 records
    for evt in prof.profiler.kineto_results.events():
        if getattr(evt, "is_hidden_event", lambda: False)():
            continue
        if evt.device_type() != DeviceType.CUDA:
            host_calls += evt.name().startswith(HOST_LAUNCH_CALLS)
            continue
        rec = by_name.setdefault(_kernel_name(torch._C._demangle(evt.name())), [0.0, 0])
        rec[0] += evt.duration_ns() / 1e6
        rec[1] += 1
    if not by_name:
        raise RuntimeError("the profiler recorded no device activity")
    device = sum(ms for ms, _ in by_name.values()) / steps
    return {"wall_ms": wall, "device_ms": device, "busy_share": device / wall,
            "kernels_per_step": sum(n for _, n in by_name.values()) / steps,
            "host_launch_calls_per_step": host_calls / steps,
            "by_name": {k: [ms / steps, n / steps] for k, (ms, n) in by_name.items()}}


def abba(arms: dict, order=ORDER, steps: int = STEPS) -> dict:
    """``arms``: name -> decode_steps(n). Each arm's turns in ``order``
    (each warmed up by one window's steps first, untimed) and the means of
    its turns."""
    for fn in arms.values():
        fn(steps)                       # warm-up (a graph's capture)
    turns = {name: [] for name in arms}
    for name in order:
        turns[name].append(window(arms[name], steps))
    out = {}
    for name, ts in turns.items():
        keys = ("wall_ms", "device_ms", "busy_share", "kernels_per_step",
                "host_launch_calls_per_step")
        out[name] = {"turns": [{k: t[k] for k in keys} for t in ts],
                     **{k: statistics.fmean(t[k] for t in ts) for k in keys}}
        by_name: dict = {}
        for t in ts:
            for k, (ms, n) in t["by_name"].items():
                rec = by_name.setdefault(k, [0.0, 0.0])
                rec[0] += ms / len(ts)
                rec[1] += n / len(ts)
        out[name]["by_name"] = by_name
    return out


def prefill_arms(params, cfg, impl, cache, tokens, valid, pool=None):
    """The eager and the captured prefill chunk of ``tokens`` [B, P] with
    ``valid`` [B] over two copies of ``cache`` (the lengths it holds are
    restored before every chunk, so each writes the same positions) ->
    ({"eager": steps(n), "captured": steps(n)}, the graph, (eager cache,
    captured cache)). ``steps`` returns the last chunk's logits."""
    import torch

    from .decode import forward_cached
    from .graph import PrefillGraph

    lengths = cache.lengths.clone()
    caches = (clone_cache(cache), clone_cache(cache))
    graph = PrefillGraph(params, cfg, impl, caches[1], tokens.shape[1], pool)
    graph.load(tokens, valid)

    def eager(n):
        c = caches[0]
        for _ in range(n):
            c.lengths.copy_(lengths)
            with torch.no_grad():
                logits, out = forward_cached(params, tokens, c, cfg, impl,
                                             valid_lengths=valid)
            c.lengths.copy_(out.lengths)
        return logits

    def captured(n):
        for _ in range(n):
            graph.cache.lengths.copy_(lengths)
            logits = graph.run()
        return logits

    return {"eager": eager, "captured": captured}, graph, caches


def ttft(params, cfg, impl, int8_kv: bool, max_len: int, prompt_len: int = TTFT_PROMPT,
         chunk: int = TTFT_CHUNK, turns: int = TTFT_TURNS, order=ORDER,
         mesh=None, ep_cfg=None) -> dict:
    """Time to the first token of one ``prompt_len``-token prompt (seeded)
    through ``Engine.submit`` in ``chunk``-token chunks for an eager Engine
    (``cuda_graphs=False``) and a captured one (``first_token_times``).
    ``mesh`` / ``ep_cfg``: both Engines serve over the mesh (one slot a
    rank)."""
    import numpy as np

    from .engine import Engine, EngineConfig

    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, prompt_len).tolist()
    slots = 1 if mesh is None else mesh.size()
    engines = {arm: Engine(params, cfg, EngineConfig(
        batch_slots=slots, max_len=max_len, prefill_chunk=chunk, int8_kv=int8_kv,
        cuda_graphs=arm == "captured"), impl, mesh=mesh, ep_cfg=ep_cfg)
        for arm in ("eager", "captured")}
    try:
        return first_token_times(engines, prompt, turns, order)
    finally:
        for eng in engines.values():
            eng.close()


def first_token_times(engines: dict, prompt: list, turns: int = TTFT_TURNS,
                      order=ORDER) -> dict:
    """``engines``: {"eager": Engine, "captured": Engine}, their slots free.
    Host clock from ``submit(prompt)`` to its return (the first token read
    on the host), each Engine warmed up by one submit first (the captured
    one's capture); ``turns`` submits a turn in ``order``; each submit's
    slot is freed by one decode step, untimed -> {arm: {"ms": [...],
    "median_ms": m}, "tokens_equal": bool}."""
    import time

    import torch

    times = {arm: [] for arm in engines}
    first = {}

    def one(arm):
        eng = engines[arm]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rid = eng.submit(prompt, max_new_tokens=1)
        ms = (time.perf_counter() - t0) * 1e3
        slot = next(s for s in eng.slots if s.request_id == rid)
        first.setdefault(arm, slot.generated[0])
        eng.run_to_completion()
        return ms

    for arm in engines:
        one(arm)
    for arm in order:
        times[arm] += [one(arm) for _ in range(turns)]
    out = {arm: {"ms": ts, "median_ms": statistics.median(ts)} for arm, ts in times.items()}
    out["tokens_equal"] = first["eager"] == first["captured"]
    return out


def one_rank_mesh():
    """A one-rank NCCL process group of this process's own (on localhost)
    -> its 1-D "expert" DeviceMesh; ``torch.distributed.destroy_process_group``
    ends it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ..parallel.multihost import free_port

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    return DeviceMesh("cuda", [0], mesh_dim_names=("expert",))


def in_rows(block, counts, steps):
    """``steps(n)`` run inside ``block.rows(counts)`` (the EP block's row
    layout of one slot's prefill)."""
    def run(n):
        with block.rows(counts):
            return steps(n)
    return run


def _ranked(by_name: dict) -> list:
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    rows = [{"kernel": name, "ms_per_step": ms, "launches_per_step": n}
            for name, (ms, n) in ranked[:TOP]]
    rest = ranked[TOP:]
    rows.append({"kernel": "other", "ms_per_step": sum(v[0] for _, v in rest),
                 "launches_per_step": sum(v[1] for _, v in rest)})
    return rows


def main(argv=None):
    ap = bench_serving.make_parser()
    ap.add_argument("--arm", default="decode", choices=("decode", "prefill"),
                    help="time decode steps, or prefill chunks and the time to "
                         "the first token")
    ap.add_argument("--mesh", type=int, default=0, choices=(0, 1),
                    help="1: also the one-rank NCCL mesh Engine's step or chunk, "
                         "eager and captured, beside the one-device captured one")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    bench = bench_serving.setup(args)
    extra = {}
    mesh = eng = g = mg = None
    arms = {}
    if args.mesh:
        from ..parallel.ep import EPConfig
        from .engine import Engine, EngineConfig

        mesh = one_rank_mesh()
        ep_cfg = EPConfig(capacity_factor=4.0, return_stats=True)
        eng = Engine(bench.params, bench.cfg, EngineConfig(
            batch_slots=args.slots, max_len=args.max_len, prefill_chunk=args.prefill,
            int8_kv=args.int8_kv), bench.impl, mesh=mesh, ep_cfg=ep_cfg)
    try:
        with torch.no_grad():
            if args.arm == "decode":
                logits, cache = bench.prefill()
                arms = {"captured": bench.decoder(logits, clone_cache(cache))}
                if eng is None:
                    arms["eager"] = bench.decoder(logits, clone_cache(cache),
                                                  captured=False)
                else:
                    model = (eng.params, eng.impl)
                    arms["mesh_eager"] = bench.decoder(logits, clone_cache(cache),
                                                       captured=False, model=model)
                    arms["mesh_captured"] = bench.decoder(logits, clone_cache(cache),
                                                          model=model)
                torch.cuda.reset_peak_memory_stats()
                res = abba(arms, ORDER if eng is None else MESH_ORDER)
                g = arms["captured"].graph
                mg = arms["mesh_captured"].graph if eng is not None else None
                steps = STEPS
            else:
                valid = torch.full((args.slots,), args.prefill, dtype=torch.int32,
                                   device=bench.device)
                torch.cuda.reset_peak_memory_stats()
                arms, g, _ = prefill_arms(bench.params, bench.cfg, bench.impl,
                                          bench.cache0, bench.ptoks, valid, bench.pool)
                if eng is not None:
                    m_arms, mg, _ = prefill_arms(eng.params, bench.cfg, eng.impl,
                                                 bench.cache0, bench.ptoks, valid,
                                                 bench.pool)
                    counts = [args.slots * args.prefill]
                    arms = {"captured": arms["captured"],
                            **{f"mesh_{k}": in_rows(eng.impl.ep_moe, counts, f)
                               for k, f in m_arms.items()}}
                res = abba(arms, ORDER if eng is None else MESH_ORDER,
                           steps=PREFILL_STEPS)
                steps = PREFILL_STEPS
                extra["ttft"] = ttft(bench.params, bench.cfg, bench.impl, args.int8_kv,
                                     args.max_len)
                if eng is not None:
                    extra["mesh_ttft"] = ttft(bench.params, bench.cfg, bench.impl,
                                              args.int8_kv, args.max_len, mesh=mesh,
                                              ep_cfg=eng.ep_cfg)
    finally:
        if mesh is not None:
            # the communicator waits, when destroyed, for every graph that
            # holds its kernels
            for gr in (g, mg, *(getattr(f, "graph", None) for f in arms.values())):
                if gr is not None:
                    gr.release()
            eng.close()
            dist.destroy_process_group()
    rows = _ranked(res["captured"].pop("by_name"))
    if mg is not None:
        extra["mesh_kernels"] = _ranked(res["mesh_captured"].pop("by_name"))
        extra["mesh_graph"] = {"warmup_s": mg.warmup_s, "capture_s": mg.capture_s,
                               "instantiate_s": mg.instantiate_s}
    for arm in res.values():
        arm.pop("by_name", None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    graph = {"warmup_s": g.warmup_s, "capture_s": g.capture_s,
             "instantiate_s": g.instantiate_s}
    print(json.dumps({
        "arm": args.arm, "model": args.model, "layers": args.layers,
        "slots": args.slots, "quant": args.quant, "int8_kv": args.int8_kv,
        "fused_ffn": args.fused_ffn, "decode_attn": args.decode_attn,
        "prefill": args.prefill, "mesh": args.mesh, "steps": steps,
        "order": ORDER if eng is None else MESH_ORDER, "arms": res,
        "graph": graph, **extra,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "kernels": rows, "nvidia_smi": smi.splitlines()[0]}))


if __name__ == "__main__":
    main()
