"""Where a decode step's time goes on the card: the eager step and the
captured one (``graph.DecodeGraph``) side by side, with ``torch.profiler``
over a few steady decode steps of a ``bench_serving`` configuration.

  python -m mxmoe_tpu_torch.serving.profile_decode --layers 24 --slots 4 \\
      --max-len 2048 --quant mixed-packed --int8-kv

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

Prints one JSON line: each arm's turns and their means, the graph's
warm-up, capture and instantiate seconds, the peak device memory, and the
captured arm's device ms and launches a step by kernel name (the largest
first, the tail summed as ``other``). Needs a card: the numbers are device
metrics.
"""

from __future__ import annotations

import json
import statistics
import subprocess

from . import bench_serving
from .kv_cache import clone_cache

STEPS = 16    # decode steps a timed or profiled window
TOP = 16      # kernel names listed
ORDER = ("eager", "captured", "captured", "eager")
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
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            host_calls += evt.name.startswith(HOST_LAUNCH_CALLS)
            continue
        rec = by_name.setdefault(_kernel_name(evt.name), [0.0, 0])
        rec[0] += evt.time_range.elapsed_us() / 1e3
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


def main(argv=None):
    args = bench_serving.make_parser().parse_args(argv)

    import torch

    _, prefill, decoder = bench_serving.setup(args)
    with torch.no_grad():
        logits, cache = prefill()
        eager = decoder(logits, clone_cache(cache), captured=False)
        torch.cuda.reset_peak_memory_stats()
        captured = decoder(logits, clone_cache(cache))
        res = abba({"eager": eager, "captured": captured})
    ranked = sorted(res["captured"].pop("by_name").items(), key=lambda kv: -kv[1][0])
    res["eager"].pop("by_name")
    rows = [{"kernel": name, "ms_per_step": ms, "launches_per_step": n}
            for name, (ms, n) in ranked[:TOP]]
    rest = ranked[TOP:]
    rows.append({"kernel": "other", "ms_per_step": sum(v[0] for _, v in rest),
                 "launches_per_step": sum(v[1] for _, v in rest)})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    g = captured.graph
    graph = {"warmup_s": g.warmup_s, "capture_s": g.capture_s,
             "instantiate_s": g.instantiate_s}
    print(json.dumps({
        "model": args.model, "layers": args.layers, "slots": args.slots,
        "quant": args.quant, "int8_kv": args.int8_kv, "fused_ffn": args.fused_ffn,
        "decode_attn": args.decode_attn, "prefill": args.prefill,
        "steps": STEPS, "order": ORDER, "arms": res, "graph": graph,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "kernels": rows, "nvidia_smi": smi.splitlines()[0]}))


if __name__ == "__main__":
    main()
