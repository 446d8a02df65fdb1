"""Where a decode step's time goes on the card: ``torch.profiler`` over a
few steady decode steps of a ``bench_serving`` configuration.

  python -m mxmoe_tpu_torch.serving.profile_decode --layers 24 --slots 4 \\
      --max-len 2048 --quant mixed-packed --int8-kv

The arguments and the set-up are ``bench_serving``'s.

Prints one JSON line: the step's wall time without the profiler (CUDA
events ended by a synchronize), the device time of all kernels per step and
the busy share the two make, and device ms and launches per step by kernel
name (the largest first, the tail summed as ``other``). Needs a card: the
numbers are device metrics.
"""

from __future__ import annotations

import json
import subprocess

from . import bench_serving

STEPS = 8     # profiled decode steps
TOP = 16      # kernel names listed


def main(argv=None):
    args = bench_serving.make_parser().parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, prefill, decoder = bench_serving.setup(args)
    with torch.no_grad():
        decode_steps = decoder(*prefill())
        decode_steps(3)                                              # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        decode_steps(STEPS)
        end.record()
        end.synchronize()
        step_ms = start.elapsed_time(end) / STEPS

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            decode_steps(STEPS)
            torch.cuda.synchronize()

    by_name: dict[str, list[float]] = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        # "void (anonymous namespace)::kernel<T, n>(args)" -> "kernel<T, n>"
        name = evt.name.replace("(anonymous namespace)::", "").removeprefix("void ")
        rec = by_name.setdefault(name.split("(")[0][-96:], [0.0, 0])
        rec[0] += evt.time_range.elapsed_us() / 1e3
        rec[1] += 1
    if not by_name:
        raise RuntimeError("the profiler recorded no device activity")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    device_ms = sum(ms for ms, _ in by_name.values()) / STEPS
    rows = [{"kernel": name, "ms_per_step": ms / STEPS,
             "launches_per_step": n / STEPS} for name, (ms, n) in ranked[:TOP]]
    rest = ranked[TOP:]
    rows.append({"kernel": "other", "ms_per_step": sum(v[0] for _, v in rest) / STEPS,
                 "launches_per_step": sum(v[1] for _, v in rest) / STEPS})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({
        "model": args.model, "layers": args.layers, "slots": args.slots,
        "quant": args.quant, "int8_kv": args.int8_kv, "fused_ffn": args.fused_ffn,
        "decode_attn": args.decode_attn,
        "prefill": args.prefill,
        "steps": STEPS, "step_ms": step_ms, "device_ms_per_step": device_ms,
        "busy_share": device_ms / step_ms,
        "launches_per_step": sum(n for _, n in by_name.values()) / STEPS,
        "kernels": rows, "nvidia_smi": smi.splitlines()[0]}))


if __name__ == "__main__":
    main()
