"""The headline MoE layer's arms kernel by kernel, on one card.

    python -m mxmoe_tpu_torch.bench.headline_profile [--arms onelaunch bucketed w8a8]

Builds ``bench/headline.py``'s operands (the qwen2_moe layer-10 workload,
seed 42) and, for each arm, profiles ``REPS`` calls with ``torch.profiler``
(CUPTI device times), the L2 cache overwritten before each call and the
calls cut apart by marker kernels, as ``bench.timing.device_ms`` does. A
call's kernels come in a fixed order, so each position's duration is the
median over the calls. Prints one JSON line per arm: the kernels in launch
order (a short name and its median device ms), the arm's
summed device ms and its event ms (``bench.timing.event_ms``), then the
card's ``nvidia-smi`` name and power limit. Run it from another tree (a
parent commit unpacked beside) to read that tree's arms on the same card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from . import headline, timing, workloads

REPS = 5


def _short(name: str) -> str:
    """A kernel's name without its namespace, template arguments and
    parameters."""
    name = name.replace("(anonymous namespace)::", "")
    for cut in ("<", "("):
        name = name.split(cut)[0]
    return name.removeprefix("void ").strip()[:80]


def profile_arm(fn, reps: int = REPS) -> list[list[tuple[str, float]]]:
    """``reps`` profiled calls of ``fn`` -> each call's kernels in launch
    order as (name, device ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = timing._flush_buffer()
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            timing.lead_in(flush)
            for _ in range(reps):
                torch.cuda._sleep(100)
                flush.zero_()
                torch.cuda._sleep(100)
                fn()
            torch.cuda._sleep(100)
            torch.cuda.synchronize()
        evs = sorted(((e.time_range.start, e.time_range.end, e.name)
                      for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda t: t[0])
        marks = [i for i, e in enumerate(evs) if "spin_kernel" in e[2]]
        if len(marks) == 2 * reps + 1:
            return [[(_short(n), (b - a) / 1e3)
                     for a, b, n in evs[marks[2 * r + 1] + 1: marks[2 * r + 2]]]
                    for r in range(reps)]
        timing.LOST_TRACES[0] += 1
    raise RuntimeError("headline_profile: five traces in a row lost marker kernels")


def arms(names):
    """name -> the arm's step, on the headline's operands."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(headline.SEED)
    wls = workloads.qwen2_moe_l10_bs8192()
    operands = [headline.build_fp_operands(wl, gen, dev) for wl in wls]
    masks = [np.arange(len(op[2])) % 2 == 0 for op in operands]
    out = {}
    for name in names:
        if name == "onelaunch":
            out[name] = headline.mixed_onelaunch_step(
                headline.quantize_weights_mixed_onelaunch(operands, masks))
        elif name == "bucketed":
            out[name] = headline.mixed_bucketed_step(
                headline.quantize_weights_mixed(operands, masks))
        elif name == "w8a8":
            out[name] = headline.w8a8_step(headline.quantize_weights(operands))
        elif name == "baseline":
            out[name] = headline.baseline_step(operands)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arms", nargs="+", default=["onelaunch", "bucketed", "w8a8"],
                    choices=["onelaunch", "bucketed", "w8a8", "baseline"])
    ap.add_argument("--tag", default="", help="a label printed on every line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("headline_profile: needs a CUDA card")
    with torch.no_grad():
        for name, step in arms(args.arms).items():
            calls = profile_arm(step)
            order = [n for n, _ in calls[0]]
            if any([n for n, _ in c] != order for c in calls):
                raise RuntimeError(f"{name}: the calls launched different kernels")
            kern = [{"name": n, "device_ms": statistics.median(c[i][1] for c in calls)}
                    for i, n in enumerate(order)]
            print(json.dumps({"tag": args.tag, "arm": name, "kernels": kern,
                              "device_ms": sum(k["device_ms"] for k in kern),
                              "event_ms": timing.event_ms(step, 9)}), flush=True)
            torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"tag": args.tag, "nvidia_smi": smi.splitlines()[0],
                      "lost_traces": timing.LOST_TRACES[0]}), flush=True)


if __name__ == "__main__":
    main()
