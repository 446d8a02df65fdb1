"""The traced sub-window: the profiler's records -> device intervals, the
benchmark's ``bm.*`` ranges, the busy and idle time and the breakdown.

The records are read raw (``prof.profiler.kineto_results.events()``), which
skips building the profiler's event tree. Device records are every CUDA
activity (kernels, copies, sets) but the profiler's own echoes of the
``bm.*`` ranges on the device. Times are seconds on the profiler's clock.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re

import torch

from .stats import covered, gaps, union

HOST_LABELS = ("bm.submit", "bm.step")


@dataclasses.dataclass
class Trace:
    window: tuple[float, float]                 # the bm.window range
    device: list[tuple[float, float, str]]      # (start, end, kernel name)
    ranges: dict[str, list[tuple[float, float]]]  # bm.* name -> ranges

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        return covered([(s, e) for s, e, _ in self.device], *self.window)

    def device_s_in(self, range_name: str, patterns: list[str]) -> float:
        """Device seconds of the kernels whose name matches a pattern and
        that start inside a ``range_name`` range."""
        rx = [re.compile(p) for p in patterns]
        spans = sorted(self.ranges.get(range_name, []))
        starts = [s for s, _ in spans]
        total = 0.0
        for s, e, name in self.device:
            if not any(r.search(name) for r in rx):
                continue
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s < spans[i][1]:
                total += e - s
        return total

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time
        by what the host was doing (the innermost ``bm.submit`` /
        ``bm.step`` range over the gap's middle, else between the calls)."""
        lo, hi = self.window
        by_name: dict = collections.defaultdict(float)
        for s, e, name in self.device:
            s, e = max(s, lo), min(e, hi)
            if e > s:
                by_name[name] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle: dict = collections.defaultdict(float)
        host = {k: union(self.ranges.get(k, []), lo, hi) for k in HOST_LABELS}
        for s, e in gaps([(s, e) for s, e, _ in self.device], lo, hi):
            mid = 0.5 * (s + e)
            label = next((k[3:] for k in HOST_LABELS
                          if any(a <= mid < b for a, b in host[k])), "between calls")
            idle[f"host in {label}"] += e - s
        gaps_out = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps_out]}


def kernel_name(raw: str) -> str:
    """A demangled kernel name without return type, namespace or arguments."""
    name = torch._C._demangle(raw).replace("(anonymous namespace)::", "")
    name = name.removeprefix("void ")
    return name.split("(")[0][-120:]


def read(prof) -> Trace:
    from torch.autograd import DeviceType

    device, ranges = [], collections.defaultdict(list)
    for evt in prof.profiler.kineto_results.events():
        name = evt.name()
        s = evt.start_ns() * 1e-9
        e = s + evt.duration_ns() * 1e-9
        if name.startswith("bm."):
            if evt.device_type() != DeviceType.CUDA:
                ranges[name].append((s, e))
            continue
        if evt.device_type() == DeviceType.CUDA:
            device.append((s, e, kernel_name(name)))
    if not ranges.get("bm.window"):
        raise RuntimeError("the trace holds no bm.window range")
    return Trace(ranges["bm.window"][0], device, dict(ranges))
