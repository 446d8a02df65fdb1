"""Timing one call on the card, two ways, both with the L2 cache overwritten
before each call (on the serving path every layer brings its own weights, so
a kernel finds them in device memory, not in the cache a repeat left):

- ``event_ms``: CUDA events around the call, median over the repeats. The
  window holds whatever the call does on the host while the card waits (a
  wrapper's ctypes arguments, ``torch.empty``, checks), which for a kernel of
  ~0.05 ms can be a large share.
- ``device_ms``: the sum of the durations of the CUDA kernels the call
  launched, from ``torch.profiler`` (CUPTI), median over the repeats,
  profiled a few calls at a time. Each call's kernels are found between two
  marker kernels
  (``torch.cuda._sleep``, "spin_kernel"): one after the overwrite, one
  before the next.

Both need a card.
"""

from __future__ import annotations

import statistics

_L2_FLUSH = []


def _flush_buffer():
    import torch

    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(128 << 20, dtype=torch.int8,
                                     device=torch.device("cuda")))
    return _L2_FLUSH[0]


def event_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median time of one call between two CUDA events."""
    import torch

    flush = _flush_buffer()
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _profiled_calls(fn, reps: int, overwrite: str = "write"):
    """One profiled run of ``reps`` calls -> each call's summed kernel
    durations (ms), or None when the trace lost marker kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = _flush_buffer()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            torch.cuda._sleep(100)
            if overwrite == "write":
                flush.zero_()
            else:
                flush.sum()
            torch.cuda._sleep(100)
            fn()
        torch.cuda._sleep(100)
        torch.cuda.synchronize()
    evs = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda t: t[0])
    marks = [i for i, e in enumerate(evs) if "spin_kernel" in e[2]]
    if len(marks) != 2 * reps + 1:
        return None
    per_call = []
    for r in range(reps):
        kernels = evs[marks[2 * r + 1] + 1: marks[2 * r + 2]]
        if not kernels:
            raise RuntimeError("device_ms: a call launched no kernel")
        per_call.append(sum(end - start for start, end, _ in kernels) / 1e3)
    return per_call


SESSION_REPS = 5     # calls in one profiled run
LOST_TRACES = [0]    # profiled runs taken again because they lost markers


def device_ms(fn, reps: int = 25, warmup: int = 3, attempts: int = 20,
              overwrite: str = "write") -> float:
    """Median over the repeats of the summed kernel durations of one call,
    profiled ``SESSION_REPS`` calls at a time. A run whose trace lost marker
    kernels (the profiler dropped activity records) cannot be cut into calls:
    it is taken again, up to ``attempts`` times (counted in
    ``LOST_TRACES``; on an H100 one call once lost 5 runs in a row).
    ``overwrite``: "write" (``zero_``, the L2 left full of dirty lines that
    the call's traffic must write back) or "read" (a sum over the buffer:
    clean lines, nothing to write back)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    while len(per_call) < reps:
        n = min(SESSION_REPS, reps - len(per_call))
        for _ in range(attempts):
            got = _profiled_calls(fn, n, overwrite)
            if got is not None:
                per_call += got
                break
            LOST_TRACES[0] += 1
        else:
            raise RuntimeError(f"device_ms: {attempts} traces in a row lost "
                               "marker kernels")
    return statistics.median(per_call)
