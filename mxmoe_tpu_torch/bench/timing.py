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
  before the next. Where the profiler has run in a process and a backward
  pass (any torch autograd loop) runs after it, the first kernel launched
  in each later profiled run goes missing from its trace, so each run
  starts with ``LEAD_IN`` small kernels of its own before the first marker
  (``chip_smoke.py``'s ``timing`` line counts the runs that lose a marker
  before the anchor's training, and after it without and with them). A
  trace can also lose other records now and then (none at all, or some of
  a call's kernels): such a run is taken again.

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


LEAD_IN = 2    # kernels a profiled run launches before its first marker


def lead_in(flush) -> None:
    """The first kernels of a profiled run, which its trace may drop: small
    fills of ``flush``, before the first marker."""
    for _ in range(LEAD_IN):
        flush[:4096].zero_()


def _profiled_calls(fn, reps: int, overwrite: str = "write", lead: bool = True):
    """One profiled run of ``reps`` calls -> each call's (kernels in its
    window, summed kernel durations in ms), or None when the trace lost
    marker kernels or a call's kernels (the calls' kernel counts differ, or
    a window holds none). ``lead`` False leaves out the lead-in (to show
    what it guards against)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = _flush_buffer()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if lead:
            lead_in(flush)
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
    windows = [evs[marks[2 * r + 1] + 1: marks[2 * r + 2]] for r in range(reps)]
    if not windows[0] or any(len(w) != len(windows[0]) for w in windows):
        return None
    return [(len(w), sum(end - start for start, end, _ in w) / 1e3) for w in windows]


SESSION_REPS = 5     # calls in one profiled run
LOST_TRACES = [0]    # profiled runs taken again because they lost records


def device_ms(fn, reps: int = 25, warmup: int = 3, attempts: int = 20,
              overwrite: str = "write") -> float:
    """Median over the repeats of the summed kernel durations of one call,
    profiled ``SESSION_REPS`` calls at a time. A run whose trace lost
    records (marker kernels, or some of a call's kernels) is taken again
    (counted in ``LOST_TRACES``), and a call is kept only at the most
    kernels any call showed; ``attempts`` lost runs in a row raise (as
    does a call that launches no kernel).
    ``overwrite``: "write" (``zero_``, the L2 left full of dirty lines that
    the call's traffic must write back) or "read" (a sum over the buffer:
    clean lines, nothing to write back)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    calls, misses = [], 0
    while True:
        most = max((k for k, _ in calls), default=0)
        kept = [ms for k, ms in calls if k == most]
        if len(kept) >= reps:
            return statistics.median(kept[:reps])
        got = _profiled_calls(fn, SESSION_REPS, overwrite)
        if got is None:
            LOST_TRACES[0] += 1
            misses += 1
            if misses == attempts:
                raise RuntimeError(f"device_ms: {attempts} traces in a row lost "
                                   "marker kernels or a call's kernels")
            continue
        misses = 0
        calls += got
