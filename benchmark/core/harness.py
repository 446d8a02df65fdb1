"""One run of one cell: set-up, the measured window, the check, the metrics
and the result line."""

from __future__ import annotations

import dataclasses
import gc
import time

import torch

from . import check, serve, spec
from . import trace as tracing
from .arch import Arch, arch_of
from .traffic import Traffic


@dataclasses.dataclass
class RunData:
    """What a metric reader (``metrics/<name>.py``) reads."""
    cell: spec.Cell
    arch: Arch
    setup_s: float
    t0: float                      # the window on the host clock
    t1: float
    requests: list                 # serve.Served
    spans: list                    # serve.Span
    peak_window_bytes: int         # max_memory_allocated, reset when the window opened
    trace: tracing.Trace | None    # the traced sub-window (``--trace 1``)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def in_window(self, t: float) -> bool:
        return self.t0 < t <= self.t1

    def kernel_patterns(self, family: str) -> list[str]:
        return spec.kernel_family(self.cell, family)["patterns"]


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False,
        clock=time.perf_counter) -> tuple[dict, list[str]]:
    """-> (the result line's object, the lines of the numbers compared).
    ``t_start`` is the process's start on ``clock``, which times the run
    (tests pass a counter, so that a CPU rehearsal is deterministic)."""
    a = arch_of(cell.config)
    engine = serve.build_engine(a, cell.config["serving"], cell.traffic, seed, device)
    loop = serve.Loop(engine, Traffic(cell.traffic, seed, a.vocab), clock)
    with torch.no_grad():
        serve.open_window(loop, int(cell.settings.get("warm_steps", 2)))
        if trace:
            serve.warm_profiler(device)
        serve.sync(device)
        setup_peak = _peak(device)
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = clock() - t_start
        win = serve.run_window(loop, seconds, cell.settings["trace"] if trace else None,
                               device)
        loop.close()
        serve.sync(device)
    window_peak = _peak(device)
    tr = tracing.read(win.pop("prof")) if trace else None
    t0, t1 = win["t0"], win["t1"]
    attempted = sum(1 for s in loop.requests
                    if s.req.in_flight or (s.admit_t is not None and t0 < s.admit_t <= t1))
    engine.close()
    del engine, loop.eng
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    with torch.no_grad():
        compared = check.check(cell, a, loop.requests, seed, device, control)
    check_s = time.perf_counter() - t_check
    data = RunData(cell, a, setup_s, t0, t1, loop.requests, loop.spans, window_peak, tr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(cell, m["name"])(data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device) if torch.device(device).type == "cuda"
                    else "cpu"),
           "count": int(cell.entry.get("chips", 1)),
           "memory_peak_bytes": max(setup_peak, window_peak)}
    result = {"correct": check.passes(compared, control), "attempted": attempted,
              "failed": 0, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s(), tr.window_s
        result["breakdown"] = tr.breakdown()
    result["compared"] = compared
    return result, [_summary(data, setup_peak, check_s)] + check.lines(compared)


def _summary(run: RunData, setup_peak: int, check_s: float) -> str:
    """The sample counts behind the metrics, set-up's peak, the check's time."""
    first = sum(1 for s in run.requests
                if s.token_t and not s.req.in_flight and run.in_window(s.token_t[0]))
    multi = sum(1 for s in run.requests
                if sum(1 for t in s.token_t if run.in_window(t)) >= 2)
    steps = sum(1 for s in run.spans if s.name == "step" and run.in_window(s.t1))
    tokens = sum(1 for s in run.requests for t in s.token_t if run.in_window(t))
    return (f"window {run.window_s:.3f} s: {tokens} tokens, {steps} steps, "
            f"{first} first tokens (ttft samples), {multi} requests with 2+ tokens "
            f"(tpot samples); set-up {run.setup_s:.3f} s, set-up peak "
            f"{setup_peak / 1e9:.3f} GB; check {check_s:.3f} s")
