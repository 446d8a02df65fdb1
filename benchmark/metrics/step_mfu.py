"""The model's share of the configuration's peak over the profiled
sub-window: model operations (``core/flops.py``, from the published widths)
of every prompt and generated token processed in it, over its seconds times
the peak the configuration file states, in percent."""

from benchmark.core import flops


def read(run):
    if run.trace is None:
        return None
    spans = [s for s in run.spans if s.traced]
    ops = sum(flops.token_ops(run.arch, s.tokens, s.keys) for s in spans)
    peak = float(run.cell.config["peak"]["ops_per_s"])
    return 100.0 * ops / (run.trace.window_s * peak) if ops else None
