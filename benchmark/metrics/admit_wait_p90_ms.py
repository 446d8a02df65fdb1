"""Engine admission: 90th percentile of the wait from a request's issue to
the start of its ``Engine.submit``, over the requests admitted in the window
outside the profiled sub-window."""

from benchmark.core.stats import percentile


def read(run):
    return percentile([(s.admit_t - s.issue_t) * 1e3 for s in run.requests
                       if s.admit_t is not None and not s.req.in_flight and not s.traced
                       and run.in_window(s.admit_t)], 90)
