"""90th percentile, over the requests with at least two tokens in the
window, of the time per output token after the first, from their tokens in
the window (a request's decode stalls behind other requests' prefill
included)."""

from benchmark.core.stats import percentile


def read(run):
    out = []
    for s in run.requests:
        ts = [t for t in s.token_t if run.in_window(t)]
        if len(ts) >= 2:
            out.append((ts[-1] - ts[0]) / (len(ts) - 1) * 1e3)
    return percentile(out, 90)
