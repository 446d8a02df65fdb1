"""90th percentile, over the requests whose first token reached the host in
the window, of the time from issue to that token."""

from benchmark.core.stats import percentile


def read(run):
    return percentile([(s.token_t[0] - s.issue_t) * 1e3 for s in run.requests
                       if s.token_t and not s.req.in_flight and run.in_window(s.token_t[0])], 90)
