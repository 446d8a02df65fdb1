"""Every token the Engine produced in the window (first tokens from
``submit`` and one a step for each active slot), over the window's seconds."""


def read(run):
    n = sum(1 for s in run.requests for t in s.token_t if run.in_window(t))
    return n / run.window_s if n else None
