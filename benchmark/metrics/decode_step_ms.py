"""The decode graph through ``Engine.step``: mean wall milliseconds of the
steps in the window outside the profiled sub-window (the token read
included)."""


def read(run):
    spans = [s for s in run.spans if s.name == "step" and not s.traced and run.in_window(s.t1)]
    return sum(s.t1 - s.t0 for s in spans) / len(spans) * 1e3 if spans else None
