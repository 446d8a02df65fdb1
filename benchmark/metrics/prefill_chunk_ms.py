"""The prefill graph through ``Engine.submit``: wall milliseconds of all
``submit`` calls in the window outside the profiled sub-window, over their
prefill chunks (the first token's sampling and the copy into the slot
included)."""


def read(run):
    spans = [s for s in run.spans
             if s.name == "submit" and not s.traced and run.in_window(s.t1)]
    chunks = sum(s.chunks for s in spans)
    return sum(s.t1 - s.t0 for s in spans) / chunks * 1e3 if chunks else None
