"""Grouped GEMMs (``ops/gmm*.py``, ``csrc/gmm_*.cu``): device milliseconds of
the ``kernel_families/gmm.json`` kernels that start inside ``Engine.step``
calls of the profiled sub-window, per step."""


def read(run):
    if run.trace is None or not run.trace.ranges.get("bm.step"):
        return None
    s = run.trace.device_s_in("bm.step", run.kernel_patterns("gmm"))
    return s / len(run.trace.ranges["bm.step"]) * 1e3 if s else None
