"""The device: the share of the profiled sub-window in which no operation
ran, 1 - (the union of device intervals) / the sub-window, in percent."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
