"""``torch.cuda.max_memory_allocated()`` from its reset when the window
opened to the window's end, in 10^9 bytes: what serving holds."""


def read(run):
    return run.peak_window_bytes / 1e9 if run.peak_window_bytes else None
