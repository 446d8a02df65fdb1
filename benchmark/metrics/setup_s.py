"""Seconds from the process's start to the window: imports, the kernel
library (built in a checkout's first run), the weights drawn and quantized,
the Engine, the slots filled and the warm-up steps."""


def read(run):
    return run.setup_s
