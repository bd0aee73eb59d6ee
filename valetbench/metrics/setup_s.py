"""Seconds from the process's start to the window's start: imports, the
CUDA context, the kernels' load (and build, in a checkout's first run),
the weights, the engine and the warm-up steps."""
DEVICE = True


def read(run):
    return run.setup_s
