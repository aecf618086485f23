"""Device milliseconds a step of the optimizer's kernels (`kernels/optimizer.py`)."""


def read(win):
    s = win.trace.by_function.get("optimizer", 0.0)
    return 1e3 * s / win.units if s > 0.0 else None
