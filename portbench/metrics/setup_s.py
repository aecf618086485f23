"""Seconds from the process's start to the window's start: imports, the
kernels' build or load, weights, inputs, warm-up and (training) the checked
first steps."""


def read(win):
    return win.setup_s
