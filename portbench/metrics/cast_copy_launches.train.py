"""Copy and cast device events a training step (names holding "copy":
PyTorch's copy kernels, which also cast, and memory copies)."""


def read(win):
    return win.trace.copy_events / win.units
