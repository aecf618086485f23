"""The ten hand-written kernels' least time at a training step's shapes
(`calls.train_calls`) over their device time in the trace, %."""
from portbench import calls, readers


def read(win):
    cfg, mix = win.cell.config, win.cell.mix
    return readers.roofline(win, calls.train_calls(cfg, mix["batch"], cfg["image_size"]))
