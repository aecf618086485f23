"""The five forward kernels' least time at a forward's shapes
(`calls.main_path_calls`) over their device time in the trace, %."""
from portbench import calls, readers


def read(win):
    cfg, mix = win.cell.config, win.cell.mix
    return readers.roofline(win, calls.main_path_calls(cfg, mix["batch"], cfg["image_size"]))
