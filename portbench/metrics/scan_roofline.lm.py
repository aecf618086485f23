"""Kernel #1's least time at the LM's shapes (K = 1, a full-rank dt, one a
layer) over its device time in the trace, %."""
from portbench import calls, readers


def read(win):
    mix = win.cell.mix
    return readers.roofline(win, calls.lm_calls(win.cell.config, mix["batch"], mix["seq_len"]))
