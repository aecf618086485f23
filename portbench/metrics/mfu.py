"""Model FLOPs of the traced forwards (the configuration's a pair or a
token) over the traced window and the peak of the cell's compute dtype, %."""
from portbench import readers


def read(win):
    return readers.mfu(win, win.cell.config["forward_flops_per_item"])
