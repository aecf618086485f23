"""Model FLOPs of the traced training steps (3 x the forward's, nothing
recomputed counted) over the traced window and the compute dtype's peak, %."""
from portbench import readers


def read(win):
    return readers.mfu(win, 3.0 * win.cell.config["forward_flops_per_item"])
