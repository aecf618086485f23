"""1 - the union of the device events over the traced window, %."""
from portbench import readers


def read(win):
    return readers.idle_share(win)
