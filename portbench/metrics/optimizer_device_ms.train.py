"""Device ms a training step of the work launched inside the program's span
`train.optimizer`: Adam's step."""
from portbench import readers


def read(win):
    return readers.span_ms(win, "train.optimizer")
