"""Device ms a training step of the work launched inside the program's span
`train.backward`, on any thread: autograd's backward."""
from portbench import readers


def read(win):
    return readers.span_ms(win, "train.backward")
