"""Device ms a training step of the work launched inside the program's span
`fusion.forward`: the model's forward."""
from portbench import readers


def read(win):
    return readers.span_ms(win, "fusion.forward")
