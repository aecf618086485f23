"""Host ms a serving batch inside the program's span `fusion.forward`: the
model's dispatch, which sets the pace where it is as long as the device's
work."""
from portbench import readers


def read(win):
    return readers.span_ms(win, "fusion.forward", "host_ms")
