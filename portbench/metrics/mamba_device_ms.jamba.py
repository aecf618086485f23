"""Device ms a batch of the work launched inside the program's spans
`jamba.mamba`: the Mamba mixers, each with its layer's input norm and residual add."""
from portbench import readers


def read(win):
    return readers.span_ms(win, "jamba.mamba")
