"""Device ms a batch of the work launched inside the program's spans
`jamba.moe`: the expert layers (routing, the gather, the held experts' products, the
scatter-adds, the host's wait for the rows' counts), each with its norm and
residual add."""
from portbench import readers


def read(win):
    return readers.span_ms(win, "jamba.moe")
