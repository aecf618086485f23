"""Kernel #3, the gated LayerNorm's forward (`ops/ln_triton.py`): work at
shape (rows, C, gate), frozen from `chip_smoke.py::bytes_and_ops`."""
FUNCTION = "layer_norm"
ORDER = 0
EVENTS = ("ln_fwd",)
# extra operations an element of the gate activations
GATE_OPS = {"none": 0, "silu": 5, "silu_sum": 10}


def rate(io: int) -> str:
    return "fp32"


def work(shape, io: int):
    rows, C, gate = shape
    n = rows * C
    return io * n * (2 + (gate != "none")) + 4 * 2 * C, n * (7 + GATE_OPS[gate]), 0
