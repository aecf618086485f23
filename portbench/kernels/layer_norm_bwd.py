"""Kernel #4, the gated LayerNorm's backward (`csrc/layer_norm_bwd.cu`): work
at shape (rows, C, gate), frozen from `chip_smoke.py::bytes_and_ops`."""
FUNCTION = "layer_norm_bwd"
ORDER = 0
EVENTS = ("ln_bwd_kernel", "ln_bwd_reduce")
GATE_OPS = {"none": 0, "silu": 5, "silu_sum": 10}


def rate(io: int) -> str:
    return "fp32"


def work(shape, io: int):
    rows, C, gate = shape
    n = rows * C
    return (io * n * (3 + 2 * (gate != "none")) + 4 * 4 * C,
            n * (16 + 2 * GATE_OPS[gate]), 0)
