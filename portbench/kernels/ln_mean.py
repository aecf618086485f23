"""Kernel #5, the LayerNorm's spatial mean (`csrc/ln_mean_fwd.cu`): work at
shape (B, rows, C), frozen from `chip_smoke.py::bytes_and_ops`."""
FUNCTION = "ln_mean"
ORDER = 0
EVENTS = ("lnm_fwd_kernel",)


def rate(io: int) -> str:
    return "fp32"


def work(shape, io: int):
    B, rows, C = shape
    return io * B * rows * C + 4 * (B * C + 2 * C), 8 * B * rows * C, 0
