"""Kernel #6, the LayerNorm spatial mean's backward
(`csrc/layer_norm_bwd.cu`): work at shape (B, rows, C), frozen from
`chip_smoke.py::bytes_and_ops`."""
FUNCTION = "ln_mean_bwd"
ORDER = 0
EVENTS = ("lnm_bwd_kernel", "lnm_bwd_reduce", "lnm_bwd_one_launch")


def rate(io: int) -> str:
    return "fp32"


def work(shape, io: int):
    B, rows, C = shape
    return io * 2 * B * rows * C + 4 * (B * C + 3 * C), 12 * B * rows * C, 0
