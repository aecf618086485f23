"""Kernel #7, the depthwise 3x3 conv + bias + SiLU (`csrc/dwconv3x3_fwd.cu`):
work at shape (B, H, W, C), frozen from `chip_smoke.py::bytes_and_ops`."""
FUNCTION = "dwconv"
ORDER = 0
EVENTS = ("dwconv3x3_fwd_kernel",)


def rate(io: int) -> str:
    return "fp32"


def work(shape, io: int):
    B, H, W, C = shape
    n = B * H * W * C
    return io * 2 * n + 4 * 10 * C, n * (18 + 1 + 4), 0
