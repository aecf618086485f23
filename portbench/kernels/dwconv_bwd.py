"""Kernel #8, the depthwise conv's backward (`csrc/dwconv3x3_bwd.cu`): work at
shape (B, H, W, C), frozen from `chip_smoke.py::bytes_and_ops`."""
FUNCTION = "dwconv_bwd"
ORDER = 0
EVENTS = ("dwconv3x3_bwd_kernel", "dwconv3x3_bwd_reduce")


def rate(io: int) -> str:
    return "fp32"


def work(shape, io: int):
    B, H, W, C = shape
    n = B * H * W * C
    # pre (18), silu' (8), dx (18), dw (18), dbias (1)
    return io * 3 * n + 4 * 20 * C, n * 63, 0
