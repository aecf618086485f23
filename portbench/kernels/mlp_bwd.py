"""Kernel #10, the fused MLP's backward (`csrc/fused_mlp_bwd.cu`): work at
shape (M, C, hidden), frozen from `chip_smoke.py::bytes_and_ops`."""
FUNCTION = "mlp_bwd"
ORDER = 0
EVENTS = ("mlp_bwd_", "bf::hidden_kernel", "product_kernel<1>")


def rate(io: int) -> str:
    return "tf32x3" if io == 4 else "bf16"


def work(shape, io: int):
    M, C, H = shape
    # five products of 2*M*C*H (h, dy W2, dx, dW1, dW2), GELU and its slope
    return io * (3 * M * C + 4 * C * H + 2 * H + 2 * C), M * (10 * C * H + 30 * H), 0
