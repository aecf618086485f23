"""Kernel #9, the fused MLP (fc1, GELU, fc2; `csrc/fused_mlp_fwd.cu`): work at
shape (M, C, hidden), frozen from `chip_smoke.py::bytes_and_ops`. Its products
run on the tensor cores: in fp32 as three TF32 products each (3xTF32), in
bf16 at the bf16 rate."""
FUNCTION = "mlp"
ORDER = 0
EVENTS = ("mlp_fwd_", "bf::fused_kernel", "product_kernel<0>")


def rate(io: int) -> str:
    return "tf32x3" if io == 4 else "bf16"


def work(shape, io: int):
    M, C, H = shape
    return io * (2 * M * C + 2 * C * H + H + C), M * (4 * C * H + 10 * H), 0
