"""The controls: the reference put in the program's place and computed in
the precision next below the one its mix states. For float32 that is TF32,
as the card's own float32 products and convolutions run it when PyTorch
allows; for bfloat16 it is fp8 (e4m3), as an fp8 path of the program would
take it: both operands of every product of a weight (a parameter) with an
activation rounded to e4m3 under a scale of their own, the sums in float32;
the scan's own sums, the norms and the loss stay float32."""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

# e4m3's largest finite magnitude
E4M3_MAX = 448.0


@contextlib.contextmanager
def tf32(on: bool):
    """Within the block, float32 products and convolutions on the card run
    in TF32 when `on`; outside it, as the process had them (the program
    pins full float32)."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def e4m3(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to fp8 e4m3 under a scale that maps its largest magnitude
    to e4m3's largest, in `t`'s dtype; the gradient passes through as is."""
    scale = E4M3_MAX / t.detach().abs().amax().clamp_min(1e-30)
    q = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (q - t.detach())


class _Fp8Products(TorchFunctionMode):
    """Rounds both operands of every product (linear, convolution, einsum,
    matmul) that has a parameter among its two operands to e4m3."""
    PRODUCTS = (F.linear, F.conv1d, F.conv2d, torch.matmul, torch.Tensor.matmul, torch.bmm)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.einsum and len(args) == 3:
            eq, a, b = args
            if _has_weight(a, b):
                return func(eq, e4m3(a), e4m3(b), **kwargs)
        elif func in self.PRODUCTS and _has_weight(*args[:2]):
            return func(e4m3(args[0]), e4m3(args[1]), *args[2:], **kwargs)
        return func(*args, **kwargs)


def _has_weight(*operands) -> bool:
    return (all(isinstance(t, torch.Tensor) for t in operands)
            and any(isinstance(t, torch.nn.Parameter) for t in operands))


@contextlib.contextmanager
def control(precision: str, on: bool):
    """The reference's numerics within the block: as the control of a mix of
    `precision` when `on`, else exact float32 (TF32 off)."""
    if not on or precision == "fp32":
        with tf32(on):
            yield
        return
    if precision != "bf16":
        raise ValueError(f"no control for precision {precision!r}")
    with tf32(False), _Fp8Products():
        yield
