"""Fused two-layer GELU MLP: the public op, its plain PyTorch version, and
the wrappers of the CUDA kernels: the forward (`csrc/fused_mlp_fwd.cu`;
replaces `fusionmamba_tpu/ops/mlp_pallas.py::_fwd_kernel`) and the backward
(`csrc/fused_mlp_bwd.cu`; replaces `::_bwd_kernel`).

Both are bound by operations and run their products on the tensor cores as
three TF32 products each, which keeps fp32-class accuracy
(`csrc/mma_tf32x3.cuh`). The forward keeps the hidden layer on chip for
outputs up to `FUSED_MAX_OUT` wide, and takes two tiled passes through an
(M, H) scratch above that, fc2's depth cut into slices where its output
tiles alone cannot fill the card. The backward recomputes the hidden in
tiles, writes gelu(h) and dL/dh as scratch, and forms dx, dW1 and dW2 in one
grid of tiles whose depth is cut into slices that fill the card; partials,
and the per-tile bias sums, are reduced in a fixed order by a third launch.
See the sources for the designs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib

# widest output the fused forward takes; wider layers take two passes (at
# 96 the two designs are within 10% of each other, PERF.md)
FUSED_MAX_OUT = 96
_TILE = 128       # the kernels' 128-row tiles (128x128 in the products)
_SLICE = 32       # depth slices are multiples of the kernels' kBK

launches = 0
bwd_launches = 0


def fused_mlp_plain(x, w1, b1, w2, b2):
    return F.gelu(x @ w1 + b1, approximate="none") @ w2 + b2


def _check_shapes(x, w1, b1, w2, b2):
    C = x.shape[-1]
    Hd, C_out = w1.shape[1], w2.shape[1]
    if (w1.shape != (C, Hd) or b1.shape != (Hd,) or w2.shape != (Hd, C_out)
            or b2.shape != (C_out,)):
        raise ValueError("fused_mlp: inconsistent shapes")
    return C, Hd, C_out


def _kernel_operands(name, C, Hd, C_out, *tensors):
    """The kernels copy 16 bytes at a time: widths must be multiples of 4
    floats and every base 16-byte aligned."""
    if C % 4 or Hd % 4 or C_out % 4:
        raise ValueError(f"{name}: widths (C={C}, H={Hd}, C_out={C_out}) must be "
                         f"multiples of 4")
    cuda_lib.check_cuda_float32(name, *tensors)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must start on 16-byte boundaries")
    return tensors


def _ptr(t):
    return None if t is None else t.data_ptr()


def fwd_slice(M, C_out, Hd, sms):
    """Depth of one slice of the two-pass forward's fc2 (over H): about one
    128x128 tile per SM when fc2's output tiles alone are fewer than the
    SMs, a multiple of 32 and at least 256 deep."""
    tiles = -(-M // _TILE) * -(-C_out // _TILE)
    n = max(1, min(round(sms / tiles), Hd // 256))
    per = -(-Hd // n)
    return -(-per // _SLICE) * _SLICE


def mlp_fwd(x2, w1t, b1, w2t, b2, fused: bool):
    """y (M, C_out) for x2 (M, C) and nn.Linear-layout weights w1t (H, C),
    w2t (C_out, H): fused (hidden on chip) or in two passes."""
    global launches
    M, C = x2.shape
    Hd, C_out = w1t.shape[0], w2t.shape[0]
    x2, w1t, b1, w2t, b2 = _kernel_operands("fused_mlp", C, Hd, C_out, x2, w1t, b1, w2t, b2)

    def empty(*shape):
        return torch.empty(shape, device=x2.device, dtype=x2.dtype)

    y, hidden, partial, slice_h = empty(M, C_out), None, None, 0
    if not fused:
        hidden = empty(M, Hd)
        slice_h = fwd_slice(M, C_out, Hd, cuda_lib.sm_count(x2.device))
        if slice_h < Hd:
            partial = empty(-(-Hd // slice_h), M, C_out)
    cuda_lib.launch("fm_fused_mlp_fwd", *map(_ptr, (x2, w1t, b1, w2t, b2, y, hidden, partial)),
                    M, C, Hd, C_out, slice_h, device=x2.device)
    launches += 1
    return y


def _mlp_cuda(x, w1, b1, w2, b2):
    C, Hd, C_out = _check_shapes(x, w1, b1, w2, b2)
    # the kernel reads torch's nn.Linear layout (out, in): views, not copies,
    # when the weights came in as `linear.weight.t()`
    y = mlp_fwd(x.reshape(-1, C), w1.t().contiguous(), b1, w2.t().contiguous(), b2,
                fused=C_out <= FUSED_MAX_OUT)
    return y.reshape(*x.shape[:-1], C_out)


def bwd_slices(M, C, Hd, C_out, sms):
    """Depth of one slice of dx's product (over H) and of dW1's and dW2's
    (over the M rows): the three products' 128x128 tiles times their depth,
    cut so that the grid is about two waves of two blocks per SM, each slice
    a multiple of 32 and at least 256 deep."""
    def tiles(r, c):
        return -(-r // _TILE) * -(-c // _TILE)

    work = tiles(M, C) * Hd + (tiles(Hd, C) + tiles(C_out, Hd)) * M
    target = max(256, -(-work // (4 * sms)))

    def cut(depth):
        per = -(-depth // -(-depth // target))   # depth over the number of slices
        return -(-per // _SLICE) * _SLICE

    return cut(Hd), cut(M)


def mlp_bwd(x, w1, b1, w2, b2, dy):
    """Gradients of `fused_mlp` for the cotangent dy: (dx, dw1, db1, dw2, db2),
    each in the shape of its input (w1 (C, H) and w2 (H, C_out) as given)."""
    global bwd_launches
    C, Hd, C_out = _check_shapes(x, w1, b1, w2, b2)
    x2, dy2, w1t, b1, w2t = _kernel_operands(
        "fused_mlp backward", C, Hd, C_out, x.reshape(-1, C), dy.reshape(-1, C_out),
        w1.t().contiguous(), b1, w2.t().contiguous())   # nn.Linear (out, in)
    M = x2.shape[0]
    slice_dx, slice_w = bwd_slices(M, C, Hd, C_out, cuda_lib.sm_count(x.device))
    s_dx, s_w, rows_t = -(-Hd // slice_dx), -(-M // slice_w), -(-M // _TILE)

    def empty(*shape):
        return torch.empty(shape, device=x.device, dtype=torch.float32)

    def partials(n, *shape):
        return empty(n, *shape) if n > 1 else None

    a_buf, g_buf, db1_p, db2_p = empty(M, Hd), empty(M, Hd), empty(rows_t, Hd), empty(rows_t, C_out)
    dx_p, dw1_p, dw2_p = partials(s_dx, M, C), partials(s_w, Hd, C), partials(s_w, C_out, Hd)
    dx, dw1, db1, dw2, db2 = empty(M, C), empty(Hd, C), empty(Hd), empty(C_out, Hd), empty(C_out)

    cuda_lib.launch("fm_fused_mlp_bwd", *map(_ptr, (
        x2, dy2, w1t, b1, w2t, a_buf, g_buf, db1_p, db2_p, dx_p, dw1_p, dw2_p,
        dx, dw1, db1, dw2, db2)), M, C, Hd, C_out, slice_dx, slice_w, device=x.device)
    bwd_launches += 1
    return dx.view(x.shape), dw1.t(), db1, dw2.t(), db2


class _MlpFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _mlp_cuda(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dy):
        return mlp_bwd(*ctx.saved_tensors, dy.contiguous())


def fused_mlp(x, w1, b1, w2, b2):
    """y = gelu_exact(x @ w1 + b1) @ w2 + b2 with x (..., C), w1 (C, H),
    b1 (H,), w2 (H, C_out), b2 (C_out,). CPU tensors take the plain version,
    differentiated by autograd; CUDA tensors the kernels (tensor cores, fp32
    accuracy) and, when a gradient is needed, the backward kernels."""
    if x.device.type == "cpu":
        return fused_mlp_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: no implementation for {x.device}")
    if cuda_lib.needs_grad(x, w1, b1, w2, b2):
        return _MlpFn.apply(x, w1, b1, w2, b2)
    return _mlp_cuda(x, w1, b1, w2, b2)
