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

Both take fp32 or bf16 I/O (`cuda_lib.entry`). In bf16, as the JAX
package's kernels compute: x, the weights, the biases, y and every gradient
are bf16; every product is exact (a bf16 value is exact in TF32, so each
takes one TF32 product) with fp32 accumulation; the hidden a = gelu(h) is
rounded to bf16 before fc2 and dL/dh = (dy W2) gelu'(h) to bf16 before its
products, and the weight and bias gradients are summed in fp32 and rounded
once. bf16 widths must be multiples of 8 (16 bytes).
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

launches = 0            # every launch, of either I/O dtype
bwd_launches = 0
bf16_launches = 0       # the launches of the bf16-I/O variants
bf16_bwd_launches = 0
_SQRT_HALF = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def _hidden(x, w1, b1):
    """(h, gelu(h)) in fp32 of x (..., C) and w1 (C, H)."""
    h = x.float() @ w1.float() + b1.float()
    return h, F.gelu(h, approximate="none")


def mlp_bwd_plain(x, w1, b1, w2, b2, dy):
    """The gradients (dx, dw1, db1, dw2, db2) of the bf16 `fused_mlp_plain`,
    each in its input's dtype, rounded where the kernels round: the hidden
    a and dL/dh are bf16, every product and sum is fp32."""
    C, Hd, C_out = x.shape[-1], w1.shape[1], w2.shape[1]
    h, a = _hidden(x, w1, b1)
    a = a.to(x.dtype).float().reshape(-1, Hd)
    dgelu = 0.5 * (1.0 + torch.erf(h * _SQRT_HALF)) + h * torch.exp(-0.5 * h * h) * _INV_SQRT_2PI
    dyf = dy.float().reshape(-1, C_out)
    g = ((dyf @ w2.float().t()) * dgelu.reshape(-1, Hd)).to(x.dtype).float()
    dx = (g @ w1.float().t()).to(x.dtype).reshape(x.shape)
    dw1 = (x.float().reshape(-1, C).t() @ g).to(w1.dtype)
    dw2 = (a.t() @ dyf).to(w2.dtype)
    return dx, dw1, g.sum(0).to(b1.dtype), dw2, dyf.sum(0).to(b2.dtype)


class _MlpPlainFn(torch.autograd.Function):
    """The bf16 plain version with its backward written out, so that dL/dh
    is rounded where the kernel rounds it (autograd of the forward would
    round dL/da instead)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        a = _hidden(x, w1, b1)[1].to(x.dtype)
        return (a.float() @ w2.float() + b2.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        return mlp_bwd_plain(*ctx.saved_tensors, dy)


def fused_mlp_plain(x, w1, b1, w2, b2):
    """The MLP in plain torch: in fp32 as written, in bf16 (x and the
    weights bf16) with fp32 sums and the kernels' roundings (module doc)."""
    if x.dtype == torch.float32:
        return F.gelu(x @ w1 + b1, approximate="none") @ w2 + b2
    return _MlpPlainFn.apply(x, w1, b1, w2, b2)


def _check_shapes(x, w1, b1, w2, b2):
    C = x.shape[-1]
    Hd, C_out = w1.shape[1], w2.shape[1]
    if (w1.shape != (C, Hd) or b1.shape != (Hd,) or w2.shape != (Hd, C_out)
            or b2.shape != (C_out,)):
        raise ValueError("fused_mlp: inconsistent shapes")
    return C, Hd, C_out


def _kernel_operands(name, C, Hd, C_out, *tensors):
    """The kernels copy 16 bytes at a time: widths must be multiples of 4
    floats (8 bf16) and every base 16-byte aligned. Returns the tensors and
    the I/O dtype."""
    io = cuda_lib.io_dtype(name, tensors[0])
    per = 16 // tensors[0].element_size()
    if C % per or Hd % per or C_out % per:
        raise ValueError(f"{name}: widths (C={C}, H={Hd}, C_out={C_out}) must be "
                         f"multiples of {per} in {io}")
    cuda_lib.check_cuda(name, io, *tensors)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must start on 16-byte boundaries")
    return tensors, io


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
    global launches, bf16_launches
    M, C = x2.shape
    Hd, C_out = w1t.shape[0], w2t.shape[0]
    (x2, w1t, b1, w2t, b2), io = _kernel_operands("fused_mlp", C, Hd, C_out, x2, w1t, b1, w2t,
                                                  b2)

    def empty(*shape, dtype=io):
        return torch.empty(shape, device=x2.device, dtype=dtype)

    # the hidden scratch holds gelu(h) rounded to the I/O dtype; fc2's
    # partials are fp32
    y, hidden, partial, slice_h = empty(M, C_out), None, None, 0
    if not fused:
        hidden = empty(M, Hd)
        slice_h = fwd_slice(M, C_out, Hd, cuda_lib.sm_count(x2.device))
        if slice_h < Hd:
            partial = empty(-(-Hd // slice_h), M, C_out, dtype=torch.float32)
    cuda_lib.launch(cuda_lib.entry("fm_fused_mlp_fwd", io),
                    *map(_ptr, (x2, w1t, b1, w2t, b2, y, hidden, partial)),
                    M, C, Hd, C_out, slice_h, device=x2.device)
    launches += 1
    bf16_launches += io == torch.bfloat16
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
    global bwd_launches, bf16_bwd_launches
    C, Hd, C_out = _check_shapes(x, w1, b1, w2, b2)
    (x2, dy2, w1t, b1, w2t), io = _kernel_operands(
        "fused_mlp backward", C, Hd, C_out, x.reshape(-1, C), dy.reshape(-1, C_out),
        w1.t().contiguous(), b1, w2.t().contiguous())   # nn.Linear (out, in)
    M = x2.shape[0]
    slice_dx, slice_w = bwd_slices(M, C, Hd, C_out, cuda_lib.sm_count(x.device))
    s_dx, s_w, rows_t = -(-Hd // slice_dx), -(-M // slice_w), -(-M // _TILE)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, device=x.device, dtype=dtype)

    def partials(n, *shape):
        return empty(n, *shape) if n > 1 else None

    # a and dL/dh in the I/O dtype; the partials fp32; the results in the
    # I/O dtype
    a_buf, g_buf = empty(M, Hd, dtype=io), empty(M, Hd, dtype=io)
    db1_p, db2_p = empty(rows_t, Hd), empty(rows_t, C_out)
    dx_p, dw1_p, dw2_p = partials(s_dx, M, C), partials(s_w, Hd, C), partials(s_w, C_out, Hd)
    dx, dw1, db1, dw2, db2 = (empty(*s, dtype=io) for s in
                              ((M, C), (Hd, C), (Hd,), (C_out, Hd), (C_out,)))

    cuda_lib.launch(cuda_lib.entry("fm_fused_mlp_bwd", io), *map(_ptr, (
        x2, dy2, w1t, b1, w2t, a_buf, g_buf, db1_p, db2_p, dx_p, dw1_p, dw2_p,
        dx, dw1, db1, dw2, db2)), M, C, Hd, C_out, slice_dx, slice_w, device=x.device)
    bwd_launches += 1
    bf16_bwd_launches += io == torch.bfloat16
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
