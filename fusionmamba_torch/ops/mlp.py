"""Fused two-layer GELU MLP: the public op, its plain PyTorch version, and
the wrappers of the CUDA kernels: the forward (`csrc/fused_mlp_fwd.cu`;
replaces `fusionmamba_tpu/ops/mlp_pallas.py::_fwd_kernel`) and the backward
(`csrc/fused_mlp_bwd.cu`; replaces `::_bwd_kernel`).

Both are bound by operations, and each I/O dtype has its own kernels.

fp32: the products run on the tensor cores as three TF32 products each,
which keeps fp32-class accuracy (`csrc/mma_tf32x3.cuh`). The forward keeps
the hidden layer on chip for outputs up to `FUSED_MAX_OUT` wide, and takes
two tiled passes through an (M, H) scratch above that, fc2's depth cut into
slices where its output tiles alone cannot fill the card. The backward
recomputes the hidden in tiles, writes gelu(h) and dL/dh as scratch, and
forms dx, dW1 and dW2 in one launch of tiles whose depth is cut into
slices; partials, and the per-tile bias sums, are reduced in a fixed order
by a third launch. Its first two launches are persistent blocks on TF32
`wgmma` fed by TMA (`csrc/wgmma_tf32x3.cuh`), their grids and slices from
`bwd_plan`. See the sources for the designs.

bf16, as the JAX package's kernels compute: x, the weights, the biases, y
and every gradient are bf16; every product is bf16 x bf16 with fp32
accumulation; the hidden a = gelu(h) is rounded to bf16 before fc2 and
dL/dh = (dy W2) gelu'(h) to bf16 before its products, db1 sums the rounded
dL/dh, and the weight and bias gradients are summed in fp32 and rounded
once; no atomics. The kernels run Hopper's bf16 `wgmma` on operands that TMA
copies as they lie in device memory (transposed ones read MN-major), in
`csrc/wgmma_bf16.cuh`; their plan is made here (`bf16_fused`,
`bf16_fwd_plan`, `bf16_bwd_plan`, gathered by `bf16_plan`): the forward
keeps the hidden layer in registers (fc1's accumulators, rounded to bf16,
are fc2's A operand) where C and C_out are at most `BF16_FUSED_MAX_WIDTH`
and its 128-row blocks fill half the card, and otherwise takes the two passes;
the backward takes the same three launches as in fp32. bf16 widths must be
multiples of 8 (16 bytes).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..utils import tracing
from . import cuda_lib

# widest output the fused forward takes; wider layers take two passes (at
# 96 the two designs are within 10% of each other, PERF.md)
FUSED_MAX_OUT = 96
_TILE = 128       # the kernels' 128-row tiles (128x128 in the fp32 products)
_SLICE = 32       # fp32 depth slices are multiples of the kernels' kBK
# the bf16 kernels' layout (csrc/wgmma_bf16.cuh, fused_mlp_fwd.cu,
# fused_mlp_bwd.cu): depth slices are multiples of kBK, the fused forward
# takes C and C_out up to kFusedMaxWidth, the backward's hidden blocks are
# 128 rows x kHidN units, and the product and hidden kernels run two blocks
# an SM
BF16_UNIT = 64
BF16_FUSED_MAX_WIDTH = 192
BF16_HID_N = 64
BF16_BLOCKS_PER_SM = 2
# the product kernel's output tiles: 128 rows x BF16_TILE_N columns (64-wide
# tiles measured faster than 128-wide ones at most training shapes: more
# blocks in flight at these small products, PERF.md)
BF16_TILE_N = 64
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


def _tiles(r, c, tile_n=_TILE):
    return -(-r // _TILE) * -(-c // tile_n)


def _cut(depth, target, unit):
    """Depth slices of about `target`, each a multiple of `unit`."""
    per = -(-depth // -(-depth // target))   # depth over the number of slices
    return -(-per // unit) * unit


def fwd_slice(M, C_out, Hd, sms):
    """Depth of one slice of the fp32 two-pass forward's fc2 (over H): about
    one 128x128 tile per SM when fc2's output tiles alone are fewer than the
    SMs, a multiple of 32 and at least 256 deep."""
    n = max(1, min(round(sms / _tiles(M, C_out)), Hd // 256))
    per = -(-Hd // n)
    return -(-per // _SLICE) * _SLICE


def bf16_launch_plan(products, sms):
    """[depth slice of each product] of one launch of the bf16 product kernel
    over `products`, [(rows, cols, depth)], in 128 x 64 tiles: a depth is
    cut (multiples of BF16_UNIT, at least 256) only where it is more than
    twice a block slot's fair share of the launch's work (tiles x depth over
    BF16_BLOCKS_PER_SM slots an SM), so that no slot carries much more than
    its share; each cut writes fp32 partials that a reduce launch sums."""
    work = sum(_tiles(r, c, BF16_TILE_N) * d for r, c, d in products)
    target = max(256, 2 * -(-work // (BF16_BLOCKS_PER_SM * sms)))
    return [d if d <= target else _cut(d, target, BF16_UNIT) for _, _, d in products]


def bf16_fwd_plan(M, Hd, C_out, sms):
    """The bf16 two-pass forward's fc2 depth slice (over H): H uncut where
    fc2's 128 x 64 tiles give every SM a block, else the launch plan's cut.
    fc1's depth C is never cut (its GELU needs the whole sum)."""
    if _tiles(M, C_out, BF16_TILE_N) >= sms:
        return Hd
    return bf16_launch_plan([(M, C_out, Hd)], sms)[0]


def bf16_bwd_plan(M, C, Hd, C_out, sms):
    """The bf16 backward products' depth slices: dx's over H, dW1's and dW2's
    over the M rows."""
    slice_dx, slice_w, _ = bf16_launch_plan([(M, C, Hd), (Hd, C, M), (C_out, Hd, M)], sms)
    return slice_dx, slice_w


def bf16_fused(M, C, C_out, sms):
    """Whether the bf16 forward keeps the hidden layer in registers: C and
    C_out at most BF16_FUSED_MAX_WIDTH, and a 128-row block for at least half
    the SMs (at 96 blocks, M = 12288, it measured 21% faster than the two
    passes; at 48, M = 6144, 28% slower: PERF.md)."""
    return max(C, C_out) <= BF16_FUSED_MAX_WIDTH and 2 * -(-M // _TILE) >= sms


def mlp_fwd(x2, w1t, b1, w2t, b2, fused: bool):
    """y (M, C_out) for x2 (M, C) and nn.Linear-layout weights w1t (H, C),
    w2t (C_out, H): fused (hidden on chip) or in two passes. bf16's fused
    design takes C and C_out up to BF16_FUSED_MAX_WIDTH."""
    M, C = x2.shape
    Hd, C_out = w1t.shape[0], w2t.shape[0]
    (x2, w1t, b1, w2t, b2), io = _kernel_operands("fused_mlp", C, Hd, C_out, x2, w1t, b1, w2t,
                                                  b2)

    def empty(*shape, dtype=io):
        return torch.empty(shape, device=x2.device, dtype=dtype)

    # the hidden scratch holds gelu(h) rounded to the I/O dtype; fc2's
    # partials are fp32
    y, hidden, partial, slice_h = empty(M, C_out), None, None, 0
    bf16 = io == torch.bfloat16
    sms = cuda_lib.sm_count(x2.device)
    if fused and bf16 and max(C, C_out) > BF16_FUSED_MAX_WIDTH:
        raise ValueError(f"fused_mlp: the fused bf16 forward takes widths up to "
                         f"{BF16_FUSED_MAX_WIDTH}, got C={C}, C_out={C_out}")
    if not fused:
        hidden = empty(M, Hd)
        slice_h = (bf16_fwd_plan(M, Hd, C_out, sms) if bf16 else fwd_slice(M, C_out, Hd, sms))
        if slice_h < Hd:
            partial = empty(-(-Hd // slice_h), M, C_out, dtype=torch.float32)
    cuda_lib.launch(cuda_lib.entry("fm_fused_mlp_fwd", io),
                    *map(_ptr, (x2, w1t, b1, w2t, b2, y, hidden, partial)),
                    M, C, Hd, C_out, slice_h, device=x2.device)
    return y


def _mlp_cuda(x, w1, b1, w2, b2):
    C, Hd, C_out = _check_shapes(x, w1, b1, w2, b2)
    # the kernel reads torch's nn.Linear layout (out, in): views, not copies,
    # when the weights came in as `linear.weight.t()`
    x2 = x.reshape(-1, C)
    if x.dtype == torch.bfloat16:
        fused = bf16_fused(x2.shape[0], C, C_out, cuda_lib.sm_count(x.device))
    else:
        fused = C_out <= FUSED_MAX_OUT
    y = mlp_fwd(x2, tracing.contiguous(w1.t(), "mlp.weights"), b1,
                tracing.contiguous(w2.t(), "mlp.weights"), b2, fused=fused)
    return y.reshape(*x.shape[:-1], C_out)


class BwdPlan(NamedTuple):
    """The fp32 backward's launches: the depth slices of dx (over H) and of
    dW1 and dW2 (over the rows), and the persistent grids of the hidden and
    the product launch."""
    slice_dx: int
    slice_w: int
    hidden_blocks: int
    product_blocks: int


def bwd_plan(M, C, Hd, C_out, sms):
    """The fp32 backward's plan: the three products' 128x128 tiles times
    their depth cut into slices of about a quarter of a block's share (each
    a multiple of 32 and at least 256 deep), and both persistent launches a
    block an SM, or one a work item where there are fewer."""
    work = _tiles(M, C) * Hd + (_tiles(Hd, C) + _tiles(C_out, Hd)) * M
    target = max(256, -(-work // (4 * sms)))
    slice_dx, slice_w = _cut(Hd, target, _SLICE), _cut(M, target, _SLICE)
    items = (_tiles(M, C) * -(-Hd // slice_dx)
             + (_tiles(Hd, C) + _tiles(C_out, Hd)) * -(-M // slice_w))
    return BwdPlan(slice_dx, slice_w, min(sms, _tiles(M, Hd)), min(sms, items))


def bf16_plan(M, C, Hd, C_out, sms):
    """The grids of the bf16 kernels at one shape, as the wrappers launch
    them: {launch: blocks, or [(rows, cols, depth, slice) of each product, in
    128 x BF16_TILE_N tiles]}, the forward by the design `bf16_fused`
    picks, then the backward's hidden launch and its products."""
    out = {}
    if bf16_fused(M, C, C_out, sms):
        out["fwd_fused"] = -(-M // _TILE)
    else:
        out["fwd_fc1"] = [(M, Hd, C, C)]
        out["fwd_fc2"] = [(M, C_out, Hd, bf16_fwd_plan(M, Hd, C_out, sms))]
    slice_dx, slice_w = bf16_bwd_plan(M, C, Hd, C_out, sms)
    out["bwd_hidden"] = -(-Hd // BF16_HID_N) * -(-M // _TILE)
    out["bwd_products"] = [(M, C, Hd, slice_dx), (Hd, C, M, slice_w), (C_out, Hd, M, slice_w)]
    return out


def mlp_bwd(x, w1, b1, w2, b2, dy):
    """Gradients of `fused_mlp` for the cotangent dy: (dx, dw1, db1, dw2, db2),
    each in the shape of its input (w1 (C, H) and w2 (H, C_out) as given)."""
    C, Hd, C_out = _check_shapes(x, w1, b1, w2, b2)
    (x2, dy2, w1t, b1, w2t), io = _kernel_operands(
        "fused_mlp backward", C, Hd, C_out, x.reshape(-1, C), dy.reshape(-1, C_out),
        tracing.contiguous(w1.t(), "mlp_bwd.weights"), b1,
        tracing.contiguous(w2.t(), "mlp_bwd.weights"))   # nn.Linear (out, in)
    M = x2.shape[0]
    sms = cuda_lib.sm_count(x.device)
    if io == torch.bfloat16:
        slice_dx, slice_w = bf16_bwd_plan(M, C, Hd, C_out, sms)
        grids = (0, 0)   # the bf16 launches size their own grids
    else:
        slice_dx, slice_w, *grids = bwd_plan(M, C, Hd, C_out, sms)
        tracing.counts["fm_fused_mlp_bwd:wgmma_tf32x3"] += 1
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
        dx, dw1, db1, dw2, db2)), M, C, Hd, C_out, slice_dx, slice_w, *grids, device=x.device)
    return dx.view(x.shape), dw1.t(), db1, dw2.t(), db2


class _MlpFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _mlp_cuda(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dy):
        return mlp_bwd(*ctx.saved_tensors, tracing.contiguous(dy, "mlp_bwd.dy"))


def fused_mlp(x, w1, b1, w2, b2):
    """y = gelu_exact(x @ w1 + b1) @ w2 + b2 with x (..., C), w1 (C, H),
    b1 (H,), w2 (H, C_out), b2 (C_out,). CPU tensors take the plain version,
    differentiated by autograd; CUDA tensors the kernels (tensor cores: fp32
    accuracy in fp32, bf16 products with fp32 sums in bf16) and, when a
    gradient is needed, the backward kernels."""
    if x.device.type == "cpu":
        return fused_mlp_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: no implementation for {x.device}")
    if cuda_lib.needs_grad(x, w1, b1, w2, b2):
        return _MlpFn.apply(x, w1, b1, w2, b2)
    return _mlp_cuda(x, w1, b1, w2, b2)
