"""Depthwise 3x3 SAME conv + bias (+ SiLU), NHWC: the public op, its plain
PyTorch version, and the wrappers of the CUDA kernels: the forward
(`csrc/dwconv3x3_fwd.cu`; replaces
`fusionmamba_tpu/ops/dwconv_pallas.py::_fwd_kernel`) and the backward
(`csrc/dwconv3x3_bwd.cu`; replaces `::_bwd_kernel`).

Both kernels are bound by bytes. Both stage tiles of x (and dy), halo
included, in shared memory with 16-byte copies, and each thread walks down a
column with 4 channels as one float4; `fwd_plan` and `bwd_plan` size the
tiles and the grids. The backward computes dz once a position of its haloed
tile, keeps dw and dbias in registers over a grid-stride walk of tiles and
sums the per-block partials in a second kernel of the same call. See the
sources for the designs.

Both take fp32 or bf16 I/O (`cuda_lib.entry`): x, dy, the output and dx in
the I/O dtype; the weight, the bias, their gradients and all the sums fp32,
as the JAX package's kernels take them (its wrapper casts w and bias to
fp32, as `depthwise_conv3x3` does here).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import cuda_lib

ACTS = ("none", "silu")
# the forward kernel's limits (csrc/dwconv3x3_fwd.cu)
FWD_MAX_THREADS = 128
FWD_MAX_SMEM = 48 * 1024
FWD_MAX_ROWS = 8           # rows of a tile
FWD_BLOCKS_PER_SM = 4      # fewer blocks than this an SM: shorter tiles
# the backward kernel's limits (csrc/dwconv3x3_bwd.cu)
BWD_MAX_THREADS = 128
BWD_MAX_SMEM = 227 * 1024  # the most a block can opt in to
SMEM_PER_SM = 228 * 1024   # an SM's shared memory; each block also takes 1 KB
BWD_MAX_COLS = 16          # columns of a tile
BWD_MAX_ROWS = 8           # rows of a tile
BWD_BLOCKS_PER_SM = 4      # at most, fewer where the shared memory does not fit

launches = 0            # every launch, of either I/O dtype
bwd_launches = 0
bf16_launches = 0       # the launches of the bf16-I/O variants
bf16_bwd_launches = 0


def depthwise_conv3x3_plain(x, w, bias=None, act="none"):
    """The nine shifted multiply-adds: x (B, H, W, C), w (3, 3, C). In fp32
    whatever the dtypes, the output in x's dtype, as the kernels compute."""
    H, W = x.shape[1], x.shape[2]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    w = w.float()
    acc = torch.zeros_like(x, dtype=torch.float32)
    for i in range(3):
        for j in range(3):
            acc = acc + xp[:, i:i + H, j:j + W] * w[i, j]
    if bias is not None:
        acc = acc + bias.float()
    return (F.silu(acc) if act == "silu" else acc).to(x.dtype)


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class FwdPlan(NamedTuple):
    """The forward kernel's tiling: a block covers 4 * cq channels, tw columns
    and th rows of one image with cq * tw threads; the grid is (channel
    blocks, column tiles, B x row tiles), and the staged tile, halo
    included, takes smem_bytes of shared memory."""
    cq: int
    tw: int
    th: int
    grid: tuple[int, int, int]
    threads: int
    smem_bytes: int


def fwd_plan(B: int, H: int, W: int, C: int, sms: int = 132) -> FwdPlan:
    """Tile sizes and grid of the forward kernel for x (B, H, W, C) on a card
    with `sms` SMs. A thread takes 4 channels; up to 16 threads span 64
    channels, so every width of the model (192 * 2^k) splits into whole
    blocks; up to 128 threads a block along W; rows of a tile halve from 8
    while the grid would leave fewer than FWD_BLOCKS_PER_SM blocks an SM."""
    cq = min(16, _pow2_at_least(-(-C // 4)))
    tw = min(FWD_MAX_THREADS // cq, _pow2_at_least(W))
    c_blocks, w_tiles = -(-C // (4 * cq)), -(-W // tw)
    th = min(FWD_MAX_ROWS, _pow2_at_least(H))
    while th > 1 and c_blocks * w_tiles * B * math.ceil(H / th) < FWD_BLOCKS_PER_SM * sms:
        th //= 2
    return FwdPlan(cq, tw, th, (c_blocks, w_tiles, B * math.ceil(H / th)), cq * tw,
                   (th + 2) * (tw + 2) * cq * 16)


class BwdPlan(NamedTuple):
    """The backward kernel's tiling: a block of cq * tw threads covers 4 * cq
    channels and walks tiles of th rows x tw columns in a grid-stride loop;
    the grid is (channel blocks, blocks a channel block), each block writing
    one (10, C) partial; smem_bytes of dynamic shared memory hold the staged
    x (halo 2) and dz (halo 1) tiles, and the block's sums at the end."""
    cq: int
    tw: int
    th: int
    grid: tuple[int, int]
    threads: int
    smem_bytes: int
    tiles: int                 # tiles of a channel block: B x row tiles x column tiles


def bwd_plan(B: int, H: int, W: int, C: int, sms: int = 132) -> BwdPlan:
    """Tile sizes and grid of the backward kernel for x (B, H, W, C) on a
    card with `sms` SMs. Up to 16 columns and 8 rows a tile, and 4 channels
    a thread with up to 128 threads a block (so 32 channels at 16 columns,
    64 at 8). The grid has at most as many blocks as fit on the card at once
    (shared memory allowing, at most BWD_BLOCKS_PER_SM an SM), spread so that
    every block walks the same number of tiles but the last. (Shorter tiles
    at the small shapes gave no gain on the card: tools/bwd_tune.py.)"""
    tw = min(BWD_MAX_COLS, _pow2_at_least(W))
    cq = min(16, BWD_MAX_THREADS // tw, _pow2_at_least(-(-C // 4)))
    th = min(BWD_MAX_ROWS, _pow2_at_least(H))
    c_blocks = -(-C // (4 * cq))
    smem = 16 * cq * max((th + 4) * (tw + 4) + (th + 2) * (tw + 2), 10 * tw)
    per_sm = max(1, min(BWD_BLOCKS_PER_SM, SMEM_PER_SM // (smem + 1024)))
    tiles = B * -(-H // th) * -(-W // tw)
    per_block = -(-tiles // max(1, per_sm * sms // c_blocks))
    return BwdPlan(cq, tw, th, (c_blocks, -(-tiles // per_block)), cq * tw, smem, tiles)


def _checked(x, w, bias):
    """w in torch's (C, 3, 3) layout and the I/O dtype, checked for the
    kernels."""
    C = x.shape[-1]
    if x.dim() != 4 or w.shape != (3, 3, C) or (bias is not None and bias.shape != (C,)):
        raise ValueError("depthwise_conv3x3: x must be (B, H, W, C), w (3, 3, C) and bias (C,)")
    # torch's (C, 3, 3) layout; a view, not a copy, when w came from a
    # Conv2d weight as `weight[:, 0].permute(1, 2, 0)`
    w_c = w.permute(2, 0, 1).contiguous()
    io = cuda_lib.io_dtype("depthwise_conv3x3", x)
    cuda_lib.check_cuda("depthwise_conv3x3", io, x,
                        fp32=[w_c] + ([] if bias is None else [bias]))
    return w_c, io


def _dwconv_cuda(x, w, bias, act):
    global launches, bf16_launches
    w_c, io = _checked(x, w, bias)
    out = torch.empty_like(x)
    plan = fwd_plan(*x.shape, sms=cuda_lib.sm_count(x.device))
    cuda_lib.launch(cuda_lib.entry("fm_dwconv3x3_fwd", io), x.data_ptr(), w_c.data_ptr(),
                    None if bias is None else bias.data_ptr(), out.data_ptr(),
                    *x.shape, int(act == "silu"), plan.cq, plan.tw, plan.th, *plan.grid,
                    device=x.device)
    launches += 1
    bf16_launches += io == torch.bfloat16
    return out


def dwconv_bwd(x, w, bias, dy, act, plan=None):
    """Gradients of the conv for the cotangent dy: (dx, dw in w's (3, 3, C)
    shape, dbias or None). `plan` overrides `bwd_plan`'s layout (to time
    others)."""
    global bwd_launches, bf16_bwd_launches
    w_c, io = _checked(x, w, bias)
    B, H, W, C = x.shape
    if dy.shape != x.shape:
        raise ValueError("depthwise_conv3x3 backward: dy must have x's shape")
    cuda_lib.check_cuda("depthwise_conv3x3 backward", io, dy)
    plan = plan or bwd_plan(B, H, W, C, sms=cuda_lib.sm_count(x.device))
    dx = torch.empty_like(x)
    part = torch.empty((plan.grid[1], 10, C), device=x.device, dtype=torch.float32)
    sums = torch.empty((10, C), device=x.device, dtype=torch.float32)
    cuda_lib.launch(cuda_lib.entry("fm_dwconv3x3_bwd", io), x.data_ptr(), w_c.data_ptr(),
                    None if bias is None else bias.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                    part.data_ptr(), sums.data_ptr(), B, H, W, C, int(act == "silu"), plan.cq,
                    plan.tw, plan.th, *plan.grid, device=x.device)
    bwd_launches += 1
    bf16_bwd_launches += io == torch.bfloat16
    # rows 0..8 the taps i*3+j, row 9 dbias
    return dx, sums[:9].view(3, 3, C), None if bias is None else sums[9]


class _DwconvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, act):
        ctx.save_for_backward(x, w, bias)
        ctx.act = act
        return _dwconv_cuda(x, w, bias, act)

    @staticmethod
    def backward(ctx, dy):
        x, w, bias = ctx.saved_tensors
        return (*dwconv_bwd(x, w, bias, dy.contiguous(), ctx.act), None)


def depthwise_conv3x3(x, w, bias=None, act="none"):
    """x (B, H, W, C); w (3, 3, C); bias (C,) or None; SAME padding; act
    "silu" fuses the SiLU epilogue. CPU tensors take the plain version,
    differentiated by autograd; CUDA tensors the kernel and, when a gradient
    is needed, the backward kernel. The output has x's dtype; w and bias
    enter as fp32 (their gradients return in their own dtype)."""
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}")
    if x.device.type == "cpu":
        return depthwise_conv3x3_plain(x, w, bias, act)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_conv3x3: no implementation for {x.device}")
    w = w.float()
    bias = None if bias is None else bias.float()
    if cuda_lib.needs_grad(x, w, bias):
        return _DwconvFn.apply(x, w, bias, act)
    return _dwconv_cuda(x, w, bias, act)
