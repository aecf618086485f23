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
sums the per-block partials in a second kernel of the same call. Their bf16
variants stage x (and dy) as bf16 by 8-byte copies (the backward beside an
fp32 dz tile). See the sources for the designs.

Both take fp32 or bf16 I/O (`cuda_lib.entry`): x, dy, the output and dx in
the I/O dtype; the gradients of the weight and the bias and all the sums
fp32, as the JAX package's kernels take them. The weight and the bias are
fp32, or bf16 beside bf16 x (`cuda_lib.param_dtype`: a bf16 step's casts,
passed without a cast and widened as they are loaded); `depthwise_conv3x3`
casts any other to fp32, as the JAX package's wrapper does.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..utils import tracing
from . import cuda_lib

ACTS = ("none", "silu")
# the forward kernel's limits (csrc/dwconv3x3_fwd.cu)
FWD_MAX_THREADS = 128
FWD_MAX_SMEM = 48 * 1024
FWD_MAX_ROWS = 8           # rows of a tile
FWD_BLOCKS_PER_SM = 4      # fewer blocks than this an SM: shorter tiles
# the bf16 kernel's (half the shared memory a tile): rows of a tile, and
# rows of a tile for each block an SM gets (at least one block an SM),
# under which tiles shorten (fusionmamba_torch/tools/dwconv_bwd_ab.py
# --forward --sweep, PERF.md)
BF16_FWD_MAX_ROWS = 16
BF16_FWD_ROWS_PER_BLOCK = 4
# the backward kernel's limits (csrc/dwconv3x3_bwd.cu)
BWD_MAX_THREADS = 128
BWD_MAX_SMEM = 227 * 1024  # the most a block can opt in to
SMEM_PER_SM = 228 * 1024   # an SM's shared memory; each block also takes 1 KB
BWD_MAX_COLS = 16          # columns of a tile
BWD_MAX_ROWS = 8           # rows of a tile
BWD_BLOCKS_PER_SM = 4      # at most, fewer where the shared memory does not fit


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


def fwd_smem(cq: int, tw: int, th: int, io: torch.dtype = torch.float32) -> int:
    """The forward kernel's shared memory (as its source reckons it): the
    staged (th + 2) x (tw + 2) tile of cq quads of channels a position, a
    quad 16 bytes in fp32, 8 in bf16."""
    return (th + 2) * (tw + 2) * cq * (8 if io == torch.bfloat16 else 16)


def fwd_plan(B: int, H: int, W: int, C: int, sms: int = 132,
             io: torch.dtype = torch.float32) -> FwdPlan:
    """Tile sizes and grid of the forward kernel for x (B, H, W, C) of I/O
    dtype `io` on a card with `sms` SMs. A thread takes 4 channels; up to 16
    threads span 64 channels, so every width of the model (192 * 2^k)
    splits into whole blocks; up to 128 threads a block along W; rows of a
    tile halve from FWD_MAX_ROWS while the grid would leave fewer than
    FWD_BLOCKS_PER_SM blocks an SM or the tile would not fit in
    FWD_MAX_SMEM. bf16's tile takes half the shared memory and affords
    taller tiles: from BF16_FWD_MAX_ROWS rows, halved while the grid would
    leave an SM fewer than th / BF16_FWD_ROWS_PER_BLOCK blocks (at least
    one), so that a block's walk down its tile stays short where the blocks
    are few."""
    bf16 = io == torch.bfloat16
    cq = min(16, _pow2_at_least(-(-C // 4)))
    tw = min(FWD_MAX_THREADS // cq, _pow2_at_least(W))
    c_blocks, w_tiles = -(-C // (4 * cq)), -(-W // tw)
    th = min(BF16_FWD_MAX_ROWS if bf16 else FWD_MAX_ROWS, _pow2_at_least(H))

    def per_sm(th):
        return max(1.0, th / BF16_FWD_ROWS_PER_BLOCK) if bf16 else FWD_BLOCKS_PER_SM

    while th > 1 and (c_blocks * w_tiles * B * math.ceil(H / th) < per_sm(th) * sms
                      or fwd_smem(cq, tw, th, io) > FWD_MAX_SMEM):
        th //= 2
    return FwdPlan(cq, tw, th, (c_blocks, w_tiles, B * math.ceil(H / th)), cq * tw,
                   fwd_smem(cq, tw, th, io))


class BwdPlan(NamedTuple):
    """The backward kernel's tiling: a block of cq * tw threads covers 4 * cq
    channels and walks tiles of th rows x tw columns in a grid-stride loop;
    the grid is (channel blocks, blocks a channel block), each block writing
    one (10, C) partial; smem_bytes of dynamic shared memory hold the staged
    x (halo 2) and dz (halo 1) tiles (in bf16: bf16 x and dy tiles beside
    the fp32 dz tile), and the block's sums at the end."""
    cq: int
    tw: int
    th: int
    grid: tuple[int, int]
    threads: int
    smem_bytes: int
    tiles: int                 # tiles of a channel block: B x row tiles x column tiles


def bwd_smem(cq: int, tw: int, th: int, io: torch.dtype = torch.float32) -> int:
    """The backward kernel's dynamic shared memory (as its source reckons
    it): fp32 x and dz tiles, or the bf16 design's fp32 dz tile beside bf16
    x and dy tiles; at least the block's sums, 10 float4 a thread."""
    if io == torch.bfloat16:
        staged = 16 * (th + 2) * (tw + 2) + 8 * ((th + 4) * (tw + 4) + (th + 2) * (tw + 2))
        return max(staged * cq, 160 * tw * cq)
    return 16 * cq * max((th + 4) * (tw + 4) + (th + 2) * (tw + 2), 10 * tw)


def bwd_plan(B: int, H: int, W: int, C: int, sms: int = 132,
             io: torch.dtype = torch.float32) -> BwdPlan:
    """Tile sizes and grid of the backward kernel for x (B, H, W, C) of I/O
    dtype `io` on a card with `sms` SMs. Up to 16 columns and 8 rows a tile,
    and 4 channels a thread with up to 128 threads a block (so 32 channels
    at 16 columns, 64 at 8). The grid has at most as many blocks as fit on
    the card at once (shared memory allowing, at most BWD_BLOCKS_PER_SM an
    SM), spread so that every block walks the same number of tiles but the
    last. (Shorter fp32 tiles at the small shapes gave no gain on the card:
    tools/bwd_tune.py.) bf16 counts its own tiles' shared memory
    (`bwd_smem`)."""
    tw = min(BWD_MAX_COLS, _pow2_at_least(W))
    cq = min(16, BWD_MAX_THREADS // tw, _pow2_at_least(-(-C // 4)))
    th = min(BWD_MAX_ROWS, _pow2_at_least(H))
    c_blocks = -(-C // (4 * cq))
    smem = bwd_smem(cq, tw, th, io)
    per_sm = max(1, min(BWD_BLOCKS_PER_SM, SMEM_PER_SM // (smem + 1024)))
    tiles = B * -(-H // th) * -(-W // tw)
    per_block = -(-tiles // max(1, per_sm * sms // c_blocks))
    return BwdPlan(cq, tw, th, (c_blocks, -(-tiles // per_block)), cq * tw, smem, tiles)


def _checked(x, w, bias):
    """w in torch's (C, 3, 3) layout, the I/O dtype and the parameters'
    dtype, checked for the kernels."""
    C = x.shape[-1]
    if x.dim() != 4 or w.shape != (3, 3, C) or (bias is not None and bias.shape != (C,)):
        raise ValueError("depthwise_conv3x3: x must be (B, H, W, C), w (3, 3, C) and bias (C,)")
    # torch's (C, 3, 3) layout; a view, not a copy, when w came from a
    # Conv2d weight as `weight[:, 0].permute(1, 2, 0)`
    w_c = tracing.contiguous(w.permute(2, 0, 1), "dwconv.weight")
    io = cuda_lib.io_dtype("depthwise_conv3x3", x)
    params = cuda_lib.check_cuda("depthwise_conv3x3", io, x, params=[w_c, bias])
    return w_c, io, int(params == torch.bfloat16)


def dwconv_fwd(x, w, bias, act, plan=None):
    """The conv on the card, one launch: x (B, H, W, C), w (3, 3, C) and
    bias fp32, or bf16 with bf16 x. `plan` overrides `fwd_plan`'s layout (to
    time others)."""
    w_c, io, params = _checked(x, w, bias)
    out = torch.empty_like(x)
    plan = plan or fwd_plan(*x.shape, sms=cuda_lib.sm_count(x.device), io=io)
    cuda_lib.launch(cuda_lib.entry("fm_dwconv3x3_fwd", io), x.data_ptr(), w_c.data_ptr(),
                    None if bias is None else bias.data_ptr(), out.data_ptr(),
                    *x.shape, int(act == "silu"), plan.cq, plan.tw, plan.th, *plan.grid, params,
                    device=x.device)
    return out


def dwconv_bwd(x, w, bias, dy, act, plan=None):
    """Gradients of the conv for the cotangent dy: (dx, dw in w's (3, 3, C)
    shape, dbias or None), dw and dbias fp32. w and bias fp32, or bf16 with
    bf16 x. `plan` overrides `bwd_plan`'s layout (to time others)."""
    w_c, io, params = _checked(x, w, bias)
    B, H, W, C = x.shape
    if dy.shape != x.shape:
        raise ValueError("depthwise_conv3x3 backward: dy must have x's shape")
    cuda_lib.check_cuda("depthwise_conv3x3 backward", io, dy)
    plan = plan or bwd_plan(B, H, W, C, cuda_lib.sm_count(x.device), io)
    dx = torch.empty_like(x)
    part = torch.empty((plan.grid[1], 10, C), device=x.device, dtype=torch.float32)
    sums = torch.empty((10, C), device=x.device, dtype=torch.float32)
    cuda_lib.launch(cuda_lib.entry("fm_dwconv3x3_bwd", io), x.data_ptr(), w_c.data_ptr(),
                    None if bias is None else bias.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                    part.data_ptr(), sums.data_ptr(), B, H, W, C, int(act == "silu"), plan.cq,
                    plan.tw, plan.th, *plan.grid, params, device=x.device)
    # rows 0..8 the taps i*3+j, row 9 dbias
    return dx, sums[:9].view(3, 3, C), None if bias is None else sums[9]


class _DwconvFn(torch.autograd.Function):
    """Saves w and bias as they came (bf16 in a bf16 step) and returns dw and
    dbias in their dtype, one cast each where that is bf16 (the casts that
    autograd made of a `.float()` before)."""

    @staticmethod
    def forward(ctx, x, w, bias, act):
        ctx.save_for_backward(x, w, bias)
        ctx.act = act
        return dwconv_fwd(x, w, bias, act)

    @staticmethod
    def backward(ctx, dy):
        x, w, bias = ctx.saved_tensors
        dx, dw, db = dwconv_bwd(x, w, bias, tracing.contiguous(dy, "dwconv_bwd.dy"), ctx.act)
        return dx, dw.to(w.dtype), None if db is None else db.to(bias.dtype), None


def depthwise_conv3x3(x, w, bias=None, act="none"):
    """x (B, H, W, C); w (3, 3, C); bias (C,) or None; SAME padding; act
    "silu" fuses the SiLU epilogue. CPU tensors take the plain version,
    differentiated by autograd; CUDA tensors the kernel and, when a gradient
    is needed, the backward kernel. The output has x's dtype; w and bias
    enter as they are where `cuda_lib.param_dtype` allows (bf16 with bf16
    x), else as fp32; their gradients return in their own dtype."""
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}")
    if x.device.type == "cpu":
        return depthwise_conv3x3_plain(x, w, bias, act)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_conv3x3: no implementation for {x.device}")
    if cuda_lib.param_dtype(x.dtype, w, bias) == torch.float32:
        w = w.float()
        bias = None if bias is None else bias.float()
    if cuda_lib.needs_grad(x, w, bias):
        return _DwconvFn.apply(x, w, bias, act)
    return dwconv_fwd(x, w, bias, act)
