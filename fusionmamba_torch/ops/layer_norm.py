"""Fused LayerNorm (+ gate) and LN-spatial-mean: the public ops, their plain
PyTorch versions, the dispatch to the LN forward's Triton kernel
(`ln_triton.py`), and the wrappers of the CUDA kernels of the LN-mean forward
(`csrc/ln_mean_fwd.cu`, replacing
`fusionmamba_tpu/ops/ln_pallas.py::_lnm_fwd_kernel`) and of the two backwards
(`csrc/layer_norm_bwd.cu`, replacing `::_ln_bwd_kernel` and
`::_lnm_bwd_kernel`).

Numerics follow `fusionmamba_tpu/ops/ln_pallas.py`: fp32 statistics with the
fast variance E[x^2] - E[x]^2 (not F.layer_norm's two-pass form), then
rsqrt(var + eps).

Every kernel takes fp32 or bf16 I/O (`cuda_lib.entry`): x, the gate, dy, y,
dx and dgate in the I/O dtype; scale, bias, their gradients, the LN-mean's
(B, C) output and its cotangent fp32, as the JAX package's kernels take
them (the ops cast scale and bias to fp32, as its wrappers do).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import cuda_lib, ln_triton
from .cuda_lib import needs_grad

GATE_ACTS = ("none", "silu", "silu_sum")

# The CUDA LN kernels' templates (FM_LN_TEMPLATES in csrc/ln_common.cuh): C ->
# (values a lane holds, lanes a row), values * lanes = C, for every width the
# model normalises (3 * 2^k); any other C takes a masked variant of 12 values
# a lane with the fewest of MASKED_LANES lanes that hold it.
TEMPLATES = {24: (3, 8), 96: (3, 32), 192: (6, 32), 384: (12, 32), 768: (12, 64),
             1536: (12, 128)}
MASKED_VALUES = 12
MASKED_LANES = (32, 128, 512)
BWD_BLOCK = 256             # threads of a block whose rows take at most 256 lanes
BWD_REDUCE_SLICES = 32      # the partials' reduce: interleaved slices summed in order
# the LN-mean forward (csrc/ln_mean_fwd.cu): threads of a block whose rows take
# at most 512 lanes, values a lane loads ahead (a group takes
# FWD_ROW_VALUES // values rows at a time), blocks of a cluster at most, and
# the blocks an SM its plan aims at (two fit; the clusters are powers of two:
# 13 ran slower than 8, 11 and 16 at batch 16, tools/lnm_tune.py, PERF.md)
FWD_BLOCK = 512
FWD_ROW_VALUES = 24
FWD_MAX_CLUSTER = 16
FWD_BLOCKS_PER_SM = 1.5

layer_norm_bwd_launches = 0     # every launch, of either I/O dtype
ln_mean_launches = 0
ln_mean_bwd_launches = 0
bf16_layer_norm_bwd_launches = 0   # the launches of the bf16-I/O variants
bf16_ln_mean_launches = 0
bf16_ln_mean_bwd_launches = 0


def gate_value(g_raw: torch.Tensor, gate_act: str) -> torch.Tensor:
    """The activated gate from the raw one: "silu" is SS2D's y * silu(z);
    "silu_sum" is SS2DCross's y*z1 + y*z2 with z1 = silu(raw) and
    z2 = silu(z1), folded as y * (z1 + z2)."""
    if gate_act == "silu":
        return F.silu(g_raw)
    if gate_act == "silu_sum":
        s1 = F.silu(g_raw)
        return s1 + F.silu(s1)
    return g_raw


class BwdPlan(NamedTuple):
    """The LN backward kernel's layout: `lanes` lanes a row, each holding
    `values` channels (lanes past C masked when `masked`); a block of
    `threads` takes `rows_per_step` rows at a time and walks the rows in a
    grid-stride loop over `blocks` blocks, each writing one (2, C) partial."""
    values: int
    lanes: int
    masked: bool
    threads: int
    rows_per_step: int
    blocks: int


def _widths(C: int, name: str) -> tuple[int, int, bool]:
    """(values a lane, lanes a row, masked) of the LN kernels' template for
    width C."""
    if C in TEMPLATES:
        return (*TEMPLATES[C], False)
    lanes = next((n for n in MASKED_LANES if n * MASKED_VALUES >= C), None)
    if lanes is None:
        raise ValueError(f"{name}: C = {C} is wider than the card's kernel takes "
                         f"({MASKED_VALUES * MASKED_LANES[-1]})")
    return MASKED_VALUES, lanes, True


def _template(C: int, name: str) -> tuple[int, int, bool, int, int, int]:
    """(values, lanes, masked, threads, rows a block takes at a time, blocks an
    SM) of the backward kernels' template for width C: 4 blocks an SM, 2
    where a lane holds 12 values and uses about twice the registers."""
    values, lanes, masked = _widths(C, name + " backward")
    threads = max(BWD_BLOCK, lanes)
    return values, lanes, masked, threads, threads // lanes, 2 if values > 6 else 4


def bwd_plan(rows: int, C: int, sms: int = 132) -> BwdPlan:
    """The LN backward's template and grid for (rows, C) on a card with `sms`
    SMs: a few blocks an SM (`_template`), never more blocks than row steps."""
    values, lanes, masked, threads, step, per_sm = _template(C, "layer_norm_fused")
    return BwdPlan(values, lanes, masked, threads, step,
                   max(1, min(math.ceil(rows / step), per_sm * sms)))


def lnm_bwd_plan(B: int, rows: int, C: int, sms: int = 132) -> BwdPlan:
    """The LN-mean backward's template and grid for x (B, rows, C): the LN
    backward's templates; `blocks` is the blocks of each batch row, so that
    the B batch rows together take a few blocks an SM, never more blocks than
    row steps."""
    values, lanes, masked, threads, step, per_sm = _template(C, "ln_spatial_mean")
    return BwdPlan(values, lanes, masked, threads, step,
                   max(1, min(math.ceil(rows / step), per_sm * sms // B)))


class FwdPlan(NamedTuple):
    """The LN-mean forward kernel's layout: `lanes` lanes a row, each holding
    `values` channels (lanes past C masked when `masked`); a block of
    `threads` holds `groups` groups, each taking `unroll` rows at a time, so a
    block takes chunks of groups * unroll consecutive rows; `cluster` blocks
    (one thread-block cluster) walk each batch row's chunks in turn."""
    values: int
    lanes: int
    masked: bool
    threads: int
    groups: int
    unroll: int
    cluster: int


@functools.lru_cache(maxsize=None)
def lnm_fwd_plan(B: int, rows: int, C: int, sms: int = 132) -> FwdPlan:
    """The LN-mean forward's template and grid for x (B, rows, C) on a card
    with `sms` SMs: a cluster of blocks a batch row, the largest power of two
    that puts at most FWD_BLOCKS_PER_SM blocks on each SM, is at most the
    batch row's chunks and at most FWD_MAX_CLUSTER."""
    values, lanes, masked = _widths(C, "ln_spatial_mean")
    threads = max(FWD_BLOCK, lanes)
    groups, unroll = threads // lanes, max(1, FWD_ROW_VALUES // values)
    chunks = math.ceil(rows / (groups * unroll))
    most = max(1, min(FWD_MAX_CLUSTER, chunks, math.ceil(FWD_BLOCKS_PER_SM * sms / B)))
    return FwdPlan(values, lanes, masked, threads, groups, unroll, 1 << (most.bit_length() - 1))


def ln_spatial_mean_fwd(x, scale, bias, eps, plan=None):
    """mean over positions of LN(x): (B, ..., C) -> (B, C) fp32, on the card,
    one launch. `plan` overrides `lnm_fwd_plan`'s layout (to time others)."""
    global ln_mean_launches, bf16_ln_mean_launches
    B, C = x.shape[0], x.shape[-1]
    io = cuda_lib.io_dtype("ln_spatial_mean", x)
    cuda_lib.check_cuda("ln_spatial_mean", io, x, fp32=[scale, bias])
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError("ln_spatial_mean: scale and bias must be (C,)")
    rows = x.numel() // (B * C)
    plan = plan or lnm_fwd_plan(B, rows, C, cuda_lib.sm_count(x.device))
    out = torch.empty((B, C), device=x.device, dtype=torch.float32)
    cuda_lib.launch(cuda_lib.entry("fm_ln_mean_fwd", io), x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), B, rows, C, plan.values, plan.lanes, int(plan.masked),
                    plan.cluster, eps, device=x.device)
    ln_mean_launches += 1
    bf16_ln_mean_launches += io == torch.bfloat16
    return out


def layer_norm_bwd(x, scale, bias, gate, dy, eps, gate_act):
    """Gradients of the fused LN for the cotangent dy, on the card: (dx,
    dgate or None, dscale, dbias), dx and dgate in x's dtype, dscale and
    dbias fp32. Two launches: the rows, then the sum of the per-block
    partials of dscale and dbias."""
    global layer_norm_bwd_launches, bf16_layer_norm_bwd_launches
    C = x.shape[-1]
    io = cuda_lib.io_dtype("layer_norm_fused backward", x)
    cuda_lib.check_cuda("layer_norm_fused backward", io, x, dy,
                        *([] if gate is None else [gate]), fp32=[scale, bias])
    if dy.shape != x.shape or (gate is not None and gate.shape != x.shape):
        raise ValueError("layer_norm_fused backward: dy and the gate must have x's shape")
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError("layer_norm_fused backward: scale and bias must be (C,)")
    rows = x.numel() // C
    plan = bwd_plan(rows, C, cuda_lib.sm_count(x.device))
    dx = torch.empty_like(x)
    dg = None if gate is None else torch.empty_like(gate)
    part = torch.empty((plan.blocks, 2, C), device=x.device, dtype=torch.float32)
    ds = torch.empty(C, device=x.device, dtype=torch.float32)
    db = torch.empty(C, device=x.device, dtype=torch.float32)
    cuda_lib.launch(cuda_lib.entry("fm_layer_norm_bwd", io), x.data_ptr(), None if gate is None else gate.data_ptr(),
                    scale.data_ptr(), bias.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                    None if dg is None else dg.data_ptr(), part.data_ptr(), ds.data_ptr(),
                    db.data_ptr(), rows, C, 0 if gate is None else ln_triton.GATE_CODES[gate_act],
                    plan.values, plan.lanes, int(plan.masked), plan.blocks, eps,
                    device=x.device)
    layer_norm_bwd_launches += 1
    bf16_layer_norm_bwd_launches += io == torch.bfloat16
    return dx, dg, ds, db


def ln_spatial_mean_bwd(x, scale, dm, eps, plan=None):
    """Gradients of the LN-mean for the cotangent dm (B, C) fp32, on the
    card: (dx in x's dtype, dscale, dbias fp32). Two launches: the rows, then
    the sums of the per-block partials into dscale and dbias. `plan`
    overrides `lnm_bwd_plan`'s layout (to time others)."""
    global ln_mean_bwd_launches, bf16_ln_mean_bwd_launches
    B, C = x.shape[0], x.shape[-1]
    io = cuda_lib.io_dtype("ln_spatial_mean backward", x)
    cuda_lib.check_cuda("ln_spatial_mean backward", io, x, fp32=[scale, dm])
    if dm.shape != (B, C) or scale.shape != (C,):
        raise ValueError("ln_spatial_mean backward: dm must be (B, C) and scale (C,)")
    rows = x.numel() // (B * C)
    plan = plan or lnm_bwd_plan(B, rows, C, cuda_lib.sm_count(x.device))
    dx = torch.empty_like(x)
    part = torch.empty((B, plan.blocks, C), device=x.device, dtype=torch.float32)
    ds = torch.empty(C, device=x.device, dtype=torch.float32)
    db = torch.empty(C, device=x.device, dtype=torch.float32)
    cuda_lib.launch(cuda_lib.entry("fm_ln_mean_bwd", io), x.data_ptr(), scale.data_ptr(), dm.data_ptr(),
                    dx.data_ptr(), part.data_ptr(), ds.data_ptr(), db.data_ptr(), B, rows, C,
                    plan.values, plan.lanes, int(plan.masked), plan.blocks, eps,
                    device=x.device)
    ln_mean_bwd_launches += 1
    bf16_ln_mean_bwd_launches += io == torch.bfloat16
    return dx, ds, db


def _stats(x, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x * x).mean(dim=-1, keepdim=True) - mu * mu
    return mu, torch.rsqrt(var + eps)


def layer_norm_plain(x, scale, bias, gate=None, eps=1e-6, gate_act="none"):
    xf = x.float()
    mu, rs = _stats(xf, eps)
    y = (xf - mu) * rs * scale.float() + bias.float()
    if gate is not None:
        y = y * gate_value(gate.float(), gate_act)
    return y.to(x.dtype)


def ln_spatial_mean_plain(x, scale, bias, eps=1e-5):
    """The mean in fp32 of LN(x) in fp32: LN(x) is never rounded to x's
    dtype, as the kernels compute it."""
    B, C = x.shape[0], x.shape[-1]
    y = layer_norm_plain(x.reshape(B, -1, C).float(), scale, bias, None, eps)
    return y.mean(dim=1)


class _LayerNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, gate, eps, gate_act):
        ctx.save_for_backward(x, scale, bias, gate)
        ctx.eps, ctx.gate_act = eps, gate_act
        return ln_triton.layer_norm_fwd(x, scale, bias, gate, eps, gate_act)

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, gate = ctx.saved_tensors
        dx, dg, ds, db = layer_norm_bwd(x, scale, bias, gate, dy.contiguous(), ctx.eps,
                                        ctx.gate_act)
        return dx, ds, db, dg, None, None


class _LnMeanFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return ln_spatial_mean_fwd(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, dm):
        x, scale = ctx.saved_tensors
        dx, ds, db = ln_spatial_mean_bwd(x, scale, dm.contiguous(), ctx.eps)
        return dx, ds, db, None


def layer_norm_fused(x, scale, bias, gate=None, eps=1e-6, gate_act="none"):
    """LayerNorm over the last axis of x (..., C), times the activated gate
    (same shape as x) when one is given. CPU tensors take the plain version,
    differentiated by autograd; CUDA tensors the Triton kernel and, when a
    gradient is needed, the CUDA backward kernel. gate_act "none" with a gate
    multiplies by the raw gate. The output has x's dtype (the gate must have
    it too); scale and bias enter as fp32 (their gradients return in their
    own dtype)."""
    if gate_act not in GATE_ACTS:
        raise ValueError(f"unknown gate_act {gate_act!r}")
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, gate, eps, gate_act)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_fused: no implementation for {x.device}")
    scale, bias = scale.float(), bias.float()
    if needs_grad(x, scale, bias, gate):
        return _LayerNormFn.apply(x, scale, bias, gate, eps, gate_act)
    return ln_triton.layer_norm_fwd(x, scale, bias, gate, eps, gate_act)


def ln_spatial_mean(x, scale, bias, eps=1e-5):
    """Mean over all positions of LayerNorm(x): x (B, ..., C) -> (B, C) fp32,
    without LN(x) ever being written. CPU tensors take the plain version,
    differentiated by autograd; CUDA tensors the CUDA forward kernel and,
    when a gradient is needed, the CUDA backward kernel. x may be bf16;
    scale and bias enter as fp32."""
    if x.device.type == "cpu":
        return ln_spatial_mean_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_spatial_mean: no implementation for {x.device}")
    scale, bias = scale.float(), bias.float()
    if needs_grad(x, scale, bias):
        return _LnMeanFn.apply(x, scale, bias, eps)
    return ln_spatial_mean_fwd(x, scale, bias, eps)
