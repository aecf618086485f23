"""Fused LayerNorm (+ gate) and LN-spatial-mean: the public ops, their plain
PyTorch versions, the dispatch to the Triton kernels (`ln_triton.py`: the LN
forward, the LN-mean forward), and the wrappers of the CUDA kernels of the
two backwards (`csrc/layer_norm_bwd.cu`; they replace
`fusionmamba_tpu/ops/ln_pallas.py::_ln_bwd_kernel` and `::_lnm_bwd_kernel`).

Numerics follow `fusionmamba_tpu/ops/ln_pallas.py`: fp32 statistics with the
fast variance E[x^2] - E[x]^2 (not F.layer_norm's two-pass form), then
rsqrt(var + eps).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import cuda_lib, ln_triton
from .cuda_lib import needs_grad

GATE_ACTS = ("none", "silu", "silu_sum")

# The LN backward kernel's templates (csrc/layer_norm_bwd.cu): C -> (values
# a lane holds, lanes a row), values * lanes = C, for every width the model
# normalises (3 * 2^k); any other C takes a masked variant of 12 values a
# lane with the fewest of BWD_MASKED_LANES lanes that hold it.
BWD_TEMPLATES = {24: (3, 8), 96: (3, 32), 192: (6, 32), 384: (12, 32), 768: (12, 64),
                 1536: (12, 128)}
BWD_MASKED_VALUES = 12
BWD_MASKED_LANES = (32, 128, 512)
BWD_BLOCK = 256             # threads of a block whose rows take at most 256 lanes
BWD_REDUCE_SLICES = 32      # the partials' reduce: interleaved slices summed in order

layer_norm_bwd_launches = 0
ln_mean_bwd_launches = 0


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


def _template(C: int, name: str) -> tuple[int, int, bool, int, int, int]:
    """(values, lanes, masked, threads, rows a block takes at a time, blocks an
    SM) of the backward kernels' template for width C: 4 blocks an SM, 2
    where a lane holds 12 values and uses about twice the registers."""
    if C in BWD_TEMPLATES:
        values, lanes = BWD_TEMPLATES[C]
        masked = False
    else:
        values = BWD_MASKED_VALUES
        lanes = next((n for n in BWD_MASKED_LANES if n * values >= C), None)
        if lanes is None:
            raise ValueError(f"{name} backward: C = {C} is wider than the card's "
                             f"kernel takes ({BWD_MASKED_VALUES * BWD_MASKED_LANES[-1]})")
        masked = True
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


def layer_norm_bwd(x, scale, bias, gate, dy, eps, gate_act):
    """Gradients of the fused LN for the cotangent dy, on the card: (dx,
    dgate or None, dscale, dbias), fp32. Two launches: the rows, then the
    sum of the per-block partials of dscale and dbias."""
    global layer_norm_bwd_launches
    C = x.shape[-1]
    tensors = [x, scale, bias, dy] + ([] if gate is None else [gate])
    cuda_lib.check_cuda_float32("layer_norm_fused backward", *tensors)
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
    cuda_lib.launch("fm_layer_norm_bwd", x.data_ptr(), None if gate is None else gate.data_ptr(),
                    scale.data_ptr(), bias.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                    None if dg is None else dg.data_ptr(), part.data_ptr(), ds.data_ptr(),
                    db.data_ptr(), rows, C, 0 if gate is None else ln_triton.GATE_CODES[gate_act],
                    plan.values, plan.lanes, int(plan.masked), plan.blocks, eps,
                    device=x.device)
    layer_norm_bwd_launches += 1
    return dx, dg, ds, db


def ln_spatial_mean_bwd(x, scale, dm, eps, plan=None):
    """Gradients of the LN-mean for the cotangent dm (B, C), on the card:
    (dx, dscale, dbias), fp32. Two launches: the rows, then the sums of the
    per-block partials into dscale and dbias. `plan` overrides
    `lnm_bwd_plan`'s layout (to time others)."""
    global ln_mean_bwd_launches
    B, C = x.shape[0], x.shape[-1]
    cuda_lib.check_cuda_float32("ln_spatial_mean backward", x, scale, dm)
    if dm.shape != (B, C) or scale.shape != (C,):
        raise ValueError("ln_spatial_mean backward: dm must be (B, C) and scale (C,)")
    rows = x.numel() // (B * C)
    plan = plan or lnm_bwd_plan(B, rows, C, cuda_lib.sm_count(x.device))
    dx = torch.empty_like(x)
    part = torch.empty((B, plan.blocks, C), device=x.device, dtype=torch.float32)
    ds = torch.empty(C, device=x.device, dtype=torch.float32)
    db = torch.empty(C, device=x.device, dtype=torch.float32)
    cuda_lib.launch("fm_ln_mean_bwd", x.data_ptr(), scale.data_ptr(), dm.data_ptr(),
                    dx.data_ptr(), part.data_ptr(), ds.data_ptr(), db.data_ptr(), B, rows, C,
                    plan.values, plan.lanes, int(plan.masked), plan.blocks, eps,
                    device=x.device)
    ln_mean_bwd_launches += 1
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
    B, C = x.shape[0], x.shape[-1]
    y = layer_norm_plain(x.reshape(B, -1, C), scale, bias, None, eps)
    return y.float().mean(dim=1)


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
        return ln_triton.ln_spatial_mean_fwd(x, scale, bias, eps)

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
    multiplies by the raw gate."""
    if gate_act not in GATE_ACTS:
        raise ValueError(f"unknown gate_act {gate_act!r}")
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, gate, eps, gate_act)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_fused: no implementation for {x.device}")
    if needs_grad(x, scale, bias, gate):
        return _LayerNormFn.apply(x, scale, bias, gate, eps, gate_act)
    return ln_triton.layer_norm_fwd(x, scale, bias, gate, eps, gate_act)


def ln_spatial_mean(x, scale, bias, eps=1e-5):
    """Mean over all positions of LayerNorm(x): x (B, ..., C) -> (B, C) fp32,
    without LN(x) ever being written. CPU tensors take the plain version,
    differentiated by autograd; CUDA tensors the Triton kernel and, when a
    gradient is needed, the CUDA backward kernel."""
    if x.device.type == "cpu":
        return ln_spatial_mean_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_spatial_mean: no implementation for {x.device}")
    if needs_grad(x, scale, bias):
        return _LnMeanFn.apply(x, scale, bias, eps)
    return ln_triton.ln_spatial_mean_fwd(x, scale, bias, eps)
