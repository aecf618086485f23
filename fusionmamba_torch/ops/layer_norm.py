"""Fused LayerNorm (+ gate) and LN-spatial-mean: the public ops, their plain
PyTorch versions, and the dispatch to the Triton kernels (`ln_triton.py`),
forward and backward.

Numerics follow `fusionmamba_tpu/ops/ln_pallas.py`: fp32 statistics with the
fast variance E[x^2] - E[x]^2 (not F.layer_norm's two-pass form), then
rsqrt(var + eps).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import ln_triton
from .cuda_lib import needs_grad

GATE_ACTS = ("none", "silu", "silu_sum")


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
        dx, dg, ds, db = ln_triton.layer_norm_bwd(x, scale, bias, gate, dy.contiguous(),
                                                  ctx.eps, ctx.gate_act)
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
        dx, ds, db = ln_triton.ln_spatial_mean_bwd(x, scale, dm.contiguous(), ctx.eps)
        return dx, ds, db, None


def layer_norm_fused(x, scale, bias, gate=None, eps=1e-6, gate_act="none"):
    """LayerNorm over the last axis of x (..., C), times the activated gate
    (same shape as x) when one is given. CPU tensors take the plain version,
    differentiated by autograd; CUDA tensors the Triton kernel and, when a
    gradient is needed, its backward kernel."""
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
    gradient is needed, its backward kernel."""
    if x.device.type == "cpu":
        return ln_spatial_mean_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_spatial_mean: no implementation for {x.device}")
    if needs_grad(x, scale, bias):
        return _LnMeanFn.apply(x, scale, bias, eps)
    return ln_triton.ln_spatial_mean_fwd(x, scale, bias, eps)
