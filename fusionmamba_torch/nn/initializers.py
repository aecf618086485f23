"""Seeded initialisation matching the reference's effective init.

The reference applies trunc_normal(std=0.02) to every nn.Linear weight and
zeros to their biases (`models/vmamba_Fusion_efficross.py:836-851`), leaves
each Conv at torch's default U(+-1/sqrt(fan_in)), and gives the SSM
parameters their own schemes (dt: `models/cross.py:542-566`; A: S4D-real
`:568-583`; D: ones `:585-595`). The segmentation head takes the JAX
package's init (`fusionmamba_tpu/nn/layers.py::SegmentationHead`): He-normal
conv weights as flax draws them (fan_in, gain sqrt(2), a normal truncated at
two standard deviations and rescaled to keep the variance 2 / fan_in), zero
conv biases, BatchNorm weight 1, bias 0 and fresh running statistics. Every
draw comes from one explicit `torch.Generator`, in module order, so a seed
fixes the weights.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .layers import LDC, FusedLayerNorm, SegmentationHead
from .ss2d import SSMCore


def _uniform(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    nn.init.uniform_(t, -bound, bound, generator=gen)


def _ssm(m: SSMCore, gen: torch.Generator, dt_min=0.001, dt_max=0.1,
         dt_floor=1e-4) -> None:
    _uniform(m.x_proj_weight, m.d_inner ** -0.5, gen)
    _uniform(m.dt_projs_weight, m.dt_rank ** -0.5, gen)
    # inverse softplus of a log-uniform dt in [dt_min, dt_max]
    u = torch.rand(m.dt_projs_bias.shape, generator=gen)
    dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
    dt = dt.clamp_min(dt_floor)
    m.dt_projs_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
    a = torch.arange(1, m.d_state + 1, dtype=torch.float32)
    m.A_logs.copy_(torch.log(a).expand_as(m.A_logs))
    m.Ds.fill_(1.0)


# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _seg_head(head: SegmentationHead, gen: torch.Generator) -> None:
    for m in head.modules():
        if isinstance(m, nn.Conv2d):
            std = math.sqrt(2.0 / m.weight[0].numel()) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std, generator=gen)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Initialise every parameter of `model` (on the CPU) from `seed`."""
    gen = torch.Generator().manual_seed(seed)
    done = set()
    for m in model.modules():
        if m in done:
            continue
        if isinstance(m, SegmentationHead):
            _seg_head(m, gen)
            done.update(m.modules())
        elif isinstance(m, nn.Linear):
            nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04, generator=gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.Conv1d, nn.Conv2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            _uniform(m.weight, bound, gen)
            if m.bias is not None:
                _uniform(m.bias, bound, gen)
        elif isinstance(m, FusedLayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, LDC):
            m.learnable_mask.fill_(1.0)
            m.learnable_theta.fill_(0.5)
        if isinstance(m, SSMCore):
            _ssm(m, gen)
    return model
