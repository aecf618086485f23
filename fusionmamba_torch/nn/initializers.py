"""Seeded initialisation matching the reference's effective init.

The reference applies trunc_normal(std=0.02) to every nn.Linear weight and
zeros to their biases (`models/vmamba_Fusion_efficross.py:836-851`), leaves
each Conv at torch's default U(+-1/sqrt(fan_in)), and gives the SSM
parameters their own schemes (dt: `models/cross.py:542-566`; A: S4D-real
`:568-583`; D: ones `:585-595`). The segmentation head takes the JAX
package's init (`fusionmamba_tpu/nn/layers.py::SegmentationHead`): He-normal
conv weights as flax draws them (fan_in, gain sqrt(2), a normal truncated at
two standard deviations and rescaled to keep the variance 2 / fan_in), zero
conv biases, BatchNorm weight 1, bias 0 and fresh running statistics. The
Mamba LM (`init_lm_weights`) takes the JAX package's `models/mamba_lm.py`
init: flax's Dense and Embed defaults, the torch-style conv1d and the SSM
schemes of `fusionmamba_tpu/nn/initializers.py:26-75`. Every draw comes from
one explicit `torch.Generator`, in module order, so a seed fixes the weights;
the draws match the JAX package's in distribution only.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .layers import LDC, FusedLayerNorm, SegmentationHead
from .ss2d import SSMCore


def _uniform(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    nn.init.uniform_(t, -bound, bound, generator=gen)


def _dt_bias(t: torch.Tensor, gen: torch.Generator, dt_min=0.001, dt_max=0.1,
             dt_floor=1e-4) -> None:
    """The inverse softplus of a log-uniform dt in [dt_min, dt_max]."""
    u = torch.rand(t.shape, generator=gen)
    dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
    dt = dt.clamp_min(dt_floor)
    t.copy_(dt + torch.log(-torch.expm1(-dt)))


def _a_log(t: torch.Tensor) -> None:
    """S4D-real: A_log[..., n] = log(n + 1)."""
    t.copy_(torch.log(torch.arange(1, t.shape[-1] + 1, dtype=torch.float32)).expand_as(t))


def _ssm(m: SSMCore, gen: torch.Generator) -> None:
    _uniform(m.x_proj_weight, m.d_inner ** -0.5, gen)
    _uniform(m.dt_projs_weight, m.dt_rank ** -0.5, gen)
    _dt_bias(m.dt_projs_bias, gen)
    _a_log(m.A_logs)
    m.Ds.fill_(1.0)


# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _scaled_trunc_normal(t: torch.Tensor, variance: float, gen: torch.Generator) -> None:
    """flax's variance-scaling truncated normal: a unit normal cut at +-2,
    rescaled to `variance`."""
    std = math.sqrt(variance) / _TRUNC_STD
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=gen)


def _seg_head(head: SegmentationHead, gen: torch.Generator) -> None:
    for m in head.modules():
        if isinstance(m, nn.Conv2d):
            _scaled_trunc_normal(m.weight, 2.0 / m.weight[0].numel(), gen)
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


@torch.no_grad()
def init_lm_weights(model: nn.Module, seed: int) -> nn.Module:
    """Initialise a `models.mamba_lm.MambaLMHeadModel` (on the CPU) from
    `seed`, as the JAX package initialises its LM: the embedding N(0,
    1/d_model) (flax's Embed), every Dense kernel lecun-normal (flax's
    default: variance 1/fan_in), the conv1d kernel U(+-1/sqrt(d_conv *
    d_inner)) (the JAX package's `torch_conv_kernel` reckons fan_in over the
    whole (d_conv, 1, d_inner) kernel) and its bias U(+-1/sqrt(d_conv)),
    dt_proj's weight U(+-dt_rank^-0.5), its bias the inverse softplus of a
    log-uniform dt, A_log S4D-real, D and the norms' weights 1, their biases 0."""
    gen = torch.Generator().manual_seed(seed)
    emb = model.backbone.embedding.weight
    nn.init.normal_(emb, 0.0, emb.shape[1] ** -0.5, generator=gen)
    norms = [model.backbone.norm_f]
    for layer in model.backbone.layers:
        norms.append(layer.norm)
        m = layer.mixer
        _scaled_trunc_normal(m.in_proj.weight, 1.0 / m.in_proj.in_features, gen)
        _uniform(m.conv1d.weight, (m.d_conv * m.d_inner) ** -0.5, gen)
        _uniform(m.conv1d.bias, m.d_conv ** -0.5, gen)
        _scaled_trunc_normal(m.x_proj.weight, 1.0 / m.x_proj.in_features, gen)
        _uniform(m.dt_proj.weight, m.dt_rank ** -0.5, gen)
        _dt_bias(m.dt_proj.bias, gen)
        _a_log(m.A_log)
        m.D.fill_(1.0)
        _scaled_trunc_normal(m.out_proj.weight, 1.0 / m.out_proj.in_features, gen)
    for norm in norms:
        norm.weight.fill_(1.0)
        if norm.bias is not None:
            norm.bias.zero_()
    return model
