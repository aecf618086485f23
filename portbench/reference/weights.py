"""Weights made from a seed, on the device, in a few large draws: one set of
tensors that fills both the program's model and the reference's.

The schemes are the reference repository's (fusion: `trunc_normal(std=0.02)`
Linear weights and zero biases, `models/vmamba_Fusion_efficross.py:836-851`;
torch's U(+-1/sqrt(fan_in)) convolutions; the SSM's dt, S4D-real A and unit
D, `models/cross.py:542-595`) and, for the Mamba LM, mamba_ssm's widths with
variance-1/fan_in products, a N(0, 1/d_model) embedding and the same SSM
schemes. Each kind of draw is one call over every tensor of that kind; the
tensors are slices of it, scaled.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from . import fusion as ref_fusion
from . import mamba_lm as ref_lm

_SQRT2 = math.sqrt(2.0)
# standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def generator(seed: int, stream: int, device) -> torch.Generator:
    """The generator of one purpose (`stream`) of a run with `seed`."""
    return torch.Generator(device=device).manual_seed((int(seed) * 8 + stream) % (2 ** 63))


def _draw(kind: str, n: int, gen: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(n, generator=gen, device=device)
    if kind == "uniform":                      # U(-1, 1)
        return 2.0 * u - 1.0
    if kind == "trunc":                        # N(0, 1) cut at +-2
        lo, hi = (1.0 + math.erf(-2.0 / _SQRT2)) / 2.0, (1.0 + math.erf(2.0 / _SQRT2)) / 2.0
        return (_SQRT2 * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)).clamp_(-2.0, 2.0)
    if kind == "normal":                       # N(0, 1)
        return torch.randn(n, generator=gen, device=device)
    if kind == "dt_bias":                      # softplus^-1 of a log-uniform dt
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(u * (hi - lo) + lo).clamp_min_(1e-4)
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(kind)


class _Plan:
    """What each tensor gets: a draw of a kind times a scale, or a constant."""

    def __init__(self):
        self.draws: dict[str, list] = {}
        self.consts: list = []

    def draw(self, name, kind, scale=1.0):
        self.draws.setdefault(kind, []).append((name, scale))

    def const(self, name, fn):
        self.consts.append((name, fn))

    def make(self, shapes: dict, seed: int, device) -> dict:
        out = {name: torch.empty(shape, device=device) for name, shape in shapes.items()}
        gen = generator(seed, 0, device)
        for kind in sorted(self.draws):
            items = self.draws[kind]
            flat = _draw(kind, sum(out[n].numel() for n, _ in items), gen, device)
            off = 0
            for name, scale in items:
                t = out[name]
                torch.mul(flat[off:off + t.numel()].view_as(t), scale, out=t)
                off += t.numel()
        for name, fn in self.consts:
            fn(out[name])
        missing = set(out) - {n for items in self.draws.values() for n, _ in items} \
            - {n for n, _ in self.consts}
        if missing:
            raise ValueError(f"no init rule for {sorted(missing)}")
        return out


def _a_log(t):
    t.copy_(torch.log(torch.arange(1, t.shape[-1] + 1, dtype=t.dtype, device=t.device))
            .expand_as(t))


def _ones(t):
    t.fill_(1.0)


def _zeros(t):
    t.zero_()


def _ssm_rules(plan, prefix, m):
    plan.draw(prefix + "x_proj_weight", "uniform", m.d_inner ** -0.5)
    plan.draw(prefix + "dt_projs_weight", "uniform", m.dt_rank ** -0.5)
    plan.draw(prefix + "dt_projs_bias", "dt_bias")
    plan.const(prefix + "A_logs", _a_log)
    plan.const(prefix + "Ds", _ones)


def fusion_weights(cfg: dict, seed: int, device) -> dict:
    """name -> tensor for every parameter of the fusion network of `cfg`."""
    net = ref_fusion.FusionNet(cfg, device="meta")
    plan = _Plan()
    for mname, m in net.named_modules():
        pre = mname + "." if mname else ""
        if isinstance(m, ref_fusion.LayerNorm):
            plan.const(pre + "weight", _ones)
            plan.const(pre + "bias", _zeros)
        elif isinstance(m, ref_fusion.Linear):
            plan.draw(pre + "weight", "trunc", 0.02)
            if m.bias is not None:
                plan.const(pre + "bias", _zeros)
        elif isinstance(m, ref_fusion.Conv):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            plan.draw(pre + "weight", "uniform", bound)
            if m.bias is not None:
                plan.draw(pre + "bias", "uniform", bound)
        elif isinstance(m, ref_fusion.LDC):
            plan.const(pre + "learnable_mask", _ones)
            plan.const(pre + "learnable_theta", lambda t: t.fill_(0.5))
        if isinstance(m, ref_fusion.SSMCore):
            _ssm_rules(plan, pre, m)
    return plan.make({n: p.shape for n, p in net.named_parameters()}, seed, device)


def lm_weights(cfg: dict, seed: int, device) -> dict:
    """name -> tensor for every parameter of the Mamba LM of `cfg`."""
    net = ref_lm.MambaLM(cfg, device="meta")
    plan = _Plan()
    plan.draw("backbone.embedding.weight", "normal", cfg["d_model"] ** -0.5)
    plan.const("backbone.norm_f.weight", _ones)
    for i, layer in enumerate(net.backbone.layers):
        pre, m = f"backbone.layers.{i}.", layer.mixer
        plan.const(pre + "norm.weight", _ones)
        pre += "mixer."
        for name in ("in_proj", "x_proj", "out_proj"):
            fan_in = getattr(m, name).weight.shape[1]
            plan.draw(pre + name + ".weight", "trunc", math.sqrt(1.0 / fan_in) / _TRUNC_STD)
        plan.draw(pre + "conv1d.weight", "uniform", (m.d_conv * m.d_inner) ** -0.5)
        plan.draw(pre + "conv1d.bias", "uniform", m.d_conv ** -0.5)
        plan.draw(pre + "dt_proj.weight", "uniform", m.dt_rank ** -0.5)
        plan.draw(pre + "dt_proj.bias", "dt_bias")
        plan.const(pre + "A_log", _a_log)
        plan.const(pre + "D", _ones)
    return plan.make({n: p.shape for n, p in net.named_parameters()}, seed, device)


def load(module: nn.Module, weights: dict) -> None:
    """Copy `weights` into `module`'s parameters; the names must be the same set."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"parameters differ: only in the module "
                         f"{sorted(set(params) - set(weights))[:5]}, only in the weights "
                         f"{sorted(set(weights) - set(params))[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            if p.shape != weights[name].shape:
                raise ValueError(f"{name}: {tuple(p.shape)} against "
                                 f"{tuple(weights[name].shape)}")
            p.copy_(weights[name])
