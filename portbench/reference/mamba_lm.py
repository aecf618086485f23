"""The Mamba language model in plain PyTorch: the benchmark's reference for
the LM cells.

Written from mamba_ssm's `MambaLMHeadModel` (`models/mixer_seq_simple.py`,
`modules/mamba_simple.py`; Gu & Dao, arXiv:2312.00752): embedding, n_layer
pre-norm blocks x + Mamba(RMSNorm(x)), a final RMSNorm and the head tied to
the embedding. A Mamba block: in_proj to (x, z); a causal depthwise conv1d
of width d_conv and SiLU on x; x_proj to (dt, B, C); dt_proj's weight on dt,
its bias inside the softplus; the selective scan with A = -exp(A_log) and
the skip D; y * SiLU(z); out_proj. Parameter names are mamba_ssm's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .scan import selective_scan


def _p(*shape, device=None):
    return nn.Parameter(torch.empty(*shape, device=device))


class _W(nn.Module):
    def __init__(self, *shape, bias=False, device=None):
        super().__init__()
        self.weight = _p(*shape, device=device)
        self.bias = _p(shape[0], device=device) if bias else None


class RMSNorm(nn.Module):
    def __init__(self, dim, eps, device=None):
        super().__init__()
        self.eps = eps
        self.weight = _p(dim, device=device)

    def forward(self, x):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) * self.weight


class Mamba(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        d = cfg["d_model"]
        self.d_inner = di = cfg["expand"] * d
        self.d_state = n = cfg["d_state"]
        self.d_conv = cfg["d_conv"]
        self.dt_rank = r = cfg.get("dt_rank") or math.ceil(d / 16)
        self.in_proj = _W(2 * di, d, device=device)
        self.conv1d = _W(di, 1, self.d_conv, bias=True, device=device)
        self.x_proj = _W(r + 2 * n, di, device=device)
        self.dt_proj = _W(di, r, bias=True, device=device)
        self.A_log = _p(di, n, device=device)
        self.D = _p(di, device=device)
        self.out_proj = _W(d, di, device=device)

    def forward(self, h):
        length, r, n = h.shape[1], self.dt_rank, self.d_state
        x, z = F.linear(h, self.in_proj.weight).chunk(2, dim=-1)
        x = F.conv1d(x.transpose(1, 2), self.conv1d.weight, self.conv1d.bias,
                     padding=self.d_conv - 1, groups=self.d_inner)[..., :length]
        x = F.silu(x.transpose(1, 2))
        dbc = F.linear(x, self.x_proj.weight)
        delta = F.linear(dbc[..., :r], self.dt_proj.weight)
        y = selective_scan(x[:, None], delta[:, None], -torch.exp(self.A_log)[None],
                           dbc[:, None, :, r:r + n], dbc[:, None, :, r + n:], self.D[None],
                           self.dt_proj.bias[None])[:, 0]
        return F.linear(y * F.silu(z), self.out_proj.weight)


class Block(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.norm = RMSNorm(cfg["d_model"], cfg["norm_eps"], device)
        self.mixer = Mamba(cfg, device)


class MambaLM(nn.Module):
    """`cfg`: vocab_size, d_model, n_layer, d_state, d_conv, expand, norm_eps
    and optionally dt_rank."""

    def __init__(self, cfg: dict, device=None):
        super().__init__()
        self.backbone = nn.Module()
        self.backbone.embedding = _W(cfg["vocab_size"], cfg["d_model"], device=device)
        self.backbone.layers = nn.ModuleList(Block(cfg, device) for _ in range(cfg["n_layer"]))
        self.backbone.norm_f = RMSNorm(cfg["d_model"], cfg["norm_eps"], device)

    def hidden(self, tokens):
        x = self.backbone.embedding.weight[tokens]
        for layer in self.backbone.layers:
            x = x + layer.mixer(layer.norm(x))
        return self.backbone.norm_f(x)

    def forward(self, tokens):
        """tokens (B, L) -> logits (B, L, vocab)."""
        return F.linear(self.hidden(tokens), self.backbone.embedding.weight)
