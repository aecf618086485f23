"""Patch embedding, merging and expansion (NHWC).

Reproduces the reference `models/vmamba_Fusion_efficross.py`: PatchEmbed2D
(:151-174), PatchMerging2D (:177-217), PatchExpand2D (:220-236) and
Final_PatchExpand2D (:239-255). Their norms are torch's default-eps
LayerNorms (1e-5) and run through the fused LN op.
"""
from __future__ import annotations

from torch import nn

from ..utils import tracing
from .layers import FusedLayerNorm

_EPS = 1e-5


class PatchEmbed(nn.Module):
    """p x p stride-p conv patchify + optional LayerNorm."""

    def __init__(self, in_chans: int = 1, embed_dim: int = 96, patch_size: int = 4,
                 use_norm: bool = True):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)
        self.norm = FusedLayerNorm(embed_dim, _EPS) if use_norm else None

    def forward(self, x):  # (B, H, W, in_chans)
        x = self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x = tracing.contiguous(x, "patch_embed.out")
        return x if self.norm is None else self.norm(x)


class PatchMerging(nn.Module):
    """2x2 space-to-depth + LN(4C) + Linear(4C -> 2C, no bias). The channel
    groups come in the reference's concat order (h even/w even, h odd/w even,
    h even/w odd, h odd/w odd)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = FusedLayerNorm(4 * dim, _EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):  # (B, H, W, C), H and W even
        B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 4, 2, 5)
        x = x.reshape(B, H // 2, W // 2, 4 * C)
        return self.reduction(self.norm(x))


def _depth_to_space(x, s: int):
    """(B, H, W, s*s*c) -> (B, s*H, s*W, c), channel group (i, j) to output
    position (s*h + i, s*w + j)."""
    B, H, W, F_ = x.shape
    c = F_ // (s * s)
    x = x.reshape(B, H, W, s, s, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, s * H, s * W, c)


class PatchExpand(nn.Module):
    """Linear(2d -> 4d, no bias) + 2x depth-to-space + LN(d): 2*dim channels
    in, dim channels out at twice the resolution."""

    def __init__(self, dim: int):
        super().__init__()
        self.expand = nn.Linear(2 * dim, 4 * dim, bias=False)
        self.norm = FusedLayerNorm(dim, _EPS)

    def forward(self, x):
        return self.norm(_depth_to_space(self.expand(x), 2))


class FinalPatchExpand(nn.Module):
    """Linear(d -> 4d, no bias) + 4x depth-to-space + LN(d/4)."""

    def __init__(self, dim: int, scale: int = 4):
        super().__init__()
        self.scale = scale
        self.expand = nn.Linear(dim, scale * dim, bias=False)
        self.norm = FusedLayerNorm(dim // scale, _EPS)

    def forward(self, x):
        return self.norm(_depth_to_space(self.expand(x), self.scale))

