"""Four-direction 2-D scan layouts (NHWC), pure reshape/permute/flip;
autograd differentiates them exactly.

`efficient_scan` decimates (B, H, W, C) into four sequences of length
ceil(H/2) * ceil(W/2):
    k=0: (h even, w even), row-major      k=1: (h odd,  w even), column-major
    k=2: (h even, w odd),  row-major      k=3: (h odd,  w odd),  column-major
odd H or W is zero-padded first; `efficient_merge` is the exact inverse
interleave, cropped back to the original size (reference
`models/cross.py:139-190` and `:34-88`).

`cross_scan` is the full-resolution variant (reference
`models/vmamba_Fusion_efficross.py:398-429`): four sequences of length H * W,
row-major, column-major and both reversed; `cross_merge` undoes each
ordering and sums the four.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import tracing


def efficient_scan(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 4, ceil(H/2)*ceil(W/2), C)."""
    B, H, W, C = x.shape
    pad_h, pad_w = (-H) % 2, (-W) % 2
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    H2, W2 = x.shape[1] // 2, x.shape[2] // 2
    xq = x.reshape(B, H2, 2, W2, 2, C)
    d0 = xq[:, :, 0, :, 0].reshape(B, H2 * W2, C)
    d1 = xq[:, :, 1, :, 0].transpose(1, 2).reshape(B, W2 * H2, C)
    d2 = xq[:, :, 0, :, 1].reshape(B, H2 * W2, C)
    d3 = xq[:, :, 1, :, 1].transpose(1, 2).reshape(B, W2 * H2, C)
    return torch.stack([d0, d1, d2, d3], dim=1)


def efficient_merge(ys: torch.Tensor, ori_h: int, ori_w: int) -> torch.Tensor:
    """(B, 4, L, C) -> (B, ori_h, ori_w, C), inverse of `efficient_scan`."""
    B, _, _, C = ys.shape
    H2, W2 = -(-ori_h // 2), -(-ori_w // 2)
    q00 = ys[:, 0].reshape(B, H2, W2, C)
    q10 = ys[:, 1].reshape(B, W2, H2, C).transpose(1, 2)
    q01 = ys[:, 2].reshape(B, H2, W2, C)
    q11 = ys[:, 3].reshape(B, W2, H2, C).transpose(1, 2)
    even_h = torch.stack([q00, q01], dim=3)   # (B, H2, W2, 2, C)
    odd_h = torch.stack([q10, q11], dim=3)
    y = torch.stack([even_h, odd_h], dim=2)   # (B, H2, 2, W2, 2, C)
    y = y.reshape(B, 2 * H2, 2 * W2, C)
    return tracing.contiguous(y[:, :ori_h, :ori_w], "scan2d.merge")


def cross_scan(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 4, H*W, C)."""
    B, H, W, C = x.shape
    hw = x.reshape(B, H * W, C)
    wh = x.transpose(1, 2).reshape(B, W * H, C)
    return torch.stack([hw, wh, hw.flip(1), wh.flip(1)], dim=1)


def cross_merge(ys: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, 4, H*W, C) -> (B, H, W, C), the sum of the four directions."""
    B, _, L, C = ys.shape
    y1 = ys[:, 1].reshape(B, W, H, C).transpose(1, 2).reshape(B, L, C)
    y3 = ys[:, 3].flip(1).reshape(B, W, H, C).transpose(1, 2).reshape(B, L, C)
    return (ys[:, 0] + y1 + ys[:, 2].flip(1) + y3).reshape(B, H, W, C)
