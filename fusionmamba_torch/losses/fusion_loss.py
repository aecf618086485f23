"""Fusion training loss (reference `loss.py:15-56`, as the JAX package's
`losses/fusion_loss.py` computes it):

    total = 100 * [0.5 * (1 - msssim(gen, y)) + 0.5 * (1 - msssim(gen, ir))]
          + 10 * MSE(max(y, ir), gen)
          + 1 * L1(max(|sobel| y, |sobel| ir), |sobel| gen)

with msssim(normalize=True) and the fixed Sobel-xy operator. Images are NHWC
single-channel in [0, 1]. With `axis` (the mesh's data axis) each rank holds
its rows of a global batch and the loss is that of the global batch
(`losses/ssim.py`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .ssim import batch_mean, msssim, sep_filter2d

# the Sobel kernels as products of 1-D taps: sobel_x = [1,2,1]^T (rows) x
# [-1,0,1] (columns), sobel_y = [1,0,-1]^T x [1,2,1]
_SMOOTH = (1.0, 2.0, 1.0)
_DIFF_X = (-1.0, 0.0, 1.0)
_DIFF_Y = (1.0, 0.0, -1.0)


def sobel_xy(x: torch.Tensor) -> torch.Tensor:
    """|sobel_x| + |sobel_y| of x (B, H, W) or NHWC, SAME (zero) padding."""
    gx = sep_filter2d(x, _SMOOTH, _DIFF_X, same=True)
    gy = sep_filter2d(x, _DIFF_Y, _SMOOTH, same=True)
    return gx.abs() + gy.abs()


class FusionLossOutput(NamedTuple):
    total: torch.Tensor
    loss_in: torch.Tensor
    ssim_value: torch.Tensor
    loss_grad: torch.Tensor


def fusion_loss(image_vis_y: torch.Tensor, image_ir: torch.Tensor,
                generate_img: torch.Tensor, w_ssim: float = 100.0, w_in: float = 10.0,
                w_grad: float = 1.0, axis=None) -> FusionLossOutput:
    image_y, image_ir, gen = image_vis_y[..., 0], image_ir[..., 0], generate_img[..., 0]
    x_in_max = torch.maximum(image_y, image_ir)
    # both comparisons through one batched pyramid: the dynamic range is read
    # from img1, which is gen in both reference calls
    ms = msssim(torch.cat([gen, gen]), torch.cat([image_y, image_ir]),
                normalize=True, splits=2, axis=axis)
    ssim_value = 0.5 * (1.0 - ms[0]) + 0.5 * (1.0 - ms[1])
    loss_in = batch_mean((x_in_max - gen) ** 2, axis=axis)
    joint = torch.maximum(sobel_xy(image_y), sobel_xy(image_ir))
    loss_grad = batch_mean((joint - sobel_xy(gen)).abs(), axis=axis)
    total = w_ssim * ssim_value + w_in * loss_in + w_grad * loss_grad
    return FusionLossOutput(total, loss_in, ssim_value, loss_grad)
