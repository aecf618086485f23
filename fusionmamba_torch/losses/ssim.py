"""SSIM / MS-SSIM (NHWC or (B, H, W)), as the JAX package's `losses/ssim.py`
computes them, which matches the vendored `pytorch_msssim` the reference
trains with:
  * Gaussian window 11, sigma 1.5, VALID (`pytorch_msssim/__init__.py:11-21, 42-57`);
  * the dynamic range L read from img1 when val_range is None (:26-40);
  * a 5-level pyramid with 2x2 average pooling and weights
    (0.0448, 0.2856, 0.3001, 0.2363, 0.1333) (:78-104);
  * normalize=True maps each level's value through (x + 1) / 2 (:96-98);
  * levels combine as `prod(pow1[:-1] * pow2[-1])` (:100-103), which raises
    the last level's SSIM to (levels - 1) times its weight: the reference's
    quirk, kept because the training loss depends on it.
The separable filters are banded matrix products, as in the JAX package.

With `axis` (the mesh's data axis, `parallel.mesh.Axis`) each rank holds its
rows of a global batch, and every mean and the dynamic range span the global
batch: partial sums are all-reduced (`parallel.collectives.all_reduce`),
so the value and, summed over the ranks, the gradient are the
single-process ones on the global batch.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..parallel.collectives import all_reduce, reduce_max

MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


@functools.cache
def gaussian_taps(size: int, sigma: float = 1.5) -> tuple:
    x = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return tuple((g / g.sum()).astype(np.float32))


@functools.cache
def band_matrix(taps: tuple, L: int, same: bool) -> np.ndarray:
    """(L, L_out) matrix B such that x @ B applies the 1-D filter `taps` along
    a length-L axis: VALID, or SAME with zero padding."""
    k = len(taps)
    if same:
        out = np.arange(L)
        B = np.zeros((L, L), np.float32)
        off = (k - 1) // 2
        for t in range(k):
            rows = out + t - off
            ok = (rows >= 0) & (rows < L)
            B[rows[ok], out[ok]] = taps[t]
    else:
        out = np.arange(L - k + 1)
        B = np.zeros((L, L - k + 1), np.float32)
        for t in range(k):
            B[out + t, out] = taps[t]
    return B


@functools.cache
def band_tensor(taps: tuple, L: int, same: bool, device: torch.device) -> torch.Tensor:
    """`band_matrix` as a tensor on `device`, made once per (taps, L, same,
    device): a step copies no matrix to the card and so never waits on one."""
    return torch.from_numpy(band_matrix(taps, L, same)).to(device)


def sep_filter2d(x: torch.Tensor, taps_h: tuple, taps_w: tuple,
                 same: bool = False) -> torch.Tensor:
    """Separable 2-D filter of x (B, H, W) or (B, H, W, C): `taps_h` along H,
    `taps_w` along W."""
    Bh = band_tensor(taps_h, x.shape[1], same, x.device)
    Bw = band_tensor(taps_w, x.shape[2], same, x.device)
    if x.dim() == 3:
        return torch.einsum("bjw,wk->bjk", torch.einsum("bhw,hj->bjw", x, Bh), Bw)
    return torch.einsum("bjwc,wk->bjkc", torch.einsum("bhwc,hj->bjwc", x, Bh), Bw)


def batch_mean(x: torch.Tensor, splits: int = 1, axis=None) -> torch.Tensor:
    """Mean of x over everything but its `splits` groups stacked on dim 0
    (a scalar at splits 1, else a (splits,)-vector), over the global batch
    when `axis` spans several ranks (module doc)."""
    if axis is None or axis.size == 1:
        return x.mean() if splits == 1 else x.reshape(splits, -1).mean(1)
    per = x.reshape(splits, -1)
    out = all_reduce(per.sum(1), axis) / (per.shape[1] * axis.size)
    return out[0] if splits == 1 else out


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         val_range: float | None = None, full: bool = False, splits: int = 1, axis=None):
    """Mean SSIM of img1, img2 ((B, H, W, C) or (B, H, W)), and the mean
    contrast-structure term when `full`. With splits > 1 the batch holds
    `splits` equal groups stacked on axis 0, and each value is a
    (splits,)-vector of per-group means. `axis` as the module doc."""
    if img1.dim() == 4 and img1.shape[-1] == 1:
        img1, img2 = img1[..., 0], img2[..., 0]
    if val_range is None:
        one = torch.ones((), device=img1.device)
        hi, lo = img1.max(), img1.min()
        if axis is not None and axis.size > 1:
            hi, lo = reduce_max(hi, axis), -reduce_max(-lo, axis)
        max_val = torch.where(hi > 128.0, 255.0 * one, one)
        min_val = torch.where(lo < -0.5, -one, 0.0 * one)
        L = max_val - min_val
    else:
        L = float(val_range)
    win = gaussian_taps(min(window_size, img1.shape[1], img1.shape[2]))

    def blur(t):
        return sep_filter2d(t, win, win, same=False)

    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = blur(img1 * img1) - mu1_sq
    sigma2_sq = blur(img2 * img2) - mu2_sq
    sigma12 = blur(img1 * img2) - mu1_mu2
    C1 = (0.01 * L) ** 2
    C2 = (0.03 * L) ** 2
    v1 = 2.0 * sigma12 + C2
    v2 = sigma1_sq + sigma2_sq + C2
    ssim_map = ((2.0 * mu1_mu2 + C1) * v1) / ((mu1_sq + mu2_sq + C1) * v2)
    cs_map = v1 / v2
    ret, cs = batch_mean(ssim_map, splits, axis), batch_mean(cs_map, splits, axis)
    return (ret, cs) if full else ret


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling of (B, H, W) or (B, H, W, C), VALID (odd edges dropped)."""
    B, H, W = x.shape[:3]
    x = x[:, : H // 2 * 2, : W // 2 * 2]
    return x.reshape(B, H // 2, 2, W // 2, 2, *x.shape[3:]).sum((2, 4)) / 4.0


def msssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
           val_range: float | None = None, normalize: bool = False, splits: int = 1,
           axis=None):
    """5-level MS-SSIM, combined as the reference does: the product over
    levels i < 4 of cs_i ** w_i, times ssim_4 ** (4 * w_4). With splits > 1
    a (splits,)-vector (see `ssim`); `axis` as the module doc."""
    if img1.dim() == 4 and img1.shape[-1] == 1:
        img1, img2 = img1[..., 0], img2[..., 0]
    levels = len(MSSSIM_WEIGHTS)
    res = torch.ones((splits,) if splits > 1 else (), device=img1.device)
    for i in range(levels):
        last = i == levels - 1
        sim, cs = ssim(img1, img2, window_size, val_range, full=True, splits=splits, axis=axis)
        val = sim if last else cs
        if normalize:
            val = (val + 1.0) / 2.0
        res = res * val ** (MSSSIM_WEIGHTS[i] * ((levels - 1) if last else 1))
        if not last:
            img1, img2 = avg_pool2(img1), avg_pool2(img2)
    return res
