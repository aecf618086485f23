"""Segmentation losses, as the JAX package's `losses/segmentation.py`
computes them (reference `loss.py:61-154` and `train_segmentation.py:37-91`).
Logits are (B, H, W, C), targets integer (B, H, W).

Where torch's built-ins differ, the JAX semantics hold: a target is clipped
to [0, C-1] before its log-probability is gathered (`F.cross_entropy` would
raise a device assert); a weighted mean divides by the summed weight of the
valid targets; `ignore_index` (-100) marks pixels that count nowhere.

* `segmentation_loss`: CE + 0.5 * focal (gamma 2), with the hardcoded PST900
  inverse-frequency weights when C == 5 and no weight is given.
* `improved_pst900_loss`: CE with data-driven class weights + 0.5 * focal +
  0.3 * Dice over the foreground classes (the reference's optional lovasz
  term is left out, as the reference does when `lovasz_losses` is missing).
* `combined_fusion_segmentation_loss`: w_f * fusion + w_s * segmentation.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .fusion_loss import fusion_loss

PST900_CLASS_WEIGHTS = (1.0, 970.0, 121.25, 970.0, 53.89)


@functools.cache
def pst900_class_weights(device: torch.device) -> torch.Tensor:
    """PST900_CLASS_WEIGHTS as a float32 tensor on `device`, made once per
    device (a step copies nothing to the card)."""
    return torch.tensor(PST900_CLASS_WEIGHTS, dtype=torch.float32, device=device)


def _clipped(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    return target.long().clamp(0, num_classes - 1)


def _per_pixel_ce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Unreduced CE of each pixel."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, _clipped(target, logits.shape[-1])[..., None])[..., 0]


def _valid(target: torch.Tensor, ignore_index: int) -> torch.Tensor:
    return (target != ignore_index).float()


def cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                  weight: torch.Tensor | None = None, ignore_index: int = -100) -> torch.Tensor:
    ce = _per_pixel_ce(logits, target)
    valid = _valid(target, ignore_index)
    if weight is not None:
        w = weight.to(ce)[_clipped(target, logits.shape[-1])] * valid
        return (ce * w).sum() / w.sum().clamp_min(1e-12)
    return (ce * valid).sum() / valid.sum().clamp_min(1e-12)


def focal_loss(logits: torch.Tensor, target: torch.Tensor, alpha: float = 1.0,
               gamma: float = 2.0, ignore_index: int = -100) -> torch.Tensor:
    ce = _per_pixel_ce(logits, target)
    valid = _valid(target, ignore_index)
    pt = torch.exp(-ce)
    fl = alpha * (1.0 - pt) ** gamma * ce * valid
    return fl.sum() / valid.sum().clamp_min(1e-12)


def dice_loss_foreground(logits: torch.Tensor, target: torch.Tensor, num_classes: int,
                         smooth: float = 1e-6) -> torch.Tensor:
    """Mean (1 - Dice) over classes 1..C-1 (`train_segmentation.py:67-78`)."""
    probs = F.softmax(logits, dim=-1)
    total = 0.0
    for c in range(1, num_classes):
        p = probs[..., c]
        t = (target == c).float()
        inter = (p * t).sum()
        union = p.sum() + t.sum()
        total = total + 1.0 - (2.0 * inter + smooth) / (union + smooth)
    return total / (num_classes - 1)


class SegLossOutput(NamedTuple):
    total: torch.Tensor
    ce: torch.Tensor
    focal: torch.Tensor


def segmentation_loss(logits: torch.Tensor, target: torch.Tensor, num_classes: int,
                      weight: torch.Tensor | None = None, alpha: float = 1.0,
                      gamma: float = 2.0, ignore_index: int = -100) -> SegLossOutput:
    if weight is None and num_classes == 5:
        weight = pst900_class_weights(logits.device)
    ce = cross_entropy(logits, target, weight, ignore_index)
    fl = focal_loss(logits, target, alpha, gamma, ignore_index)
    return SegLossOutput(ce + 0.5 * fl, ce, fl)


class ImprovedSegLossOutput(NamedTuple):
    total: torch.Tensor
    ce: torch.Tensor
    focal: torch.Tensor
    dice: torch.Tensor


def improved_pst900_loss(logits: torch.Tensor, target: torch.Tensor, num_classes: int,
                         class_weights: torch.Tensor) -> ImprovedSegLossOutput:
    ce = cross_entropy(logits, target, class_weights)
    fl = focal_loss(logits, target)
    dl = dice_loss_foreground(logits, target, num_classes)
    return ImprovedSegLossOutput(ce + 0.5 * fl + 0.3 * dl, ce, fl, dl)


def compute_class_weights(class_counts) -> torch.Tensor:
    """Inverse-frequency weights, divided by their minimum
    (`train_segmentation.py:53-55`); float32."""
    counts = torch.as_tensor(class_counts, dtype=torch.float32)
    freq = counts / counts.sum()
    w = 1.0 / (freq + 1e-6)
    return w / w.min()


def combined_fusion_segmentation_loss(image_vis_y, image_ir, seg_labels, fusion_out, seg_logits,
                                      num_seg_classes: int, fusion_weight: float = 1.0,
                                      segmentation_weight: float = 1.0) -> dict:
    """The loss terms of whichever outputs are given, and their weighted
    `total`."""
    out = {}
    total = 0.0
    if fusion_out is not None:
        f = fusion_loss(image_vis_y, image_ir, fusion_out)
        out.update(fusion_total=f.total, fusion_mse=f.loss_in, fusion_ssim=f.ssim_value,
                   fusion_grad=f.loss_grad)
        total = total + fusion_weight * f.total
    if seg_logits is not None and seg_labels is not None:
        s = segmentation_loss(seg_logits, seg_labels, num_seg_classes)
        out.update(seg_total=s.total, seg_ce=s.ce, seg_focal=s.focal)
        total = total + segmentation_weight * s.total
    out["total"] = total
    return out
