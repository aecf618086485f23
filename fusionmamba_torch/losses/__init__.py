"""Training losses: the fusion loss (`fusion_loss.py`, `ssim.py`) and the
segmentation losses (`segmentation.py`)."""
from .fusion_loss import FusionLossOutput, fusion_loss, sobel_xy
from .segmentation import (PST900_CLASS_WEIGHTS, ImprovedSegLossOutput, SegLossOutput,
                           combined_fusion_segmentation_loss, compute_class_weights,
                           cross_entropy, dice_loss_foreground, focal_loss,
                           improved_pst900_loss, segmentation_loss)
from .ssim import msssim, sep_filter2d, ssim

__all__ = ["FusionLossOutput", "ImprovedSegLossOutput", "PST900_CLASS_WEIGHTS",
           "SegLossOutput", "combined_fusion_segmentation_loss", "compute_class_weights",
           "cross_entropy", "dice_loss_foreground", "focal_loss", "fusion_loss",
           "improved_pst900_loss", "msssim", "segmentation_loss", "sep_filter2d", "sobel_xy",
           "ssim"]
