"""Training losses of the fusion network."""
from .fusion_loss import FusionLossOutput, fusion_loss, sobel_xy
from .ssim import msssim, sep_filter2d, ssim

__all__ = ["FusionLossOutput", "fusion_loss", "msssim", "sep_filter2d", "sobel_xy", "ssim"]
