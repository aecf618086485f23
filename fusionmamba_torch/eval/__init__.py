"""Evaluation of the port's outputs: the fusion-quality metrics
(`metrics_fusion.py`)."""
from .metrics_fusion import (entropy, fusion_report, mutual_information, qabf, ssim,
                             std_dev)

__all__ = ["entropy", "fusion_report", "mutual_information", "qabf", "ssim", "std_dev"]
