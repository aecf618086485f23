"""Evaluation of the port's outputs: the fusion-quality metrics
(`metrics_fusion.py`), the segmentation metrics (`metrics_seg.py`) and the
salient-object metrics of ACOD-12K (`metrics_sod.py`)."""
from .metrics_fusion import (entropy, fusion_report, mutual_information, qabf, ssim,
                             std_dev)
from .metrics_seg import RunningScore, present_classes_metrics
from .metrics_sod import e_measure, f_measure_sod, mae, s_measure

__all__ = ["RunningScore", "e_measure", "entropy", "f_measure_sod", "fusion_report", "mae",
           "mutual_information", "present_classes_metrics", "qabf", "s_measure", "ssim",
           "std_dev"]
