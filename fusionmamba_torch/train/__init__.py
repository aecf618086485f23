"""Training: the fusion and segmentation steps and their optimizers
(`loop.py`) and the fusion CLI (`cli.py`, run as `python -m
fusionmamba_torch.train`; the segmentation CLI is
`fusionmamba_torch.train_segmentation`)."""
from .cli import main
from .loop import (PRECISIONS, cast_compute, fusion_train_step, make_fusion_optimizer,
                   make_seg_optimizer, poly_lr, reference_fusion_lr, resolve_compute_dtype,
                   seg_train_step, set_learning_rate)

__all__ = ["PRECISIONS", "cast_compute", "fusion_train_step", "main", "make_fusion_optimizer",
           "make_seg_optimizer", "poly_lr", "reference_fusion_lr", "resolve_compute_dtype",
           "seg_train_step", "set_learning_rate"]
