"""Segmentation metrics (numpy) matching the reference eval suite: the
port's own copy of `fusionmamba_tpu/eval/metrics_seg.py`.

* `RunningScore`: overall confusion-matrix metrics (pixel acc, per-class acc,
  mAcc, per-class IoU, mIoU, fwIoU) -- the pytorch-semseg style class used by
  `evaluate_pst900_segmentation_proper.py:8-84`.
* `present_classes_metrics`: the per-sample "present-classes-only" mAcc/mIoU
  variant of `evaluate_mfnet_segmentation.py:14-104`.
"""
from __future__ import annotations

import numpy as np


class RunningScore:
    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.confusion = np.zeros((n_classes, n_classes), np.int64)

    def _hist(self, label_true, label_pred):
        mask = (label_true >= 0) & (label_true < self.n_classes)
        hist = np.bincount(
            self.n_classes * label_true[mask].astype(int)
            + label_pred[mask].astype(int),
            minlength=self.n_classes ** 2,
        ).reshape(self.n_classes, self.n_classes)
        return hist

    def update(self, label_trues, label_preds):
        for lt, lp in zip(label_trues, label_preds):
            self.confusion += self._hist(lt.flatten(), lp.flatten())

    def get_scores(self):
        hist = self.confusion.astype(np.float64)
        eps = 1e-12
        acc = np.diag(hist).sum() / (hist.sum() + eps)
        acc_cls = np.diag(hist) / (hist.sum(axis=1) + eps)
        mean_acc = np.nanmean(
            np.where(hist.sum(axis=1) > 0, acc_cls, np.nan))
        iu = np.diag(hist) / (
            hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist) + eps)
        valid = (hist.sum(axis=1) + hist.sum(axis=0)) > 0
        mean_iu = np.nanmean(np.where(valid, iu, np.nan))
        freq = hist.sum(axis=1) / (hist.sum() + eps)
        fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
        return {
            "pixel_acc": acc,
            "class_acc": acc_cls,
            "mean_acc": mean_acc,
            "iou": iu,
            "mean_iou": mean_iu,
            "fw_iou": fwavacc,
        }


def present_classes_metrics(pred: np.ndarray, target: np.ndarray,
                            n_classes: int):
    """Per-sample metrics over the classes present in the target
    (`evaluate_mfnet_segmentation.py:14-104` semantics)."""
    accs, ious = [], []
    for c in np.unique(target):
        c = int(c)
        if c < 0 or c >= n_classes:
            continue
        t = target == c
        p = pred == c
        tp = np.logical_and(t, p).sum()
        accs.append(tp / max(t.sum(), 1))
        union = np.logical_or(t, p).sum()
        ious.append(tp / max(union, 1))
    if not accs:
        return None
    return {"mAcc": float(np.mean(accs)), "mIoU": float(np.mean(ious))}
