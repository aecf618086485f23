"""Salient-object-detection metrics for ACOD-12K eval (numpy): the port's
own copy of `fusionmamba_tpu/eval/metrics_sod.py`.

Matches the metric definitions of `evaluate_acod_segmentation.py:14-200`
(the reference's simplified S/F/E-measure variants, not the original papers'
full formulations -- reproduced as-is so numbers are comparable to
`acod_segmentation_results.txt`).
"""
from __future__ import annotations

import numpy as np


def _minmax(x: np.ndarray) -> np.ndarray:
    return (x - x.min()) / (x.max() - x.min() + 1e-8)


def s_measure(pred: np.ndarray, target: np.ndarray,
              alpha: float = 0.5) -> float:
    pred = _minmax(pred.astype(np.float64))
    target = np.clip(target.astype(np.float64), 0, 1)
    if target.sum() == 0:
        return 0.0
    gt_fg, gt_bg = target, 1.0 - target
    pred_fg, pred_bg = pred * gt_fg, pred * gt_bg
    mu_fg_pred, mu_fg_gt = pred_fg.mean(), gt_fg.mean()
    score_obj = np.clip(
        2.0 * mu_fg_pred * mu_fg_gt / (mu_fg_pred ** 2 + mu_fg_gt ** 2 + 1e-8),
        0, 1)

    def _reg(sp, sg):
        if sp == 0 and sg == 0:
            return 1.0
        if sp == 0 or sg == 0:
            return 0.0
        return float(np.clip(2.0 * sp * sg / (sp ** 2 + sg ** 2 + 1e-8), 0, 1))

    score_reg = 0.5 * (_reg(pred_fg.std(), gt_fg.std())
                       + _reg(pred_bg.std(), gt_bg.std()))
    return float(np.clip(alpha * score_obj + (1 - alpha) * score_reg, 0, 1))


def f_measure_sod(pred: np.ndarray, target: np.ndarray,
                  beta: float = 0.3) -> float:
    pred = _minmax(pred.astype(np.float64))
    target = np.clip(target.astype(np.float64), 0, 1)
    if target.sum() == 0:
        return 0.0
    thr = min(max(pred.mean() + 0.5 * pred.std(), pred.mean()), 1.0)
    pb = (pred >= thr).astype(np.float64)
    tb = (target >= 0.5).astype(np.float64)
    tp = (pb * tb).sum()
    fp = (pb * (1 - tb)).sum()
    fn = ((1 - pb) * tb).sum()
    precision = tp / (tp + fp) if tp + fp > 0 else 0.0
    recall = tp / (tp + fn) if tp + fn > 0 else 0.0
    if precision + recall == 0:
        return 0.0
    b2 = beta * beta
    return float((1 + b2) * precision * recall / (b2 * precision + recall))


def e_measure(pred: np.ndarray, target: np.ndarray) -> float:
    pred = np.squeeze(pred)
    target = np.squeeze(target)
    pred = _minmax(pred.astype(np.float64))
    target = np.clip(target.astype(np.float64), 0, 1)
    if target.sum() == 0:
        return 0.0
    pn = pred - pred.mean()
    tn = target - target.mean()
    align = 2.0 * pn * tn / (pn ** 2 + tn ** 2 + 1e-8)
    return float(np.clip(((align + 1.0) / 2.0).mean(), 0, 1))


def mae(pred: np.ndarray, target: np.ndarray) -> float:
    p = pred.astype(np.float64).flatten()
    t = target.astype(np.float64).flatten()
    if p.max() > p.min():
        p = (p - p.min()) / (p.max() - p.min())
    if t.max() > t.min():
        t = (t - t.min()) / (t.max() - t.min())
    return float(np.abs(p - t).mean())
