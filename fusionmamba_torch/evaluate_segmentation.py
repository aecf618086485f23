"""Segmentation evaluation CLI of the port (the counterpart of
`evaluate_segmentation.py`, itself covering the reference's
`evaluate_mfnet_segmentation.py`, `evaluate_pst900_segmentation{,_proper}.py`
and `evaluate_acod_segmentation.py`).

    python -m fusionmamba_torch.evaluate_segmentation --dataset mfnet|pst900|acod
        --ckpt model.pth [--model full|tiny|test] [--batch 4] [--image_size 256]
        [--out report.txt] [--device cuda|cpu]

Loads a `VSSM_Fusion_Segmentation` state dict in the reference layout into
`VSSMFusionSeg` and scores its predictions:
  * mfnet and pst900, on the test split: the confusion-matrix metrics
    (`RunningScore`) and the per-sample present-classes mAcc and mIoU;
  * acod, on the training split: S-, F- and E-measure and MAE of the
    foreground softmax.
The report is printed and written to `--out` (default
`<dataset>_segmentation_results.txt`), in the root script's format. It runs
on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from .checkpoints import load_reference_checkpoint
from .data import FusionDataset
from .device import select_device
from .eval import RunningScore, e_measure, f_measure_sod, mae, present_classes_metrics, s_measure
from .models import VSSMFusionSeg
from .train_segmentation import CONFIGS, NUM_CLASSES, predict_logits


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", required=True, choices=list(NUM_CLASSES))
    ap.add_argument("--ckpt", required=True, help="reference-layout .pth file")
    ap.add_argument("--model", choices=list(CONFIGS), default="full")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap, ap.parse_args(argv)


def _sod_lines(batches):
    s_vals, f_vals, e_vals, mae_vals = [], [], [], []
    for lbl, logits in batches:
        prob_fg = np.exp(logits[..., 1]) / np.exp(logits).sum(-1)
        for p, t in zip(prob_fg, lbl):
            s_vals.append(s_measure(p, t))
            f_vals.append(f_measure_sod(p, t))
            e_vals.append(e_measure(p, t))
            mae_vals.append(mae(p, t))
    metrics = {"s_measure": float(np.mean(s_vals)), "f_measure": float(np.mean(f_vals)),
               "e_measure": float(np.mean(e_vals)), "mae": float(np.mean(mae_vals))}
    lines = [f"S-measure: {metrics['s_measure']:.4f}", f"F-measure: {metrics['f_measure']:.4f}",
             f"E-measure: {metrics['e_measure']:.4f}", f"MAE: {metrics['mae']:.4f}",
             f"samples: {len(s_vals)}"]
    return metrics, lines, len(s_vals)


def _seg_lines(batches, num_classes: int):
    score = RunningScore(num_classes)
    present_accs, present_ious, n = [], [], 0
    for lbl, logits in batches:
        pred = logits.argmax(-1)
        score.update(lbl, pred)
        for p, t in zip(pred, lbl):
            m = present_classes_metrics(p, t, num_classes)
            if m:
                present_accs.append(m["mAcc"])
                present_ious.append(m["mIoU"])
            n += 1
    s = score.get_scores()
    metrics = {"present_mean_acc": float(np.mean(present_accs)),
               "mean_acc": float(s["mean_acc"]),
               "present_mean_iou": float(np.mean(present_ious)),
               "mean_iou": float(s["mean_iou"]), "pixel_acc": float(s["pixel_acc"]),
               "iou": s["iou"].tolist()}
    lines = [f"mAcc (present classes): {metrics['present_mean_acc']:.4f}",
             f"mAcc (all classes): {metrics['mean_acc']:.4f}",
             f"mIoU (present classes): {metrics['present_mean_iou']:.4f}",
             f"mIoU (overall): {metrics['mean_iou']:.4f}",
             f"pixel accuracy: {metrics['pixel_acc']:.4f}",
             f"samples: {n}",
             "per-class IoU: " + " ".join(f"{v:.4f}" for v in s["iou"])]
    return metrics, lines, n


def main(argv=None) -> dict:
    """Run the CLI; returns {"metrics", "samples", "report", "out",
    "seconds"}."""
    ap, args = parse_args(argv)
    try:
        device = select_device(args.device)
    except (RuntimeError, ValueError) as e:
        ap.error(str(e))
    if not args.ckpt.endswith(".pth"):
        ap.error("--ckpt takes a reference-layout .pth file")
    tic = time.time()
    num_classes = NUM_CLASSES[args.dataset]
    net = VSSMFusionSeg(CONFIGS[args.model](num_seg_classes=num_classes))
    load_reference_checkpoint(net, args.ckpt)
    net.to(device)
    split = "test" if args.dataset in ("mfnet", "pst900") else "train"
    try:
        ds = FusionDataset(split=split, dataset_name=args.dataset,
                           size=(args.image_size, args.image_size))
    except FileNotFoundError as e:
        ap.error(f"{args.dataset}: no dataset on disk ({e}); set FUSIONMAMBA_DATA_ROOT")
    batches = predict_logits(net, ds, args.batch, device)
    if args.dataset == "acod":
        metrics, lines, n = _sod_lines(batches)
    else:
        metrics, lines, n = _seg_lines(batches, num_classes)
    report = "\n".join([f"{args.dataset} segmentation evaluation", "=" * 40] + lines)
    print(report)
    out = args.out or f"{args.dataset}_segmentation_results.txt"
    with open(out, "w") as f:
        f.write(report + "\n")
    return {"metrics": metrics, "samples": n, "report": report, "out": out,
            "seconds": time.time() - tic}


if __name__ == "__main__":
    main()
