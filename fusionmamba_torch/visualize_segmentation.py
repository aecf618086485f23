"""Segmentation visualization CLI of the port (the counterpart of
`visualize_segmentation.py`, itself covering the reference's
`visualize_acod_segmentation.py` and `generate_segmentation_comparison.py`).

    python -m fusionmamba_torch.visualize_segmentation --dataset acod|mfnet|pst900
        --ckpt model.pth [--out_dir visualizations] [--num_samples 8]
        [--model full|tiny|test] [--image_size 256] [--device cuda|cpu]

Loads a `VSSM_Fusion_Segmentation` state dict in the reference layout into
`VSSMFusionSeg`, runs it on the first `--num_samples` pairs of the split
(test for mfnet and pst900, train for acod) one pair at a time, and writes a
PNG grid a pair, `<dataset>_sample<i>.png`: [vis | ir | fused | GT |
prediction], the fused image clipped to [0, 1] and the labels coloured with
the per-dataset palette. It runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
from PIL import Image

from .checkpoints import load_reference_checkpoint
from .data import FusionDataset
from .device import select_device
from .models import VSSMFusionSeg
from .train_segmentation import CONFIGS, NUM_CLASSES

# MFNet-style palette (class 0 = unlabeled/background)
PALETTE = np.array([
    [0, 0, 0], [64, 0, 128], [64, 64, 0], [0, 128, 192], [0, 0, 192],
    [128, 128, 0], [64, 64, 128], [192, 128, 128], [192, 64, 0],
], np.uint8)


def colorize(labels: np.ndarray, num_classes: int) -> np.ndarray:
    pal = PALETTE[:num_classes]
    return pal[np.clip(labels.astype(int), 0, num_classes - 1)]


def to_rgb(gray01: np.ndarray) -> np.ndarray:
    g = (np.clip(np.squeeze(gray01), 0, 1) * 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", required=True, choices=list(NUM_CLASSES))
    ap.add_argument("--ckpt", required=True, help="reference-layout .pth file")
    ap.add_argument("--out_dir", default="visualizations")
    ap.add_argument("--num_samples", type=int, default=8)
    ap.add_argument("--model", choices=list(CONFIGS), default="full")
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap, ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI; returns {"written", "out_dir", "seconds",
    "sample_seconds"}: each sample's seconds from its read to its PNG."""
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
    net.eval().to(device)
    split = "test" if args.dataset in ("mfnet", "pst900") else "train"
    try:
        ds = FusionDataset(split=split, dataset_name=args.dataset,
                           size=(args.image_size, args.image_size))
    except FileNotFoundError as e:
        ap.error(f"{args.dataset}: no dataset on disk ({e}); set FUSIONMAMBA_DATA_ROOT")
    os.makedirs(args.out_dir, exist_ok=True)
    n = min(args.num_samples, len(ds))
    sample_seconds = []
    for i in range(n):
        t0 = time.perf_counter()
        item = ds[i]
        vis_y, ir = item[0], item[1]
        with torch.inference_mode():
            out = net(torch.from_numpy(vis_y[None]).to(device),
                      torch.from_numpy(ir[None]).to(device))
            fused = out["fusion"][0].clamp(0, 1).cpu().numpy()
            pred = out["segmentation"][0].argmax(-1).cpu().numpy()
        panels = [to_rgb(vis_y), to_rgb(ir), to_rgb(fused)]
        if len(item) > 2:
            panels.append(colorize(item[2], num_classes))
        panels.append(colorize(pred, num_classes))
        Image.fromarray(np.concatenate(panels, axis=1)).save(
            os.path.join(args.out_dir, f"{args.dataset}_sample{i}.png"))
        sample_seconds.append(time.perf_counter() - t0)
    print(f"wrote {n} visualization grids to {args.out_dir}")
    return {"written": n, "out_dir": args.out_dir, "seconds": time.time() - tic,
            "sample_seconds": sample_seconds}


if __name__ == "__main__":
    main()
