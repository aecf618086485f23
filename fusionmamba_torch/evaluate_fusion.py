"""Fusion-quality and parity evaluation CLI of the port (the counterpart of
`evaluate_fusion.py`).

    python -m fusionmamba_torch.evaluate_fusion --ir_dir D1 --vis_dir D2 \
        --fused_dir D3 [--ref_dir D4] [--out results.txt]

The standard image-fusion metrics (Qabf, EN, SD, MI, SSIM to each source)
over a folder of fused outputs and, given a folder of a reference
implementation's outputs, SSIM(ours, reference) per pair, whose mean is held
to 0.999. Files are matched by basename across the folders; the sources (and
reference) are read as grayscale and resized bicubic to the fused image's
size. Prints a tab-separated table with a MEAN row, and writes it to `--out`.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image

from .eval import fusion_report

PARITY_SSIM = 0.999
_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif")


def _index(d: str) -> dict:
    """basename -> path of the images of folder d."""
    return {os.path.splitext(name)[0]: os.path.join(d, name)
            for name in sorted(os.listdir(d)) if name.lower().endswith(_EXTS)}


def _load(path: str, size=None) -> np.ndarray:
    """Grayscale in [0, 1], float64, resized bicubic to PIL `size` (W, H)
    where given and different."""
    with Image.open(path) as img:
        img = img.convert("L")
        if size is not None and img.size != size:
            img = img.resize(size, Image.BICUBIC)
        return np.asarray(img, np.float64) / 255.0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ir_dir", required=True)
    ap.add_argument("--vis_dir", required=True)
    ap.add_argument("--fused_dir", required=True)
    ap.add_argument("--ref_dir", default=None,
                    help="reference implementation's fused outputs (adds the SSIM-parity column)")
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI; returns {"rows": {name: {metric: value}}, "means":
    {metric: mean}, "table": the printed table}."""
    args = parse_args(argv)
    ir, vis, fused = _index(args.ir_dir), _index(args.vis_dir), _index(args.fused_dir)
    ref = _index(args.ref_dir) if args.ref_dir else {}
    keys = sorted(set(ir) & set(vis) & set(fused))
    if not keys:
        raise SystemExit("no matching basenames across directories")

    rows = {}
    for k in keys:
        with Image.open(fused[k]) as img:
            size = img.size
        rows[k] = fusion_report(_load(vis[k], size), _load(ir[k], size), _load(fused[k]),
                                _load(ref[k], size) if k in ref else None)

    metrics = sorted({m for rep in rows.values() for m in rep})
    lines = ["name\t" + "\t".join(metrics)]
    for k, rep in rows.items():
        lines.append(k + "\t" + "\t".join(f"{rep.get(m, float('nan')):.4f}" for m in metrics))
    means = {m: float(np.nanmean([rep.get(m, np.nan) for rep in rows.values()]))
             for m in metrics}
    lines.append("MEAN\t" + "\t".join(f"{means[m]:.4f}" for m in metrics))
    text = "\n".join(lines)
    print(text)
    if "ssim_vs_reference" in means:
        ok = means["ssim_vs_reference"] >= PARITY_SSIM
        print(f"\nparity SSIM vs reference: {means['ssim_vs_reference']:.5f} "
              f"({'PASS' if ok else 'BELOW'} {PARITY_SSIM} north star)")
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"written: {args.out}")
    return {"rows": rows, "means": means, "table": text}


if __name__ == "__main__":
    main()
