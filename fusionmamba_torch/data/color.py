"""Y <-> RGB colour-space tools, in numpy and PIL: the port's own copy of
`fusionmamba_tpu/data/color.py` (its PIL path).

For fusing a colour image (PET/SPECT beside MRI, RGB beside IR): extract the
luma (Y) channel before fusing, then put the fused Y back into the source's
chroma. Array functions, and functions over whole folders.
"""
from __future__ import annotations

import os

import numpy as np
from PIL import Image


def rgb_to_y(rgb: np.ndarray) -> np.ndarray:
    """Y channel (ITU-R BT.601 full range, the PIL YCbCr convention). rgb
    uint8 or float in [0, 255]; returns the same scale."""
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def rgb_to_ycrcb(rgb: np.ndarray) -> np.ndarray:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cr = (r - y) * 0.713 + 128.0
    cb = (b - y) * 0.564 + 128.0
    return np.stack([y, cr, cb], axis=-1)


def ycrcb_to_rgb(ycrcb: np.ndarray) -> np.ndarray:
    y, cr, cb = ycrcb[..., 0], ycrcb[..., 1], ycrcb[..., 2]
    r = y + 1.403 * (cr - 128.0)
    g = y - 0.714 * (cr - 128.0) - 0.344 * (cb - 128.0)
    b = y + 1.773 * (cb - 128.0)
    return np.stack([r, g, b], axis=-1)


def reinject_y(fused_y: np.ndarray, original_rgb: np.ndarray) -> np.ndarray:
    """original_rgb with its Y channel replaced by fused_y (uint8 in, uint8
    out); fused_y is resized bicubic to the original's size first."""
    if fused_y.shape[:2] != original_rgb.shape[:2]:
        fused_y = np.array(Image.fromarray(fused_y).resize(
            (original_rgb.shape[1], original_rgb.shape[0]), resample=Image.BICUBIC))
    ycrcb = rgb_to_ycrcb(original_rgb.astype(np.float32))
    ycrcb[..., 0] = fused_y.astype(np.float32)
    return np.clip(ycrcb_to_rgb(ycrcb), 0, 255).astype(np.uint8)


def extract_y_dir(input_path: str, output_path: str) -> int:
    """The Y channel (PIL YCbCr) of every image of a folder, saved as PNG
    under the same stem. Returns the count."""
    os.makedirs(output_path, exist_ok=True)
    count = 0
    for name in sorted(os.listdir(input_path)):
        if not name.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
            continue
        with Image.open(os.path.join(input_path, name)) as img:
            y = img.convert("RGB").convert("YCbCr").split()[0]
            y.save(os.path.join(output_path, os.path.splitext(name)[0] + ".png"), format="PNG")
            count += 1
    return count


def reinject_y_dir(fused_dir: str, rgb_dir: str, output_dir: str) -> int:
    """`reinject_y` for every image of rgb_dir with a fused Y of the same name
    in fused_dir. Returns the count."""
    os.makedirs(output_dir, exist_ok=True)
    count = 0
    for name in sorted(os.listdir(rgb_dir)):
        fp = os.path.join(fused_dir, name)
        if not os.path.exists(fp):
            continue
        with Image.open(fp) as f, Image.open(os.path.join(rgb_dir, name)) as r:
            fused, rgb = np.asarray(f.convert("L")), np.asarray(r.convert("RGB"))
        Image.fromarray(reinject_y(fused, rgb)).save(os.path.join(output_dir, name))
        count += 1
    return count
