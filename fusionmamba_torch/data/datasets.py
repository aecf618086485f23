"""Training data of the port, in numpy: the on-disk fusion datasets, the
synthetic pairs and the batch iterator. The port's own copy of
`fusionmamba_tpu/data/datasets.py` (its PIL path: the port reads images with
PIL only), with the same discovery, item pipeline and seeds, so that both
packages see the same pairs.

On-disk layouts (the reference's `TaskFusion_dataset.py`), under roots set by
`FUSIONMAMBA_DATA_ROOT` (default `/data`):
  * acod: `ACOD-12K/Train/{Imgs,Depth,GT}`, the depth file named by
    `_left_` -> `_depth_`;
  * mfnet: `MFNet/ir_seg_dataset/{images,visual,labels}` (RGB .png, thermal
    .jpg), its test split listed in `test.txt`;
  * pst900: `PST900_RGBT_Dataset/<split>/{rgb,thermal,labels}`, unreadable
    files left out;
  * any other test set: two paired folders, `vi_path` and `ir_path`.
An item is (vis_y, ir) float32 (H, W, 1) in [0, 1] (PIL bicubic resize to
`size`, the visible image's BT.601 luma rounded to uint8, then / 255), plus an
int32 (H, W) label (nearest resize; acod thresholded at 127 to {0, 1}, the
others rounded and clipped to [0, 8]) where the dataset has labels.
"""
from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from typing import Iterator, Sequence

import numpy as np
from PIL import Image

IMG_EXTS = (".bmp", ".tif", ".jpg", ".png")


def _read(path: str, mode: str) -> np.ndarray | None:
    """The image at `path` converted to PIL `mode` ("RGB" or "L"), or None
    where it cannot be read."""
    try:
        with Image.open(path) as img:
            return np.asarray(img.convert(mode))
    except Exception:
        return None


def _resize(arr: np.ndarray, size_hw: Sequence[int], resample: int) -> np.ndarray:
    """PIL resize to (H, W) (PIL takes (W, H)), as the reference's `imresize`."""
    return np.array(Image.fromarray(arr).resize((size_hw[1], size_hw[0]), resample=resample))


def _rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """ITU-R BT.601 luma, rounded to rgb's dtype."""
    g = rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114
    return np.round(g).astype(rgb.dtype)


def prepare_data_path(dataset_path: str):
    """The images of a folder (`IMG_EXTS`, sorted) and all its names, sorted."""
    data = []
    for ext in IMG_EXTS:
        data.extend(glob.glob(os.path.join(dataset_path, f"*{ext}")))
    data.sort()
    return data, sorted(os.listdir(dataset_path))


@dataclass
class DatasetRoots:
    """The folder of each dataset."""
    acod: str = ""
    mfnet: str = ""
    pst900: str = ""

    @classmethod
    def from_env(cls) -> "DatasetRoots":
        base = os.environ.get("FUSIONMAMBA_DATA_ROOT", "/data")
        return cls(acod=os.path.join(base, "ACOD-12K"),
                   mfnet=os.path.join(base, "MFNet", "ir_seg_dataset"),
                   pst900=os.path.join(base, "PST900_RGBT_Dataset"))


@dataclass
class FusionDataset:
    """The pairs (and labels) of one dataset and split: "train" for acod,
    mfnet or pst900; "val" or "test" for pst900's and mfnet's test splits or,
    for any other name, the paired folders `vi_path` and `ir_path`. `length`
    caps the number of items (0: all)."""
    split: str = "train"
    dataset_name: str = "acod"
    ir_path: str | None = None
    vi_path: str | None = None
    length: int = 0
    size: tuple = (256, 256)
    roots: DatasetRoots = field(default_factory=DatasetRoots.from_env)

    def __post_init__(self):
        if self.split not in ("train", "val", "test"):
            raise ValueError(f"unknown split {self.split!r}")
        self.filepath_vis: list[str] = []
        self.filepath_ir: list[str] = []
        self.filepath_labels: list[str] = []
        if self.split == "train":
            loader = {"acod": self._load_acod, "mfnet": self._load_mfnet,
                      "pst900": lambda: self._load_pst900("train")}.get(self.dataset_name)
            if loader is None:
                raise ValueError(f"Unknown dataset: {self.dataset_name}")
            loader()
        elif self.dataset_name == "pst900":
            self._load_pst900("test")
        elif self.dataset_name == "mfnet":
            self._load_mfnet_test()
        else:
            self.filepath_vis, _ = prepare_data_path(self.vi_path)
            self.filepath_ir, _ = prepare_data_path(self.ir_path)
        if self.length == 0 or self.length > len(self.filepath_vis):
            self.length = len(self.filepath_vis)

    def _add(self, vis: str, ir: str, label: str) -> None:
        self.filepath_vis.append(vis)
        self.filepath_ir.append(ir)
        self.filepath_labels.append(label)

    def _load_acod(self):
        base = os.path.join(self.roots.acod, "Train")
        for f in sorted(os.listdir(os.path.join(base, "Imgs"))):
            if not f.endswith(IMG_EXTS):
                continue
            p_ir = os.path.join(base, "Depth", f.replace("_left_", "_depth_"))
            p_gt = os.path.join(base, "GT", f)
            if os.path.exists(p_ir) and os.path.exists(p_gt):
                self._add(os.path.join(base, "Imgs", f), p_ir, p_gt)

    def _load_mfnet(self):
        base = self.roots.mfnet
        for f in sorted(os.listdir(os.path.join(base, "images"))):
            if not f.endswith(".png"):
                continue
            p_ir = os.path.join(base, "visual", f.replace(".png", ".jpg"))
            p_lbl = os.path.join(base, "labels", f)
            if os.path.exists(p_ir) and os.path.exists(p_lbl):
                self._add(os.path.join(base, "images", f), p_ir, p_lbl)

    def _load_mfnet_test(self):
        base = self.roots.mfnet
        with open(os.path.join(base, "test.txt")) as f:
            ids = [line.strip() for line in f]
        for fid in ids:
            paths = (os.path.join(base, "images", f"{fid}.png"),
                     os.path.join(base, "visual", f"{fid}.jpg"),
                     os.path.join(base, "labels", f"{fid}.png"))
            if all(os.path.exists(p) for p in paths) and _read(paths[0], "RGB") is not None:
                self._add(*paths)

    def _load_pst900(self, split: str):
        base = os.path.join(self.roots.pst900, split)
        for f in sorted(os.listdir(os.path.join(base, "rgb"))):
            if not f.endswith(IMG_EXTS):
                continue
            paths = tuple(os.path.join(base, d, f) for d in ("rgb", "thermal", "labels"))
            if not (os.path.exists(paths[1]) and os.path.exists(paths[2])):
                continue
            if (_read(paths[0], "RGB") is None or _read(paths[1], "L") is None
                    or _read(paths[2], "L") is None):
                continue
            self._add(*paths)

    @property
    def has_labels(self) -> bool:
        return len(self.filepath_labels) > 0

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int):
        """Item `index`, or the next readable pair after it where it cannot be
        read."""
        n = len(self.filepath_vis)
        for _ in range(n):
            vis = _read(self.filepath_vis[index], "RGB")
            ir = _read(self.filepath_ir[index], "L")
            if vis is None or ir is None:
                index = (index + 1) % n
                continue
            ir = _resize(ir, self.size, Image.BICUBIC).astype(np.float32)[..., None] / 255.0
            vis_y = _rgb_to_gray(_resize(vis, self.size, Image.BICUBIC))
            vis_y = vis_y.astype(np.float32)[..., None] / 255.0
            if self.has_labels:
                lbl = _read(self.filepath_labels[index], "L")
                if lbl is not None:
                    lbl = _resize(lbl, self.size, Image.NEAREST).astype(np.float32)
                    if self.dataset_name == "acod":
                        lbl = (lbl > 127).astype(np.float32)
                    else:
                        lbl = np.clip(np.round(lbl), 0, 8)
                    return vis_y, ir, lbl.astype(np.int32)
            return vis_y, ir
        raise ValueError(f"All attempts to load images failed for {self.dataset_name}")


class SyntheticFusionDataset:
    """Deterministic random pairs standing in for the on-disk datasets: item i
    is (vis_y, ir), float32 (H, W, 1) in [0, 1], each a field of coarse
    uniform noise upsampled by 16 (smooth enough that SSIM windows see
    structure), plus an int32 (H, W) label when `num_classes` is set: binary
    for 1 (as acod's thresholded ground truth), else 32x32 blocks of class
    ids."""

    def __init__(self, length: int = 32, size: tuple = (256, 256),
                 num_classes: int | None = None, seed: int = 0):
        self.length = length
        self.size = size
        self.num_classes = num_classes
        self.seed = seed

    @property
    def has_labels(self) -> bool:
        return self.num_classes is not None

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int):
        rng = np.random.default_rng(self.seed * 100003 + index)
        h, w = self.size

        def field():
            coarse = rng.uniform(0, 1, (h // 16, w // 16)).astype(np.float32)
            return np.kron(coarse, np.ones((16, 16), np.float32))

        vis_y, ir = field()[..., None], field()[..., None]
        if self.num_classes is None:
            return vis_y, ir
        if self.num_classes == 1:
            lbl = (field() > 0.5).astype(np.int32)
        else:
            lbl = rng.integers(0, self.num_classes, (h // 32, w // 32)).astype(np.int32)
            lbl = np.kron(lbl, np.ones((32, 32), np.int32))
        return vis_y, ir, lbl


def batch_iterator(ds, batch_size: int, shuffle: bool = True, seed: int = 0,
                   drop_last: bool = True, epochs: int | None = 1) -> Iterator[tuple]:
    """Epochs over `ds`, yielding stacked NHWC numpy batches; a last partial
    batch is dropped unless `drop_last` is false."""
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = np.arange(len(ds))
        if shuffle:
            rng.shuffle(order)
        for start in range(0, len(order), batch_size):
            idx = order[start:start + batch_size]
            if drop_last and len(idx) < batch_size:
                break
            items = [ds[int(i)] for i in idx]
            yield tuple(np.stack(parts) for parts in zip(*items))
        epoch += 1
