"""Synthetic training pairs and the batch iterator, in numpy: the port's own
copy of `fusionmamba_tpu/data/datasets.py::SyntheticFusionDataset` (without
its segmentation labels) and `::batch_iterator`, with the same seeds, so that
both packages see the same pairs. (The on-disk `FusionDataset` is not ported
yet.)"""
from __future__ import annotations

from typing import Iterator

import numpy as np


class SyntheticFusionDataset:
    """Deterministic random pairs standing in for the on-disk datasets: item i
    is (vis_y, ir), float32 (H, W, 1) in [0, 1], each a field of coarse
    uniform noise upsampled by 16 (smooth enough that SSIM windows see
    structure)."""

    def __init__(self, length: int = 32, size: tuple = (256, 256), seed: int = 0):
        self.length = length
        self.size = size
        self.seed = seed

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int):
        rng = np.random.default_rng(self.seed * 100003 + index)
        h, w = self.size

        def field():
            coarse = rng.uniform(0, 1, (h // 16, w // 16)).astype(np.float32)
            return np.kron(coarse, np.ones((16, 16), np.float32))

        return field()[..., None], field()[..., None]


def batch_iterator(ds, batch_size: int, shuffle: bool = True, seed: int = 0,
                   epochs: int | None = 1) -> Iterator[tuple]:
    """Epochs over `ds`, yielding stacked NHWC numpy batches; a last partial
    batch is dropped."""
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = np.arange(len(ds))
        if shuffle:
            rng.shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            items = [ds[int(i)] for i in order[start:start + batch_size]]
            yield tuple(np.stack(parts) for parts in zip(*items))
        epoch += 1
