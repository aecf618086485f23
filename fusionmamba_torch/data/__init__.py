"""Training data of the port: the on-disk and synthetic datasets and the batch
iterator (`datasets.py`), the native preprocessing library that resizes their
pairs (`native.py`), the threaded loader and the device prefetch
(`prefetch.py`), the Y <-> RGB tools (`color.py`)."""
from .datasets import (IMG_EXTS, DatasetRoots, FusionDataset, SyntheticFusionDataset,
                       batch_iterator, prepare_data_path, preprocess_pair_plain)

__all__ = ["IMG_EXTS", "DatasetRoots", "FusionDataset", "SyntheticFusionDataset",
           "batch_iterator", "prepare_data_path", "preprocess_pair_plain"]
