"""Training data of the port."""
from .datasets import SyntheticFusionDataset, batch_iterator

__all__ = ["SyntheticFusionDataset", "batch_iterator"]
