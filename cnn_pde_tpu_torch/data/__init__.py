"""Data of the port: the synthetic stand-ins of the ported datasets
(``synthetic``), on-device augmentation (``augment``) and the host-side
batching of an in-memory dataset (``pipeline``)."""

from .augment import AugmentSpec
from .pipeline import ArrayDataset, balance_classes, synthetic_dataset
from .synthetic import make_synthetic

__all__ = ["AugmentSpec", "ArrayDataset", "balance_classes",
           "synthetic_dataset", "make_synthetic"]
