"""Data of the port: the real-format loaders and normalisation constants
(``real``), the synthetic stand-ins of the datasets (``synthetic``),
on-device augmentation (``augment``) and the host-side batching of an
in-memory dataset (``pipeline``)."""

from .augment import AugmentSpec
from .pipeline import ArrayDataset, balance_classes, synthetic_dataset
from .real import NORMALIZATION, load_dataset
from .synthetic import (SYNTHETIC_SPECS, make_synthetic,
                        write_synthetic_tiny_imagenet)

__all__ = ["AugmentSpec", "ArrayDataset", "balance_classes",
           "synthetic_dataset", "NORMALIZATION", "load_dataset",
           "SYNTHETIC_SPECS", "make_synthetic",
           "write_synthetic_tiny_imagenet"]
