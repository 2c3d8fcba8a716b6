"""Data of the port: the synthetic stand-ins of the ported datasets
(``synthetic``) and on-device augmentation (``augment``)."""

from .augment import AugmentSpec
from .synthetic import make_synthetic

__all__ = ["AugmentSpec", "make_synthetic"]
