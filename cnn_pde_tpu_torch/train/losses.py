"""Loss — port of ``cnn_pde_tpu/train/losses.py::cross_entropy``."""

from __future__ import annotations

import torch.nn.functional as F

__all__ = ["cross_entropy"]


def cross_entropy(logits, labels, label_smoothing: float = 0.0):
    """Mean cross-entropy over the batch with torch-style label smoothing
    (ε/K spread over every class, the target included): the JAX
    function's definition, which ``F.cross_entropy`` computes."""
    return F.cross_entropy(logits, labels.long(),
                           label_smoothing=label_smoothing)
