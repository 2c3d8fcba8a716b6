"""Coefficient smoothing — port of ``cnn_pde_tpu/ops/smoothing.py``: the
3-tap replicate-padded moving average that the grayscale (and SVHN) layers
apply to a coefficient field along its sweep axis before each sweep.  The
CIFAR layers pass their coefficients raw."""

from __future__ import annotations

import torch

__all__ = ["smooth3"]


def smooth3(coeffs: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Moving average with kernel [1/3, 1/3, 1/3] and replicate (edge)
    padding along ``dim``, computed as l·k + c·k + r·k with k = 1/3 in the
    field's dtype, as the JAX function does.  The result is contiguous:
    it becomes the bands of a kernel's solve."""
    c = coeffs.movedim(dim, -1)
    left = torch.cat([c[..., :1], c[..., :-1]], dim=-1)
    right = torch.cat([c[..., 1:], c[..., -1:]], dim=-1)
    k = 1.0 / 3.0
    return (left * k + c * k + right * k).movedim(-1, dim).contiguous()
