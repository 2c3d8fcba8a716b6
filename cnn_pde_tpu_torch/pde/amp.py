"""The one-switch AMP grade — port of ``cnn_pde_tpu/pde/amp.py``.

``enable_amp(model)`` switches three things:

* every ADI layer of ``model`` to the hoisted bf16 path (``hoisted=True,
  operator_dtype=torch.bfloat16, hoisted_refine=False``): every sweep's
  inverse operator of the evolution built once a forward in float32 and
  stored in bf16, each sweep one GEMM with bf16 operands and float32
  accumulation (``ops/tridiag.py::gemm_route``);
* every ``ResidualDiffusion`` to ``solve_impl='matinv_bf16'``: its
  implicit sweeps (``use_implicit=True``) build their operator at the call
  and apply it in bf16 by one GEMM.  The JAX ``enable_amp`` reaches this
  layer through the global solver default ('matinv_bf16'), which also
  serves its other callers outside an ADI layer.  Here the route is the
  caller's own and the global default stays as it is, so
  ``tridiag_solve`` keeps K1 for every other per-sweep layer in the
  process: the flagship's lockstep modes read the first branch's
  ``operator_dtype`` (the hoisted lockstep builds its operators at bf16,
  the per-sweep lockstep solves by a bf16 operator built at each sweep,
  ``models/cifar10_noconv.py``), and the partitioned solve keeps its
  exact grade;
* with ``dense=True`` (the default), every port ``Conv2d``
  (``layers.py``) to ``compute_dtype=torch.bfloat16`` (bf16 operands, a
  bf16 output cast to float32) and every ``SymmetricLayer``
  (``pde/ruthotto.py``) to ``compute_dtype=torch.bfloat16`` (bf16
  operands, a float32 result).  A ``torch.nn.Conv2d`` that is not the
  port's raises ``TypeError`` before anything changes: the grade casts
  only the port's Conv2d.

The bands, boundary rows, clamps, mixing, BatchNorm and everything outside
the solves and convolutions stay float32, and so do the plain Linears (the
JAX grade measured a loss from casting them).  Nothing runs under
``torch.autocast``: it would cast those Linears.
"""

from __future__ import annotations

import torch
from torch import nn

from ..layers import Conv2d
from .diffusion import (ChannelCoupledDiffusion, GrayscaleDiffusion,
                        MixedChannelDiffusion)
from .residual import ResidualDiffusion
from .ruthotto import SymmetricLayer

__all__ = ["enable_amp", "iter_adi_layers", "iter_modules"]

_ADI_CLASSES = (GrayscaleDiffusion, ChannelCoupledDiffusion,
                MixedChannelDiffusion)


def iter_modules(module, classes):
    """Every submodule of ``module`` (itself included) that is an instance
    of ``classes``."""
    return (m for m in module.modules() if isinstance(m, classes))


def iter_adi_layers(module):
    """Every ADI diffusion layer of ``module``."""
    return iter_modules(module, _ADI_CLASSES)


def enable_amp(model=None, dense=True):
    """Switch ``model`` to the bf16 AMP grade; returns the number of ADI
    layers switched to the hoisted bf16 path, as the JAX function does
    (0 for a model without one).  ``dense=False`` leaves the convolutions
    exact and the SymmetricLayers at their own grade."""
    if model is None:
        return 0
    if dense:
        foreign = [type(m).__name__ for m in iter_modules(model, nn.Conv2d)
                   if not isinstance(m, Conv2d)]
        if foreign:
            raise TypeError(
                f"enable_amp(dense=True): the AMP grade casts only the "
                f"port's Conv2d (cnn_pde_tpu_torch.layers.Conv2d); this "
                f"model has {len(foreign)} other Conv2d ({foreign[0]})")
        for layer in iter_modules(model, (Conv2d, SymmetricLayer)):
            layer.compute_dtype = torch.bfloat16
    for layer in iter_modules(model, ResidualDiffusion):
        layer.solve_impl = "matinv_bf16"
    n = 0
    for layer in iter_adi_layers(model):
        layer.hoisted = True
        layer.operator_dtype = torch.bfloat16
        layer.hoisted_refine = False
        n += 1
    return n
