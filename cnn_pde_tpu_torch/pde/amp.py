"""The one-switch AMP grade — port of ``cnn_pde_tpu/pde/amp.py``.

``enable_amp(model)`` puts every ADI layer of ``model`` on the hoisted bf16
path (``hoisted=True, operator_dtype=torch.bfloat16, hoisted_refine=False``:
every sweep's inverse operator built once a forward in float32 and stored in
bf16, each sweep one GEMM with bf16 operands and float32 accumulation,
``ops/tridiag.py::gemm_route``).  The JAX ``enable_amp`` also sets the
global solver default to 'matinv_bf16', for the solves its unported
callers run outside an ADI layer (the multiscale fused path and the
distributed solve, ROADMAP.md A14); no ported solve reads that default on
this path, so here it stays as it is and ``tridiag_solve`` keeps K1 for
every per-sweep layer in the process.  The bands, boundary rows, clamps,
mixing and everything outside the solves stay float32, and so do the plain
Linears (the JAX grade measured a loss from casting them).  Nothing runs under ``torch.autocast``: it would cast
those Linears.

The JAX grade's dense half casts Conv2d and SymmetricLayer operands to
bf16; no ported family has either, and a model with an ``nn.Conv2d``
raises (ROADMAP.md A10) rather than run a grade the JAX package does not.
"""

from __future__ import annotations

import torch
from torch import nn

from .diffusion import (ChannelCoupledDiffusion, GrayscaleDiffusion,
                        MixedChannelDiffusion)

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
    layers switched to the hoisted bf16 path.  ``dense=True`` would cast
    convolutions to bf16 operands: a model that has one raises
    ``NotImplementedError`` (ROADMAP.md A10) before anything is changed."""
    if model is not None and dense and any(iter_modules(model, nn.Conv2d)):
        raise NotImplementedError(
            "enable_amp(dense=True) on a model with Conv2d layers is not "
            "ported yet: ROADMAP.md A10")
    n = 0
    if model is not None:
        for layer in iter_adi_layers(model):
            layer.hoisted = True
            layer.operator_dtype = torch.bfloat16
            layer.hoisted_refine = False
            n += 1
    return n
