"""The CIFAR-10 no-convolution flagship — port of
``cnn_pde_tpu/models/cifar10_noconv.py`` (M5-M7), default branch path.

Attribute names follow the reference's ``state_dict`` namespace, so a
reference checkpoint loads with ``load_state_dict(strict=True)``.
``fused_pde=True`` runs each branch as one trainable fused call (K4 forward,
K5 backward on the card); ``fused_inference=True`` runs each branch as one K2
launch in eval.  The JAX package's three study modes of the extractor
(``pde/fused_multiscale.py``), with its precedence:

* a branch layout (``parallel/branch_parallel.py::enable_branch_parallel``)
  or ``lockstep_hoisted = True``: the three branches in lockstep on
  precomputed operators, 24 stacked GEMM sweeps, the operators built by
  two K1 launches a forward at the first branch's ``operator_dtype`` (bf16
  after ``enable_amp``), eps and clamp;
* ``fused=True`` (``CIFAR10PDENoConv(fused_multiscale=True)``): the
  per-sweep lockstep, 24 K1 launches a forward and 24 K3 a backward
  (51 each on the sequential path); after ``enable_amp`` each sweep is a
  bf16 operator built at the call ('matinv_bf16'), as the JAX package's
  global solver default makes it;
* otherwise the sequential branches.

The parameters keep their per-branch names in every mode.

Dropout draws its mask from an explicit ``torch.Generator`` on the
activations' device (``set_dropout_generator``); without one it uses
torch's default generator, as ``build_model`` does for the init.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..pde import MixedChannelDiffusion
from ..pde.fused_multiscale import (fused_multiscale_evolve,
                                    hoisted_lockstep_evolve, lockstep_tables)
from .attention import SpatialAttention

__all__ = ["MultiScaleExtractor", "EnhancedFC", "CIFAR10PDENoConv",
           "Dropout", "set_dropout_generator"]


class Dropout(nn.Module):
    """Inverted dropout, as the JAX layer: in training keep each activation
    with probability 1 − p and scale it by 1/(1 − p), with the mask drawn
    from ``self.generator``.  ``self.rows`` = (rank, world), set by a
    data-parallel step (``set_dropout_generator(rows=)``): the mask is
    drawn for the global batch of ``world`` equal blocks and this rank's
    block kept, so the ranks together draw the single-device mask.
    In a tensor-parallel model (``parallel/tensor_parallel.py``) between a
    column- and a row-parallel Linear the activations are this rank's
    block of the features (``self.features.block``): the mask is drawn for
    all of them and the block kept the same way."""

    def __init__(self, p=0.5):
        super().__init__()
        self.p = float(p)
        self.generator = None
        self.rows = None
        self.features = None  # a tensor-parallel model's FeatureBlock

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        b = x.shape[0]
        rank, world = self.rows or (0, 1)
        col, cols = (self.features and self.features.block) or (0, 1)
        f = x.shape[1]
        draw = torch.rand((b * world, f * cols) + tuple(x.shape[2:]),
                          generator=self.generator, device=x.device,
                          dtype=x.dtype)[rank * b:(rank + 1) * b,
                                         col * f:(col + 1) * f]
        return torch.where(draw < keep, x / keep, torch.zeros_like(x))

    def extra_repr(self):
        return f"p={self.p}"


def set_dropout_generator(model, generator, rows=None):
    """Draw every Dropout mask of ``model`` from ``generator``; ``rows`` =
    (rank, world) draws each for the global batch and keeps the rank's
    block (a data-parallel step)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
            m.rows = rows


class MultiScaleExtractor(nn.Module):
    """Three Strang PDE branches at different temporal and spatial scales,
    each gated by SpatialAttention, combined by softmax weights.

    ``fused``: the per-sweep lockstep; ``lockstep_hoisted``: the lockstep
    on precomputed operators; ``branch_mesh`` / ``branch_axis``: the
    hoisted lockstep with its branch axis split over that mesh axis (set
    by ``enable_branch_parallel``).  The lockstep's time tables are
    buffers on the model's device (not in the state dict)."""

    SCALES = [dict(dt=0.001, num_steps=5, dx=1.0, dy=1.0),
              dict(dt=0.002, num_steps=8, dx=2.0, dy=2.0),
              dict(dt=0.005, num_steps=4, dx=1.5, dy=1.5)]

    def __init__(self, input_size=32, channels=3, fused_inference=False,
                 fused_pde=False, fused=False, device=None):
        super().__init__()
        if fused and (fused_pde or fused_inference):
            raise ValueError("MultiScaleExtractor: the lockstep (fused=True) "
                             "excludes fused_pde and fused_inference")
        self.fused = fused
        self.lockstep_hoisted = False
        self.branch_mesh = None
        self.branch_axis = "model"
        for i, scale in enumerate(self.SCALES, start=1):
            self.add_module(f"pde{i}", MixedChannelDiffusion(
                input_size, channels, splitting="strang",
                fused_inference=fused_inference, fused=fused_pde,
                device=device, **scale))
            self.add_module(f"attention{i}",
                            SpatialAttention(channels, input_size, device))
        self.combine_weights = nn.Parameter(
            torch.full((3,), 1.0 / 3.0, device=device))
        for name, t in lockstep_tables(**self._scales(), device=device
                                       ).items():
            self.register_buffer(f"lockstep_{name}", t, persistent=False)

    @classmethod
    def _scales(cls):
        """The branches' settings as the lockstep functions take them."""
        return {"dts": [s["dt"] for s in cls.SCALES],
                "steps_list": [s["num_steps"] for s in cls.SCALES],
                "dxs": [s["dx"] for s in cls.SCALES],
                "dys": [s["dy"] for s in cls.SCALES]}

    def _branches(self, x):
        """The three branches' evolutions of x, in the configured mode."""
        pdes = [getattr(self, f"pde{i}") for i in (1, 2, 3)]
        params = [dict(p.named_parameters()) for p in pdes]
        tables = {"ts": self.lockstep_ts, "active": self.lockstep_active,
                  "dtfac": self.lockstep_dtfac}
        if self.lockstep_hoisted or self.branch_mesh is not None:
            first = pdes[0]
            stacked = hoisted_lockstep_evolve(
                x, params, **self._scales(), eps=first.eps,
                clamp_max=first.clamp_max,
                operator_dtype=first.operator_dtype, tables=tables,
                branch_mesh=self.branch_mesh, branch_axis=self.branch_axis)
            return [stacked[:, i] for i in range(3)]
        if self.fused:
            impl = ("matinv_bf16" if pdes[0].operator_dtype == torch.bfloat16
                    else None)
            stacked = fused_multiscale_evolve(x, params, **self._scales(),
                                              tables=tables, impl=impl)
            return [stacked[i] for i in range(3)]
        return [pde(x) for pde in pdes]

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        for i in (1, 2, 3):
            getattr(self, f"pde{i}").reset_parameters(generator)
        for i in (1, 2, 3):
            getattr(self, f"attention{i}").reset_parameters(generator)
        self.combine_weights.fill_(1.0 / 3.0)

    def forward(self, x):
        feats = [getattr(self, f"attention{i}")(f)
                 for i, f in enumerate(self._branches(x), start=1)]
        w = torch.softmax(self.combine_weights, dim=0)
        return w[0] * feats[0] + w[1] * feats[1] + w[2] * feats[2]


class EnhancedFC(nn.Module):
    """[Linear, BatchNorm1d, ReLU, Dropout] × n + a final Linear, with
    kaiming-normal weights and zero biases on every Linear."""

    def __init__(self, input_size, hidden_sizes, num_classes,
                 dropout_rate=0.3, device=None):
        super().__init__()
        layers = []
        prev = input_size
        for h in hidden_sizes:
            layers += [nn.Linear(prev, h, device=device),
                       nn.BatchNorm1d(h, device=device), nn.ReLU(),
                       Dropout(dropout_rate)]
            prev = h
        layers.append(nn.Linear(prev, num_classes, device=device))
        self.network = nn.Sequential(*layers)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        for m in self.network:
            if isinstance(m, nn.Linear):
                std = math.sqrt(2.0) / math.sqrt(m.in_features)
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator) * std)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()

    def forward(self, x):
        return self.network(x)


class CIFAR10PDENoConv(nn.Module):
    """extractor → BatchNorm2d → avg ‖ max 4×4 pools → flatten 96 →
    EnhancedFC([512, 256, 128, 64] → 10)."""

    def __init__(self, dropout_rate=0.3, fused_inference=False,
                 fused_pde=False, fused_multiscale=False, device=None):
        super().__init__()
        self.feature_extractor = MultiScaleExtractor(
            32, 3, fused_inference=fused_inference, fused_pde=fused_pde,
            fused=fused_multiscale, device=device)
        self.feature_bn = nn.BatchNorm2d(3, device=device)
        self.classifier = EnhancedFC(96, [512, 256, 128, 64], 10,
                                     dropout_rate, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.feature_extractor.reset_parameters(generator)
        self.feature_bn.reset_parameters()
        self.classifier.reset_parameters(generator)

    def forward(self, x):
        f = self.feature_bn(self.feature_extractor(x))
        # on 32×32 both adaptive pools are exact 8×8 windows
        pooled = torch.cat([F.adaptive_avg_pool2d(f, 4),
                            F.adaptive_max_pool2d(f, 4)], dim=1)
        return self.classifier(pooled.reshape(pooled.shape[0], -1))
