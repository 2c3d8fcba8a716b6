"""The PDE→MLP classifiers — port of
``cnn_pde_tpu/models/mlp_models.py::{MNISTClassifier, FashionClassifier,
SVHNClassifier, EmotionClassifier}``.

Attribute names follow the reference's ``state_dict`` namespace (``diff.*``,
``fc1``/``fc2`` for MNIST; ``fc1``/``bn1``/``fc2``/``bn2``/``fc3`` for
Fashion-MNIST; ``fc1``-``fc5`` and ``bn1``-``bn4`` for SVHN; ``pde.*`` and
the ``classifier`` Sequential for emotion), so a reference checkpoint
loads with ``load_state_dict(strict=True)``.  ``fused_inference``
and ``fused`` are the GrayscaleDiffusion layer's own flags (one K6 launch in
eval; one K7 and one K8 launch in training); SVHN's ChannelCoupledDiffusion
has no fused configuration (K1 and K3 a sweep, or hoisted).  Linears take
torch's default init (U(±1/√fan_in) for weight and bias) from an explicit
generator, as the JAX layers draw it.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..pde import (ChannelCoupledDiffusion, FourierFTCSLayer,
                   GrayscaleDiffusion)
from .cifar10_noconv import Dropout

__all__ = ["MNISTClassifier", "FashionClassifier", "SVHNClassifier",
           "EmotionClassifier"]


def _reset_head(module, generator):
    for m in module.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            for p in (m.weight, m.bias):
                p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound
                        - bound)
        elif isinstance(m, nn.BatchNorm1d):
            m.reset_parameters()


class MNISTClassifier(nn.Module):
    """diff (10 Strang steps at dt 1e-3, init 2.0) → flatten 784 →
    dropout(0.1) → fc1 256 → ReLU → dropout → fc2 10."""

    def __init__(self, dropout_rate=0.1, dx=1.0, dy=1.0,
                 fused_inference=False, fused=False, device=None):
        super().__init__()
        self.diff = GrayscaleDiffusion(
            28, dt=0.001, dx=dx, dy=dy, num_steps=10, init_value=2.0,
            fused_inference=fused_inference, fused=fused, device=device)
        self.dropout = Dropout(dropout_rate)
        self.fc1 = nn.Linear(28 * 28, 256, device=device)
        self.relu = nn.ReLU()
        self.fc2 = nn.Linear(256, 10, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.diff.reset_parameters(generator)
        _reset_head(self, generator)

    def forward(self, x):
        x = self.diff(x)
        x = self.dropout(x.reshape(x.shape[0], -1))
        x = self.dropout(self.relu(self.fc1(x)))
        return self.fc2(x)


class FashionClassifier(nn.Module):
    """diff (4 Strang steps at dt 0.3, init 1.8; the y-sweep reuses dx) →
    784 → [fc1 512, bn1, ReLU, dropout(0.15)] → [fc2 256, bn2, ReLU,
    dropout] → fc3 10."""

    def __init__(self, dropout_rate=0.15, fused_inference=False, fused=False,
                 device=None):
        super().__init__()
        self.diff = GrayscaleDiffusion(
            28, dt=0.3, dx=1.0, dy=1.0, num_steps=4, init_value=1.8,
            fused_inference=fused_inference, fused=fused, device=device)
        self.fc1 = nn.Linear(28 * 28, 512, device=device)
        self.bn1 = nn.BatchNorm1d(512, device=device)
        self.fc2 = nn.Linear(512, 256, device=device)
        self.bn2 = nn.BatchNorm1d(256, device=device)
        self.fc3 = nn.Linear(256, 10, device=device)
        self.relu1 = nn.ReLU()
        self.relu2 = nn.ReLU()
        self.dropout = Dropout(dropout_rate)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.diff.reset_parameters(generator)
        _reset_head(self, generator)

    def forward(self, x):
        x = self.diff(x)
        x = x.reshape(x.shape[0], -1)
        x = self.dropout(self.relu1(self.bn1(self.fc1(x))))
        x = self.dropout(self.relu2(self.bn2(self.fc2(x))))
        return self.fc3(x)


class SVHNClassifier(nn.Module):
    """diff (ChannelCoupledDiffusion: 3 channels, 32 × 32, 10 Strang steps
    at dt 0.01) → flatten 3072 → [fc 2048, 1024, 512, 256, each with BN,
    ReLU, dropout(0.5)] → fc5 10."""

    WIDTHS = (2048, 1024, 512, 256)

    def __init__(self, dropout_rate=0.5, device=None):
        super().__init__()
        self.diff = ChannelCoupledDiffusion(32, 3, dt=0.01, num_steps=10,
                                            device=device)
        prev = 32 * 32 * 3
        for i, width in enumerate(self.WIDTHS, start=1):
            self.add_module(f"fc{i}", nn.Linear(prev, width, device=device))
            self.add_module(f"bn{i}", nn.BatchNorm1d(width, device=device))
            self.add_module(f"relu{i}", nn.ReLU())
            prev = width
        self.fc5 = nn.Linear(prev, 10, device=device)
        self.dropout = Dropout(dropout_rate)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.diff.reset_parameters(generator)
        _reset_head(self, generator)

    def forward(self, x):
        x = self.diff(x)
        x = x.reshape(x.shape[0], -1)
        for i in range(1, len(self.WIDTHS) + 1):
            x = getattr(self, f"fc{i}")(x)
            x = getattr(self, f"bn{i}")(x)
            x = self.dropout(getattr(self, f"relu{i}")(x))
        return self.fc5(x)


class EmotionClassifier(nn.Module):
    """pde (FourierFTCSLayer: 10 FTCS steps on img_size²) → flatten →
    [512, 256, 128, each Linear, BN, ReLU, dropout(0.3)] → num_classes.
    ``classifier`` is one Sequential, its indices the reference's (the
    Linears at 1, 5, 9, 13; the BNs at 2, 6, 10)."""

    WIDTHS = (512, 256, 128)

    def __init__(self, img_size=48, num_classes=7, dropout_rate=0.3,
                 device=None):
        super().__init__()
        self.pde = FourierFTCSLayer(Nx=img_size, Ny=img_size, device=device)
        layers = [nn.Flatten()]
        prev = img_size * img_size
        for width in self.WIDTHS:
            layers += [nn.Linear(prev, width, device=device),
                       nn.BatchNorm1d(width, device=device), nn.ReLU(),
                       Dropout(dropout_rate)]
            prev = width
        layers.append(nn.Linear(prev, num_classes, device=device))
        self.classifier = nn.Sequential(*layers)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.pde.reset_parameters(generator)
        _reset_head(self.classifier, generator)

    def forward(self, x):
        return self.classifier(self.pde(x))
