"""The CIFAR-10 hybrid PDE model — port of
``cnn_pde_tpu/models/cifar10_hybrid.py`` (M8-M11).

``HybridPDEExtractor`` runs four feature maps of the input and combines
them by softmax weights: two Lie-splitting ``MixedChannelDiffusion``
layers (8 steps at dt 0.001 and 5 at dt 0.002: 16 + 10 sweeps, one K1
launch each per-sweep, one K3 each in the backward), a ``ParabolicBlock``
(4 steps at dt 0.5) and a ``HamiltonianBlock`` (3 steps at dt 0.8), then a
BatchNorm2d.  The model gates it with ``NonConvSpatialAttention``,
normalises it, pools it to avg ‖ max 8 × 8 (384 features) and classifies
it with a five-Linear head.

``ruthotto_dtype`` is the grade of the two blocks' K products: bf16 by
default (the model the reference trains under autocast), float32 for the
exact grade.  Attribute names follow the reference's ``state_dict``
(``symmetric_layer``, ``attention.attention_net``,
``classifier.classifier``), so a reference checkpoint loads with
``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..pde import HamiltonianBlock, MixedChannelDiffusion, ParabolicBlock
from .attention import NonConvSpatialAttention
from .cifar10_noconv import Dropout

__all__ = ["HybridPDEExtractor", "HybridClassifierHead",
           "CIFAR10HybridPDEModel"]


class HybridPDEExtractor(nn.Module):
    """Two Lie diffusion layers, the parabolic and the Hamiltonian block,
    a softmax over four ``combination_weights``, and ``feature_norm``."""

    def __init__(self, input_size=32, channels=3,
                 ruthotto_dtype=torch.bfloat16, device=None):
        super().__init__()
        self.diffusion1 = MixedChannelDiffusion(
            input_size, channels, dt=0.001, num_steps=8, splitting="lie",
            device=device)
        self.diffusion2 = MixedChannelDiffusion(
            input_size, channels, dt=0.002, num_steps=5, splitting="lie",
            device=device)
        self.parabolic = ParabolicBlock(channels, input_size, num_steps=4,
                                        dt=0.5, compute_dtype=ruthotto_dtype,
                                        device=device)
        self.hamiltonian = HamiltonianBlock(
            channels, input_size, num_steps=3, dt=0.8,
            compute_dtype=ruthotto_dtype, device=device)
        self.feature_norm = nn.BatchNorm2d(channels, device=device)
        self.combination_weights = nn.Parameter(
            torch.full((4,), 0.25, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        for name in ("diffusion1", "diffusion2", "parabolic", "hamiltonian"):
            getattr(self, name).reset_parameters(generator)
        self.feature_norm.reset_parameters()
        self.combination_weights.fill_(0.25)

    def forward(self, x):
        feats = [self.diffusion1(x), self.diffusion2(x), self.parabolic(x),
                 self.hamiltonian(x)]
        w = torch.softmax(self.combination_weights, dim=0)
        combined = (w[0] * feats[0] + w[1] * feats[1] + w[2] * feats[2]
                    + w[3] * feats[3])
        return self.feature_norm(combined)


class HybridClassifierHead(nn.Module):
    """input_dim → 1024 → 512 → 256 → 128 → classes, each hidden Linear
    followed by BatchNorm1d, ReLU and dropout; the fourth dropout is the
    reference's ``dropout_rate // 2``, which floor-divides 0.4 to 0.0.
    kaiming-normal weights, zero biases."""

    def __init__(self, input_dim, num_classes=10, dropout_rate=0.4,
                 device=None):
        super().__init__()
        layers, prev = [], input_dim
        for width, rate in ((1024, dropout_rate), (512, dropout_rate),
                            (256, dropout_rate), (128, dropout_rate // 2)):
            layers += [nn.Linear(prev, width, device=device),
                       nn.BatchNorm1d(width, device=device), nn.ReLU(),
                       Dropout(rate)]
            prev = width
        layers.append(nn.Linear(prev, num_classes, device=device))
        self.classifier = nn.Sequential(*layers)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        for m in self.classifier:
            if isinstance(m, nn.Linear):
                std = math.sqrt(2.0) / math.sqrt(m.in_features)
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator) * std)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()

    def forward(self, x):
        return self.classifier(x)


class CIFAR10HybridPDEModel(nn.Module):
    """extractor → attention → BatchNorm2d → avg ‖ max 8 × 8 pools →
    flatten 384 → head → 10 logits."""

    def __init__(self, dropout_rate=0.4, ruthotto_dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.feature_extractor = HybridPDEExtractor(
            32, 3, ruthotto_dtype=ruthotto_dtype, device=device)
        self.attention = NonConvSpatialAttention(3, 32, device=device)
        self.feature_bn = nn.BatchNorm2d(3, device=device)
        # on 32 × 32 both adaptive pools are exact 4 × 4 windows
        self.avg_pool = nn.AdaptiveAvgPool2d(8)
        self.max_pool = nn.AdaptiveMaxPool2d(8)
        self.classifier = HybridClassifierHead(384, 10, dropout_rate,
                                               device=device)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.feature_extractor.reset_parameters(generator)
        self.attention.reset_parameters(generator)
        self.feature_bn.reset_parameters()
        self.classifier.reset_parameters(generator)

    def forward(self, x):
        f = self.feature_bn(self.attention(self.feature_extractor(x)))
        pooled = torch.cat([self.avg_pool(f), self.max_pool(f)], dim=1)
        return self.classifier(pooled.reshape(pooled.shape[0], -1))
