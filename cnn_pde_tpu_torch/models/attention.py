"""Attention gates — port of ``cnn_pde_tpu/models/attention.py``:
``SpatialAttention`` (M4, the flagship's) and ``NonConvSpatialAttention``
(M9, the hybrid's)."""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["SpatialAttention", "NonConvSpatialAttention",
           "torch_default_init_"]


@torch.no_grad()
def torch_default_init_(linear: nn.Linear, generator=None):
    """torch's own Linear init, drawn from ``generator``: weight and bias
    both U(-1/√fan_in, 1/√fan_in) (kaiming_uniform with a = √5)."""
    bound = 1.0 / math.sqrt(linear.in_features)
    linear.weight.copy_(torch.empty(linear.weight.shape).uniform_(
        -bound, bound, generator=generator))
    linear.bias.copy_(torch.empty(linear.bias.shape).uniform_(
        -bound, bound, generator=generator))


class SpatialAttention(nn.Module):
    """Learnable position embedding plus a global-average-pooled channel MLP
    (C → 2C → C) with a sigmoid gate on the input."""

    def __init__(self, channels, size, device=None):
        super().__init__()
        self.pos_embed = nn.Parameter(
            torch.zeros((1, channels, size, size), device=device))
        self.attention_fc = nn.Sequential(
            nn.Linear(channels, channels * 2, device=device), nn.ReLU(),
            nn.Linear(channels * 2, channels, device=device), nn.Sigmoid())

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.pos_embed.copy_(
            torch.randn(self.pos_embed.shape, generator=generator) * 0.1)
        torch_default_init_(self.attention_fc[0], generator)
        torch_default_init_(self.attention_fc[2], generator)

    def forward(self, x):
        pooled = (x + self.pos_embed).mean(dim=(2, 3))
        return x * self.attention_fc(pooled)[:, :, None, None]


class NonConvSpatialAttention(nn.Module):
    """A sigmoid gate over the whole flattened feature map: (x + pos_embed)
    flattened to D = C·H·W → D/4 → D/8 → D (ReLU between, sigmoid last),
    multiplied into x; ``pos_embed`` drawn at 0.02·N(0, 1)."""

    def __init__(self, channels, spatial_size, device=None):
        super().__init__()
        d = channels * spatial_size * spatial_size
        self.pos_embed = nn.Parameter(torch.zeros(
            (1, channels, spatial_size, spatial_size), device=device))
        self.attention_net = nn.Sequential(
            nn.Linear(d, d // 4, device=device), nn.ReLU(),
            nn.Linear(d // 4, d // 8, device=device), nn.ReLU(),
            nn.Linear(d // 8, d, device=device), nn.Sigmoid())

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.pos_embed.copy_(
            torch.randn(self.pos_embed.shape, generator=generator) * 0.02)
        for i in (0, 2, 4):
            torch_default_init_(self.attention_net[i], generator)

    def forward(self, x):
        flat = (x + self.pos_embed).reshape(x.shape[0], -1)
        return x * self.attention_net(flat).reshape(x.shape)
