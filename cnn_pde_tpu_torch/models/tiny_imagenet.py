"""The Tiny-ImageNet classifier — port of
``cnn_pde_tpu/models/tiny_imagenet.py::{BasicBlock, TinyImageNetClassifier}``:
an optional ResidualDiffusion front end, then a ResNet-18 backbone
(conv 7×7/2, BN, ReLU, max-pool 3/2, four stages of two BasicBlocks of 64,
128, 256 and 512 planes, global average pool, dropout(0.3), fc 200).

Attribute names follow the reference's ``state_dict`` namespace (``diff``,
``conv1``, ``bn1``, ``layer1``-``layer4``, a block's downsample as
``shortcut.0`` / ``shortcut.1``, ``fc``), so a reference checkpoint loads
with ``load_state_dict(strict=True)``.  The convolutions are the port's
``Conv2d`` (exact, never TF32; bf16 under ``pde.enable_amp``); BatchNorm2d
and the pools are torch's.  Init, from an explicit generator: the
convolutions N(0, 2/fan_out), BN weight 1 and bias 0, ``fc`` weight
N(0, 0.01²) and bias 0.
"""

from __future__ import annotations

import torch
from torch import nn

from ..layers import Conv2d
from ..pde import ResidualDiffusion
from .cifar10_noconv import Dropout

__all__ = ["BasicBlock", "TinyImageNetClassifier"]


def _conv(in_planes, planes, k, stride, padding, device):
    return Conv2d(in_planes, planes, k, stride=stride, padding=padding,
                  device=device)


class BasicBlock(nn.Module):
    """conv3×3(stride) BN ReLU conv3×3 BN, plus the identity or a
    conv1×1(stride) BN shortcut, then ReLU."""

    def __init__(self, in_planes, planes, stride=1, device=None):
        super().__init__()
        self.conv1 = _conv(in_planes, planes, 3, stride, 1, device)
        self.bn1 = nn.BatchNorm2d(planes, device=device)
        self.conv2 = _conv(planes, planes, 3, 1, 1, device)
        self.bn2 = nn.BatchNorm2d(planes, device=device)
        self.relu1 = nn.ReLU()
        self.relu2 = nn.ReLU()
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != planes:
            self.shortcut = nn.Sequential(
                _conv(in_planes, planes, 1, stride, 0, device),
                nn.BatchNorm2d(planes, device=device))

    def forward(self, x):
        out = self.relu1(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu2(out + self.shortcut(x))


class TinyImageNetClassifier(nn.Module):
    """[diff] → conv1 bn1 ReLU maxpool → layer1-layer4 → avgpool →
    dropout → fc."""

    def __init__(self, num_classes=200, use_pde=True, dropout_rate=0.3,
                 pde_implicit=False, device=None):
        super().__init__()
        self.use_pde = use_pde
        if use_pde:
            self.diff = ResidualDiffusion(size=64, channels=3, num_steps=1,
                                          use_implicit=pde_implicit,
                                          device=device)
        self.conv1 = _conv(3, 64, 7, 2, 3, device)
        self.bn1 = nn.BatchNorm2d(64, device=device)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_planes = 64
        for i, (planes, stride) in enumerate(
                ((64, 1), (128, 2), (256, 2), (512, 2)), start=1):
            self.add_module(f"layer{i}", nn.Sequential(
                BasicBlock(in_planes, planes, stride, device=device),
                BasicBlock(planes, planes, 1, device=device)))
            in_planes = planes
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.dropout = Dropout(dropout_rate)
        self.fc = nn.Linear(512, num_classes, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        for m in self.modules():
            if isinstance(m, (Conv2d, ResidualDiffusion)):
                m.reset_parameters(generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        self.fc.weight.copy_(torch.randn(self.fc.weight.shape,
                                         generator=generator) * 0.01)
        self.fc.bias.zero_()

    def forward(self, x):
        if self.use_pde:
            x = self.diff(x)
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.avgpool(x).flatten(1)
        return self.fc(self.dropout(x))
