"""Model registry of the port: the CIFAR-10 no-conv flagship, the CIFAR-10
hybrid, the grayscale family (MNIST, Fashion-MNIST), SVHN, emotion and
Tiny-ImageNet: every model family of the JAX package."""

from __future__ import annotations

import torch

from .attention import NonConvSpatialAttention, SpatialAttention
from .cifar10_hybrid import (CIFAR10HybridPDEModel, HybridClassifierHead,
                             HybridPDEExtractor)
from .cifar10_noconv import (CIFAR10PDENoConv, EnhancedFC,
                             MultiScaleExtractor, set_dropout_generator)
from .mlp_models import (EmotionClassifier, FashionClassifier,
                         MNISTClassifier, SVHNClassifier)
from .tiny_imagenet import BasicBlock, TinyImageNetClassifier

__all__ = ["MODEL_REGISTRY", "build_model", "SpatialAttention",
           "NonConvSpatialAttention", "CIFAR10HybridPDEModel",
           "HybridClassifierHead", "HybridPDEExtractor", "CIFAR10PDENoConv",
           "EnhancedFC", "MultiScaleExtractor",
           "MNISTClassifier", "FashionClassifier", "SVHNClassifier",
           "EmotionClassifier", "BasicBlock", "TinyImageNetClassifier",
           "set_dropout_generator"]

MODEL_REGISTRY = {"cifar10_noconv": CIFAR10PDENoConv,
                  "cifar10_hybrid": CIFAR10HybridPDEModel,
                  "mnist": MNISTClassifier,
                  "fashion_mnist": FashionClassifier,
                  "svhn": SVHNClassifier,
                  "emotion": EmotionClassifier,
                  "tiny_imagenet": TinyImageNetClassifier}

# JAX model families still to port, with their ROADMAP.md queue-A items
NOT_YET_PORTED: dict = {}


def build_model(name, *, device="cuda", generator=None, **kwargs):
    """Model ``name`` with the JAX model's init distributions drawn from
    ``generator`` (a CPU ``torch.Generator``; None uses torch's global one),
    moved to ``device`` and put in eval mode.  It runs on the card unless
    the caller passes ``device="cpu"``; without CUDA it raises rather than
    carry on on the CPU."""
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not yet ported: ROADMAP.md "
            f"{NOT_YET_PORTED[name]}")
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    model = MODEL_REGISTRY[name](**kwargs)
    model.reset_parameters(generator)
    return model.to(device).eval()
