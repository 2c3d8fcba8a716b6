"""Weights carried across from the JAX package — port of
``cnn_pde_tpu/compat/torch_import.py`` for the ported families.

The port's module names are the reference's ``state_dict`` names, so a
reference checkpoint loads as it is.  ``state_dict_from_jax`` turns the JAX
model's ``(params, state)`` (nested dicts of numpy arrays) into that
namespace: the preset's key rewrites, the leaf map (``w``/``scale`` →
``weight``, ``b`` → ``bias``, ``mean``/``var`` → ``running_*``), the Linear
transpose (JAX keeps (in, out), torch (out, in); convolution kernels are
OIHW on both sides) and zero ``num_batches_tracked`` counters beside each
BatchNorm.  The emotion layer's coordinate grids, which the JAX layer makes
from its hyperparameters and keeps out of its params, are added as the
reference's ``pde.x`` and ``pde.y`` buffers.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "load_torch_checkpoint"]

# per preset: JAX dotted param path → reference state_dict key
KEY_REWRITES = {
    # SVHN.py:234-298: five fc/bn pairs
    "svhn": [(r"^head\.1\.", "fc1."), (r"^head\.2\.", "bn1."),
             (r"^head\.5\.", "fc2."), (r"^head\.6\.", "bn2."),
             (r"^head\.9\.", "fc3."), (r"^head\.10\.", "bn3."),
             (r"^head\.13\.", "fc4."), (r"^head\.14\.", "bn4."),
             (r"^head\.17\.", "fc5.")],
    # cifar10.py:215-361: SpatialAttention.attention_fc, EnhancedFC.network
    "cifar10_noconv": [(r"\.fc\.", ".attention_fc."),
                       (r"^classifier\.", "classifier.network.")],
    # cifar_2version.py:190-368: symmetric_layer, attention_net, nested
    # PDEClassifier.classifier
    "cifar10_hybrid": [(r"\.sym\.", ".symmetric_layer."),
                       (r"^attention\.net\.", "attention.attention_net."),
                       (r"^classifier\.", "classifier.classifier.")],
    # mnist_test.py:223-261: diff + fc1/fc2 behind ReLU/Dropout
    "mnist": [(r"^head\.2\.", "fc1."), (r"^head\.5\.", "fc2.")],
    # fashion_mnist.py:200-254: fc1/bn1/fc2/bn2/fc3
    "fashion_mnist": [(r"^head\.1\.", "fc1."), (r"^head\.2\.", "bn1."),
                      (r"^head\.5\.", "fc2."), (r"^head\.6\.", "bn2."),
                      (r"^head\.9\.", "fc3.")],
    # emotion_recognition.py:16-140: PDELayer 'pde', head 'classifier'
    "emotion": [(r"^diff\.", "pde."), (r"^head\.", "classifier.")],
    # tiny_imagenet.py:237-331: a BasicBlock's downsample Sequential
    "tiny_imagenet": [(r"\.sc_conv\.", ".shortcut.0."),
                      (r"\.sc_bn\.", ".shortcut.1.")],
}


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _torch_key(path, *, is_state, preset="cifar10_noconv"):
    for pat, rep in KEY_REWRITES[preset]:
        new = re.sub(pat, rep, path)
        if new != path:
            path = new
            break
    head, _, leaf = path.rpartition(".")
    if is_state:
        leaf = {"mean": "running_mean", "var": "running_var"}[leaf]
    else:
        leaf = {"w": "weight", "b": "bias", "scale": "weight"}.get(leaf, leaf)
    return f"{head}.{leaf}" if head else leaf


def state_dict_from_jax(params, state, preset="cifar10_noconv"):
    """The JAX model's ``(params, state)`` for ``preset`` (one of
    ``KEY_REWRITES``) as a reference-layout state_dict of CPU tensors, ready
    for ``model.load_state_dict(sd, strict=True)``."""
    sd = {}
    for path, leaf in _flatten(params).items():
        v = np.asarray(leaf)
        if path.rsplit(".", 1)[-1] == "w" and v.ndim == 2:
            v = v.T
        sd[_torch_key(path, is_state=False, preset=preset)] = torch.tensor(v)
    for path, leaf in _flatten(state).items():
        key = _torch_key(path, is_state=True, preset=preset)
        sd[key] = torch.tensor(np.asarray(leaf))
        sd.setdefault(f"{key.rsplit('.', 1)[0]}.num_batches_tracked",
                      torch.zeros((), dtype=torch.int64))
    if preset == "emotion":
        # the grids of FourierFTCSLayer(Nx=Ny=n) on [0, 1]², n² the head's
        # input width
        n = math.isqrt(np.shape(params["head"]["1"]["w"])[0])
        sd["pde.x"] = torch.linspace(0.0, 1.0, n)
        sd["pde.y"] = torch.linspace(0.0, 1.0, n)
    return sd


def load_torch_checkpoint(path):
    """``torch.load`` a reference checkpoint (weights only): a bare
    state_dict, or one held under 'state_dict' or 'model'."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for k in ("state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(k), dict):
            return obj[k]
    return obj
