"""Inference path — port of ``cnn_pde_tpu/serve.py::make_predict_fn``.

``make_predict_fn(model)`` returns a callable from a batch of NCHW float32
images (numpy or tensor) to logits, probabilities or labels, computed in
eval mode under ``torch.inference_mode()`` on the model's device.
``cache_hoisted_operators(model)`` pins the sweep operators of every
hoisted ADI layer for serving with frozen weights (the AMP grade's serving
path, ``--amp``); ``clear_operator_cache`` unpins them.  Data parallelism,
weight binding, linearized serving and export are later slices
(ROADMAP.md A13).

    python -m cnn_pde_tpu_torch.serve --preset cifar10_noconv [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["make_predict_fn", "cache_hoisted_operators",
           "clear_operator_cache"]

OUTPUTS = ("logits", "probs", "labels")


def make_predict_fn(model, output="logits", buckets=None):
    """output: 'logits' | 'probs' | 'labels'.

    ``buckets``: optional batch sizes to pad requests up to (the last row
    repeated; padded rows are sliced off), so the model sees a handful of
    shapes; a request above the largest bucket runs unpadded."""
    if output not in OUTPUTS:
        raise ValueError(f"output must be one of {OUTPUTS}, got {output!r}")
    model.eval()
    device = next(model.parameters()).device
    sizes = sorted(int(b) for b in buckets) if buckets else []

    @torch.inference_mode()
    def predict(images):
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        x = images.to(device=device, dtype=torch.float32).contiguous()
        n = x.shape[0]
        target = next((b for b in sizes if b >= n), n)
        if target != n:
            x = torch.cat([x, x[-1:].expand(target - n, *x.shape[1:])])
        logits = model(x)[:n]
        if output == "probs":
            return torch.softmax(logits, dim=-1)
        if output == "labels":
            return logits.argmax(dim=-1)
        return logits

    return predict


def cache_hoisted_operators(model):
    """Build and pin the sweep operators of every ADI layer of ``model``
    whose eval forward takes the hoisted branch, for serving with frozen
    weights: the operators are batch-free and the weights do not change,
    so a request then runs only the GEMMs (two K1 launches a layer here,
    none a request).  Training with a cache pinned raises, and a cache
    built before the weights change is stale: ``clear_operator_cache``
    undoes it.  Returns the number of layers cached."""
    from .pde.amp import iter_adi_layers
    from .pde.diffusion import runs_hoisted

    n = 0
    with torch.no_grad():
        for layer in iter_adi_layers(model):
            if runs_hoisted(layer):
                layer.operator_cache = layer.hoisted_operators()
                n += 1
    return n


def clear_operator_cache(model):
    """Unpin the operators ``cache_hoisted_operators`` pinned (e.g. to
    resume training).  Returns the number of layers cleared."""
    from .pde.amp import iter_adi_layers

    n = 0
    for layer in iter_adi_layers(model):
        if getattr(layer, "operator_cache", None) is not None:
            layer.operator_cache = None
            n += 1
    return n


if __name__ == "__main__":
    from .serve_cli import main

    main()
