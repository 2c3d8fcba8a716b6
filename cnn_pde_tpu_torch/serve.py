"""Inference path — port of ``cnn_pde_tpu/serve.py::make_predict_fn``.

``make_predict_fn(model)`` returns a callable from a batch of NCHW float32
images (numpy or tensor) to logits, probabilities or labels, computed in
eval mode under ``torch.inference_mode()`` on the model's device.  Data
parallelism, weight binding, operator caches, linearized serving and export
are later slices (ROADMAP.md A13).

    python -m cnn_pde_tpu_torch.serve --preset cifar10_noconv [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["make_predict_fn"]

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


if __name__ == "__main__":
    from .serve_cli import main

    main()
