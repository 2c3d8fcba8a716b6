"""Loss and regulariser — port of ``cnn_pde_tpu/train/losses.py``
(``cross_entropy``, ``hybrid_pde_regularization``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["cross_entropy", "hybrid_pde_regularization"]


def cross_entropy(logits, labels, label_smoothing: float = 0.0):
    """Mean cross-entropy over the batch with torch-style label smoothing
    (ε/K spread over every class, the target included): the JAX
    function's definition, which ``F.cross_entropy`` computes."""
    return F.cross_entropy(logits, labels.long(),
                           label_smoothing=label_smoothing)


def hybrid_pde_regularization(model, alpha1=2e-4, alpha2=1e-4, alpha3=1e-6):
    """The hybrid's regulariser, selected by parameter name as the JAX one
    selects by path: α3·Σp² on every ``alpha_base``/``beta_base``,
    α2·‖p − I‖² on every ``channel_mixing``, α2·Σp² on every SymmetricLayer
    K (``….K.weight``) and α1·Σ|p| on ``combination_weights``.  The hybrid
    preset calls it with (2e-4, 1e-4, 1e-6).  The terms are summed by
    ``parallel.tensor_parallel.model_total``: a block of a tensor sharded
    by tensor parallelism has its term summed over the model axis, the
    unsharded model's regulariser on every rank."""
    from ..parallel.tensor_parallel import model_total

    terms = []
    for name, p in model.named_parameters():
        if "alpha_base" in name or "beta_base" in name:
            terms.append((name, alpha3 * torch.sum(p ** 2)))
        elif "channel_mixing" in name:
            eye = torch.eye(p.shape[0], dtype=p.dtype, device=p.device)
            terms.append((name, alpha2 * torch.sum((p - eye) ** 2)))
        elif ".K." in name or name.endswith("K.weight"):
            terms.append((name, alpha2 * torch.sum(p ** 2)))
        elif "combination_weights" in name:
            terms.append((name, alpha1 * torch.sum(torch.abs(p))))
    return model_total(model, terms)
