"""Post-training analysis — port of ``cnn_pde_tpu/utils/analysis.py``.

The reference's printed diagnostics as returned data structures: the CFL
stability report, the coefficients' evolution over the horizon, the
anisotropy α/dx² against β/dy², the channel-coupling norm and the
evaluation summary (numpy on host arrays, as in JAX); and the exact
spectrum of each PDE layer's trained evolution, whose matrix is built by
the port's linearize (``pde/linearize.py``) from one eval forward on the
model's own device: on the card the identity basis runs through the
layer's kernels (K1 a sweep per-sweep, K2 for the flagship's fused
branches, K6 for the fused grayscale layer).
"""

from __future__ import annotations

import numpy as np
import torch

from ..train.metrics import (classification_report, confusion_matrix,
                             per_class_accuracy)

__all__ = [
    "cfl_report",
    "coefficient_time_evolution",
    "anisotropy_analysis",
    "evaluation_summary",
    "coupling_strength",
    "evolution_matrices",
    "evolution_spectrum",
    "model_evolution_spectra",
    "operator_spectrum",
]


def evolution_matrices(module, input_shape, max_dim=4096):
    """The composed evolution matrix of every linearizable PDE layer that
    one eval forward of a zero image of ``input_shape`` (C, H, W) through
    ``module`` reaches, on its own device (the basis built by the layers'
    kernels there): [(layer class name, (D, D) float32 matrix)] in call
    order, the layers with D > ``max_dim`` skipped.  The mode of
    ``module`` is restored."""
    from ..pde.linearize import capture_linearized

    device = next(module.parameters()).device
    was_training = module.training
    module.eval()
    try:
        with capture_linearized(max_dim=max_dim) as cap, torch.no_grad():
            module(torch.zeros((1,) + tuple(input_shape), device=device))
    finally:
        module.train(was_training)
    return [(type(layer).__name__, mat) for layer, mat in cap.items]


def evolution_spectrum(layer, input_shape, max_dim=4096, top_k=8):
    """The exact stability analysis of a PDE layer's trained evolution.
    Every PDE front-end layer is linear in u, so its whole multi-step
    evolution is a (D, D) matrix whose spectrum decides stability: spectral
    radius ≤ 1 is a non-amplifying operator, σ_max bounds one pass's
    amplification, and the eigenvalue near 1 is the Neumann boundary's
    conserved mode.

    ``input_shape``: (C, H, W) of the layer's input.  Returns
    ``operator_spectrum`` of its matrix; a layer with D > ``max_dim`` is
    refused."""
    D = int(np.prod(input_shape))
    if D > max_dim:
        raise ValueError(f"evolution dimension {D} exceeds max_dim={max_dim}")
    mats = evolution_matrices(layer, input_shape, max_dim)
    if not mats:
        raise ValueError("layer did not linearize (is it a PDE layer?)")
    return operator_spectrum(mats[0][1], top_k=top_k)


def operator_spectrum(mat, top_k=8):
    """Spectral report of one composed evolution matrix (the linearize
    convention: out_flat = u_flat @ M, so the operator on column-vector
    states is Mᵀ: the same spectrum, the symmetry transposed)."""
    if isinstance(mat, torch.Tensor):
        mat = mat.detach().cpu().numpy()
    m = np.asarray(mat, np.float64).T
    eig = np.linalg.eigvals(m)
    order = np.argsort(-np.abs(eig))
    sv = np.linalg.svd(m, compute_uv=False)
    sym = 0.5 * (m + m.T)
    return {
        "dim": int(m.shape[0]),
        "spectral_radius": float(np.abs(eig).max()),
        # (re, im) pairs: JSON-serializable
        "top_eigenvalues": [[float(e.real), float(e.imag)]
                            for e in eig[order[:top_k]]],
        "sigma_max": float(sv[0]),
        "sigma_min": float(sv[-1]),
        "non_normality": float(np.linalg.norm(m - sym) / np.linalg.norm(m)),
        "stable": bool(np.abs(eig).max() <= 1.0 + 1e-6),
    }


def model_evolution_spectra(model, input_shape, max_dim=4096, top_k=8):
    """``evolution_spectrum`` of every linearizable PDE layer that a full
    eval forward of ``model`` reaches (the flagship's three branches, the
    SVHN coupled layer, the hybrid's two diffusion branches, ...), as a
    list of (layer class name, spectrum) in call order; layers with D >
    ``max_dim`` are skipped (Tiny-ImageNet's 12,288).  The matrices are
    ``evolution_matrices``' (on the model's device); the spectra are
    numpy's on the host."""
    return [(name, operator_spectrum(m, top_k=top_k))
            for name, m in evolution_matrices(model, input_shape, max_dim)]


def cfl_report(alpha_base, alpha_time, beta_base, beta_time, *, dt, dx, dy,
               num_steps):
    """CFL-like stability check: stable iff max(coeff)·dt/dh² < 0.5."""
    horizon = dt * num_steps
    alpha_max = float(np.max(np.asarray(alpha_base)
                             + np.abs(np.asarray(alpha_time)) * horizon))
    beta_max = float(np.max(np.asarray(beta_base)
                            + np.abs(np.asarray(beta_time)) * horizon))
    cfl_x = alpha_max * dt / dx**2
    cfl_y = beta_max * dt / dy**2
    return {"cfl_x": cfl_x, "cfl_y": cfl_y,
            "stable_x": cfl_x < 0.5, "stable_y": cfl_y < 0.5,
            "dt": dt, "dx": dx, "dy": dy}


def coefficient_time_evolution(alpha_base, alpha_time, beta_base, beta_time,
                               *, dt, num_steps, points=5, eps=1e-6):
    """Coefficient statistics at ``points`` times across the horizon."""
    rows = []
    for t in np.linspace(0.0, num_steps * dt, points):
        a = np.maximum(np.asarray(alpha_base) + np.asarray(alpha_time) * t, eps)
        b = np.maximum(np.asarray(beta_base) + np.asarray(beta_time) * t, eps)
        rows.append({"t": float(t),
                     "alpha_mean": float(a.mean()), "alpha_std": float(a.std()),
                     "beta_mean": float(b.mean()), "beta_std": float(b.std())})
    return rows


def anisotropy_analysis(alpha_final, beta_final, *, dx, dy):
    """Effective diffusion rates and the anisotropy ratio."""
    ex = np.asarray(alpha_final) / dx**2
    ey = np.asarray(beta_final) / dy**2
    return {
        "effective_x_mean": float(ex.mean()), "effective_x_std": float(ex.std()),
        "effective_y_mean": float(ey.mean()), "effective_y_std": float(ey.std()),
        "anisotropy_ratio": float(ex.mean() / ey.mean()),
    }


def coupling_strength(channel_matrix):
    """Frobenius norm of the channel coupling (mixing) matrix."""
    return float(np.linalg.norm(np.asarray(channel_matrix)))


def evaluation_summary(labels, predictions, num_classes, class_names=None):
    """Accuracy, per-class accuracy, the confusion matrix and the full
    report (``train/metrics.py``)."""
    labels = np.asarray(labels)
    predictions = np.asarray(predictions)
    return {
        "accuracy": float((labels == predictions).mean()) * 100.0,
        "per_class_accuracy": per_class_accuracy(labels, predictions,
                                                 num_classes).tolist(),
        "confusion_matrix": confusion_matrix(labels, predictions,
                                             num_classes).tolist(),
        "report": classification_report(labels, predictions, num_classes,
                                        class_names),
    }
