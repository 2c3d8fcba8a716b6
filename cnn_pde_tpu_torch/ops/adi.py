"""Implicit directional diffusion sweeps — port of ``cnn_pde_tpu/ops/adi.py``.

One backward-Euler sweep along an axis solves, per line,
``(I - dt/dx²·diag(α)·Δ₁) u_new = u``: the tridiagonal system ``a = c = -r``,
``b = 1 + 2r`` with ``r = α·dt/dx²``, and Neumann (no-flux) boundary rows
``b[0] = 1 + r[0]``, ``b[-1] = 1 + r[-1]``; the reference's eps goes in as
``b + eps``.  The coefficient field is batch-free and is never broadcast to
the batch.  The y-sweep solves down the columns in place (K1 takes the solve
axis), where the JAX version transposes twice.

Smoothing of the coefficients (the grayscale and SVHN layers) and the
hoisted-operator sweeps belong to later slices (ROADMAP.md A6, A7).
"""

from __future__ import annotations

import torch

from .tridiag import tridiag_solve

__all__ = ["sweep_last_axis", "sweep_x", "sweep_y"]


def _neumann_b(r, dim=-1):
    """b = 1+2r with the Neumann rows b[0] = 1+r[0], b[-1] = 1+r[-1] along
    ``dim``; a width-1 axis has both boundary rows in one: b = 1+r."""
    if r.shape[dim] == 1:
        return 1.0 + r
    r = r.movedim(dim, -1)
    b = torch.cat([1.0 + r[..., :1], 1.0 + 2.0 * r[..., 1:-1],
                   1.0 + r[..., -1:]], dim=-1)
    return b.movedim(-1, dim).contiguous()


def _sweep(u, coeff_field, dt, dh, eps, dim):
    r = coeff_field * (dt / (dh * dh))
    return tridiag_solve(-r, _neumann_b(r, dim) + eps, -r, u, dim)


def sweep_last_axis(u, coeff_field, dt, dx, *, eps):
    """One implicit sweep along the trailing axis of u (..., N); the field
    has u's trailing shape and is shared by the leading (batch) axes."""
    return _sweep(u, coeff_field, dt, dx, eps, -1)


def sweep_x(u, alpha, dt, dx, *, eps):
    """Sweep along W of (..., H, W) with α of shape (..., H, W) sans batch."""
    return sweep_last_axis(u, alpha, dt, dx, eps=eps)


def sweep_y(u, beta, dt, dy, *, eps):
    """Sweep along H of (..., H, W), down the columns, with no transpose."""
    return _sweep(u, beta, dt, dy, eps, -2)
