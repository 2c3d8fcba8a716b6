"""Implicit directional diffusion sweeps — port of ``cnn_pde_tpu/ops/adi.py``.

One backward-Euler sweep along an axis solves, per line,
``(I - dt/dx²·diag(α)·Δ₁) u_new = u``: the tridiagonal system ``a = c = -r``,
``b = 1 + 2r`` with ``r = α·dt/dx²``, and Neumann (no-flux) boundary rows
``b[0] = 1 + r[0]``, ``b[-1] = 1 + r[-1]``; the reference's eps goes in as
``b + eps``.  The coefficient field is batch-free and is never broadcast to
the batch.  The y-sweep solves down the columns in place (K1 takes the solve
axis), where the JAX version transposes twice.

``smooth=True`` (the grayscale layer) first smooths the field with
``smooth3`` along the sweep axis: along W for an x-sweep, along H (down the
column) for a y-sweep, which is the axis the JAX y-sweep smooths after its
transpose.  The hoisted-operator sweeps belong to a later slice (ROADMAP.md
A6).
"""

from __future__ import annotations

import torch

from .smoothing import smooth3
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


def _sweep(u, coeff_field, dt, dh, eps, dim, smooth):
    if smooth:
        coeff_field = smooth3(coeff_field, dim)
    r = coeff_field * (dt / (dh * dh))
    return tridiag_solve(-r, _neumann_b(r, dim) + eps, -r, u, dim)


def sweep_last_axis(u, coeff_field, dt, dx, *, eps, smooth=False):
    """One implicit sweep along the trailing axis of u (..., N); the field
    has u's trailing shape and is shared by the leading (batch) axes."""
    return _sweep(u, coeff_field, dt, dx, eps, -1, smooth)


def sweep_x(u, alpha, dt, dx, *, eps, smooth=False):
    """Sweep along W of (..., H, W) with α of shape (..., H, W) sans batch."""
    return sweep_last_axis(u, alpha, dt, dx, eps=eps, smooth=smooth)


def sweep_y(u, beta, dt, dy, *, eps, smooth=False):
    """Sweep along H of (..., H, W), down the columns, with no transpose;
    with ``smooth`` the field is smoothed along H."""
    return _sweep(u, beta, dt, dy, eps, -2, smooth)
