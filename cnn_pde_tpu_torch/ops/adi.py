"""Implicit directional diffusion sweeps — port of ``cnn_pde_tpu/ops/adi.py``.

One backward-Euler sweep along an axis solves, per line,
``(I - dt/dx²·diag(α)·Δ₁) u_new = u``: the tridiagonal system ``a = c = -r``,
``b = 1 + 2r`` with ``r = α·dt/dx²``, and Neumann (no-flux) boundary rows
``b[0] = 1 + r[0]``, ``b[-1] = 1 + r[-1]``; the reference's eps goes in as
``b + eps``.  The coefficient field is batch-free and is never broadcast to
the batch.  The y-sweep solves down the columns in place (K1 takes the solve
axis), where the JAX version transposes twice.

``smooth=True`` (the grayscale and SVHN layers) first smooths the field
with ``smooth3`` along the sweep axis: along W for an x-sweep, along H (down
the column) for a y-sweep, which is the axis the JAX y-sweep smooths after
its transpose.

The hoisted formulation (the AMP grade): ``sweep_operator`` builds a
sweep's bands and its inverse operator X for a stack of coefficient fields
(..., N) at once (leading axes: steps, substeps, channels; one K1 launch
for the whole stack on the card), from detached bands; ``apply_sweep`` is
then one GEMM along the last axis (``tridiag_solve_precomputed``, or with
``refine`` the two-GEMM ``tridiag_solve_with_operator``), and
``apply_sweep_y`` applies an operator built from the transposed field
along H by transposing u around it, as the JAX function does.
"""

from __future__ import annotations

import torch

from .smoothing import smooth3
from .tridiag import (tridiag_inverse_operator, tridiag_solve,
                      tridiag_solve_precomputed, tridiag_solve_with_operator)

__all__ = ["sweep_last_axis", "sweep_x", "sweep_y", "sweep_operator",
           "apply_sweep", "apply_sweep_y"]


def _neumann_b(r, dim=-1):
    """b = 1+2r with the Neumann rows b[0] = 1+r[0], b[-1] = 1+r[-1] along
    ``dim``; a width-1 axis has both boundary rows in one: b = 1+r."""
    if r.shape[dim] == 1:
        return 1.0 + r
    r = r.movedim(dim, -1)
    b = torch.cat([1.0 + r[..., :1], 1.0 + 2.0 * r[..., 1:-1],
                   1.0 + r[..., -1:]], dim=-1)
    return b.movedim(-1, dim).contiguous()


def _sweep(u, coeff_field, dt, dh, eps, dim, smooth, impl):
    if smooth:
        coeff_field = smooth3(coeff_field, dim)
    r = coeff_field * (dt / (dh * dh))
    return tridiag_solve(-r, _neumann_b(r, dim) + eps, -r, u, dim,
                         impl=impl)


def sweep_last_axis(u, coeff_field, dt, dx, *, eps, smooth=False,
                    impl=None):
    """One implicit sweep along the trailing axis of u (..., N); the field
    has u's trailing shape and is shared by the leading (batch) axes.
    ``impl``: ``tridiag_solve``'s solver for this sweep (None: the global
    default)."""
    return _sweep(u, coeff_field, dt, dx, eps, -1, smooth, impl)


def sweep_x(u, alpha, dt, dx, *, eps, smooth=False, impl=None):
    """Sweep along W of (..., H, W) with α of shape (..., H, W) sans batch."""
    return sweep_last_axis(u, alpha, dt, dx, eps=eps, smooth=smooth,
                           impl=impl)


def sweep_y(u, beta, dt, dy, *, eps, smooth=False, impl=None):
    """Sweep along H of (..., H, W), down the columns, with no transpose;
    with ``smooth`` the field is smoothed along H."""
    return _sweep(u, beta, dt, dy, eps, -2, smooth, impl)


def sweep_operator(coeff_field, dt, dh, *, eps, smooth=False,
                   dtype=torch.float32):
    """(a, b + eps, c, X) of a sweep along the last axis for coefficient
    field(s) (..., N), with sweep_last_axis's semantics (Neumann rows,
    b + eps, ``smooth`` along the last axis); X from the detached bands,
    stored at ``dtype``.  The bands carry the gradient."""
    if smooth:
        coeff_field = smooth3(coeff_field, -1)
    r = coeff_field * (dt / (dh * dh))
    b = _neumann_b(r) + eps
    return -r, b, -r, tridiag_inverse_operator(-r, b, -r, dtype)


def apply_sweep(ops, u, *, refine=False):
    """u ← T⁻¹u along the last axis with ``ops`` from ``sweep_operator``
    (their leading axes u's trailing ones, shared by u's batch)."""
    a, b, c, X = ops
    if refine:
        return tridiag_solve_with_operator(a, b, c, u, X)
    return tridiag_solve_precomputed(a, b, c, u, X)


def apply_sweep_y(ops, u, *, refine=False):
    """The y apply: ``ops`` were built from the transposed field (solve
    axis H); u (..., H, W) is transposed around the apply."""
    return apply_sweep(ops, u.transpose(-1, -2),
                       refine=refine).transpose(-1, -2)
