"""A tridiagonal solve along a SHARDED axis (substructuring, the partition
method) — port of ``cnn_pde_tpu/parallel/dist_tridiag.py``, the third ADI
strategy beside the halo-exchange stencils and the all_to_all axis swap
(``parallel/spatial.py``).

The swap moves the whole state across the devices twice a Strang step so
that every solve axis is local.  Here the solve axis stays sharded and
only the interface system crosses:

1. Each rank holds m = n/S contiguous rows of every system and solves
   three LOCAL systems with its block T_loc (the couplings to the
   neighbouring blocks dropped):
       x_d = T_loc⁻¹ d           (the right-hand side, batched)
       x_a = T_loc⁻¹ (a₀·e₁)     (the previous block's last row's pull)
       x_c = T_loc⁻¹ (c_m·e_m)   (the next block's first row's pull)
   as one K1 launch over the stacked right-hand sides (``tridiag_solve``;
   a batch-free band shape (F, m), x_d's rows (B, F, m), x_a's and x_c's
   band-shaped), so the block of the true solution is
       x = x_d − x_a·x_L − x_c·x_R
   with x_L, x_R the neighbours' unknown boundary values.
2. That identity at each block's first and last row couples only the 2S
   boundary unknowns: a (2S × 2S) system whose matrix depends on the bands
   alone (one factorization serves the batch) and whose right-hand side is
   two rows of x_d a rank.  Two ``all_gather``s of those interface rows
   (O(S·rows) numbers, whatever m is) replicate it; every rank solves it
   densely with ``torch.linalg.solve_ex`` (JAX solves it with
   ``jnp.linalg.solve``, outside any Pallas kernel) and takes its two
   neighbour values.
3. One local AXPY finishes.  Everything is differentiable: the local
   solves carry K3 in the backward, and each gather's backward is a
   reduce-scatter, since each rank reads other parts of the reduced
   solution (``collectives.all_gather``).

Neumann rows sit at the global ends of the axis only.
"""

from __future__ import annotations

import torch

from ..ops.adi import sweep_last_axis
from ..ops.tridiag import tridiag_solve
from .collectives import all_gather, halo_exchange

__all__ = ["tridiag_solve_partitioned", "sweep_sharded_axis",
           "adi_strang_step_partitioned"]

AXIS = "spatial"


def _edge_vector(value, m, first):
    """A band-shaped tensor, zero but for ``value`` in its first (or last)
    row: the right-hand side a neighbour's coupling puts on the block."""
    zeros = value.new_zeros(tuple(value.shape) + (m - 1,))
    col = value[..., None]
    return torch.cat([col, zeros] if first else [zeros, col], dim=-1)


def tridiag_solve_partitioned(a, b, c, d, mesh, axis=AXIS):
    """Solve tridiag(a, b, c)·x = d along the last axis when that axis is
    sharded over ``axis``: every argument holds this rank's block.  The
    bands share one batch-free shape (F, m); d is (B, F, m) or band-shaped.
    Needs at least 2 rows a block."""
    _, p, S = mesh.axis(axis)
    if S == 1:
        return tridiag_solve(a, b, c, d)
    m = d.shape[-1]
    if m < 2:
        raise ValueError("the partitioned solve needs at least 2 rows a "
                         "block")
    band = tuple(a.shape)
    batched = d.dim() > len(band)
    rows = d.reshape((-1,) + band) if batched else d[None]
    # the couplings to the neighbouring blocks (none at the global ends)
    a_left = a[..., 0] if p > 0 else torch.zeros_like(a[..., 0])
    c_right = c[..., -1] if p < S - 1 else torch.zeros_like(c[..., -1])
    rhs = torch.cat([rows, _edge_vector(a_left, m, True)[None],
                     _edge_vector(c_right, m, False)[None]])
    x = tridiag_solve(a.contiguous(), b.contiguous(), c.contiguous(),
                      rhs.contiguous())
    xd, xa, xc = x[:-2], x[-2], x[-1]

    # the interface rows, replicated: (S, 4, *F) and (S, 2, B, *F)
    ga = all_gather(torch.stack([xa[..., 0], xa[..., -1], xc[..., 0],
                                 xc[..., -1]]), mesh, axis)
    gd = all_gather(torch.stack([xd[..., 0], xd[..., -1]]), mesh, axis)

    # unknowns z = [x_f0, x_l0, x_f1, x_l1, ...]; block q's equations:
    #   x_f_q + xa_f·z[2q−1] + xc_f·z[2q+2] = xd_f
    #   x_l_q + xa_l·z[2q−1] + xc_l·z[2q+2] = xd_l
    n2 = 2 * S
    M = torch.eye(n2, dtype=d.dtype, device=d.device).expand(
        band[:-1] + (n2, n2)).clone()
    for q in range(S):
        if q > 0:
            M[..., 2 * q, 2 * q - 1] = ga[q, 0]
            M[..., 2 * q + 1, 2 * q - 1] = ga[q, 1]
        if q < S - 1:
            M[..., 2 * q, 2 * q + 2] = ga[q, 2]
            M[..., 2 * q + 1, 2 * q + 2] = ga[q, 3]
    # right-hand sides (*F, 2S, B): one factorization a system serves the
    # whole batch
    r = gd.permute(*range(3, gd.dim()), 0, 1, 2).reshape(
        band[:-1] + (n2, gd.shape[2]))
    z = torch.linalg.solve_ex(M, r, check_errors=False)[0]
    z = z.movedim(-1, 0)                               # (B, *F, 2S)
    zero = torch.zeros_like(z[..., 0])
    xL = z[..., 2 * p - 1] if p > 0 else zero
    xR = z[..., 2 * p + 2] if p < S - 1 else zero
    out = xd - xa * xL[..., None] - xc * xR[..., None]
    return out.reshape(d.shape)


def _smooth3_sharded(f, mesh, axis=AXIS):
    """``ops/smoothing.py::smooth3`` along the last axis when that axis is
    sharded: one element from each neighbour; the global ends replicate
    their edge value, as the unsharded edge padding does."""
    _, p, S = mesh.axis(axis)
    from_left, from_right = halo_exchange(f[..., :1], f[..., -1:], mesh,
                                          axis)
    left = f[..., :1] if p == 0 else from_left
    right = f[..., -1:] if p == S - 1 else from_right
    fl = torch.cat([left, f[..., :-1]], dim=-1)
    fr = torch.cat([f[..., 1:], right], dim=-1)
    k = 1.0 / 3.0
    return fl * k + f * k + fr * k


def sweep_sharded_axis(u, coeff_field, dt, dh, *, smooth, eps, mesh,
                       axis=AXIS):
    """One implicit diffusion sweep (``ops/adi.py::sweep_last_axis``'s
    semantics: Neumann ends, optional smoothing, eps on b) along the last
    axis when that axis is sharded over ``axis``."""
    _, p, S = mesh.axis(axis)
    if smooth:
        coeff_field = _smooth3_sharded(coeff_field, mesh, axis)
    r = coeff_field * (dt / (dh * dh))
    # the Neumann rows live at the GLOBAL ends only
    first = 1.0 + (r[..., :1] if p == 0 else 2.0 * r[..., :1])
    last = 1.0 + (r[..., -1:] if p == S - 1 else 2.0 * r[..., -1:])
    b = torch.cat([first, 1.0 + 2.0 * r[..., 1:-1], last], dim=-1)
    return tridiag_solve_partitioned(-r, b + eps, -r, u, mesh, axis)


def adi_strang_step_partitioned(mesh, u, alpha, beta, *, dt, dx=1.0,
                                dy=1.0, smooth=False, eps=1e-6):
    """One Strang ADI step with H sharded over 'spatial', the y-sweep
    solved through the sharded axis by the partitioned solve (no
    all_to_all).  u: this rank's block (B, H/S, W); alpha/beta: its
    (H/S, W) blocks.  The x-sweeps are local; the y-sweep runs on the
    transposed (B, W, H/S) state and (W, H/S) field, made contiguous for
    K1."""
    u, alpha = u.contiguous(), alpha.contiguous()
    u = sweep_last_axis(u, alpha, dt / 2, dx, smooth=smooth, eps=eps)
    u_t = u.transpose(-1, -2).contiguous()
    beta_t = beta.transpose(-1, -2).contiguous()
    u_t = sweep_sharded_axis(u_t, beta_t, dt, dy, smooth=smooth, eps=eps,
                             mesh=mesh)
    u = u_t.transpose(-1, -2).contiguous()
    return sweep_last_axis(u, alpha, dt / 2, dx, smooth=smooth, eps=eps)
