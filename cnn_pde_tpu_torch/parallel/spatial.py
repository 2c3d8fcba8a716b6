"""Spatial sharding for PDE evolution — port of
``cnn_pde_tpu/parallel/spatial.py``: the feature map's H axis sharded over
the mesh's 'spatial' axis, each rank holding a block of H/S rows.

Where JAX's ``shard_map`` body sees its local block, these functions take
and return this rank's block, with the mesh:

* ``ftcs_evolve_spatial``: the emotion layer's FTCS steps
  (``ops/stencil.py::ftcs_evolve``) with one halo row exchanged with each
  neighbour a step (``collectives.halo_exchange``).  The reference's frozen
  reflect ring is kept: the global top and bottom rows of the ring are the
  initial state's, never refreshed; only the rows between shards are.
* ``laplacian_step_spatial``: the Tiny-ImageNet front end's zero-padded
  Laplacian step with one halo row a neighbour and zero rows at the global
  edges.
* ``adi_strang_step_spatial``: one Strang step, x half-sweep, y sweep,
  x half-sweep.  The x-sweeps solve along the local W; for the y-sweep an
  ``all_to_all`` swaps the state and β to whole columns (H local, W
  sharded), the sweep solves down them in place (``ops/adi.py::sweep_y``),
  and one more ``all_to_all`` swaps back: three all-to-alls a step.  Each
  sweep is one K1 launch on the card, one K3 launch in the backward.

FTCS and the Laplacian are plain PyTorch, as XLA computes them outside any
Pallas kernel in the JAX package.
"""

from __future__ import annotations

import torch

from ..ops.adi import sweep_last_axis, sweep_y
from ..ops.stencil import laplacian
from .collectives import all_to_all, halo_exchange

__all__ = ["ftcs_evolve_spatial", "adi_strang_step_spatial",
           "laplacian_step_spatial", "block"]

AXIS = "spatial"


def block(mesh, n, axis=AXIS):
    """This rank's rows [lo, hi) of an extent ``n`` sharded over
    ``axis``."""
    _, index, size = mesh.axis(axis)
    if n % size:
        raise ValueError(f"extent {n} does not split over the {axis!r} "
                         f"axis of {size}")
    per = n // size
    return index * per, (index + 1) * per


def ftcs_evolve_spatial(mesh, u, alpha, beta, nt: int):
    """``nt`` FTCS steps with H sharded over 'spatial'.  u: this rank's
    block (B, H/S, W); alpha/beta: its (H/S, W) blocks of the grids.

    The ring's columns (reflect along W) are local; its top row is the
    global row 1 (held by the first shard) and its bottom row the global
    row H−2 (the last shard's), both frozen at their initial values."""
    _, index, size = mesh.axis(AXIS)
    top_frozen = u[:, 1:2, :]
    bot_frozen = u[:, -2:-1, :]
    left, right = u[:, :, 1:2], u[:, :, -2:-1]
    ui = u
    for _ in range(nt):
        from_prev, from_next = halo_exchange(ui[:, :1, :], ui[:, -1:, :],
                                             mesh, AXIS)
        top = top_frozen if index == 0 else from_prev
        bot = bot_frozen if index == size - 1 else from_next
        u_up = torch.cat([top, ui[:, :-1, :]], dim=1)
        u_dn = torch.cat([ui[:, 1:, :], bot], dim=1)
        u_lf = torch.cat([left, ui[:, :, :-1]], dim=2)
        u_rt = torch.cat([ui[:, :, 1:], right], dim=2)
        u_xx = u_up + u_dn - 2.0 * ui
        u_yy = u_lf + u_rt - 2.0 * ui
        ui = ui + alpha * u_xx + beta * u_yy
    return ui


def laplacian_step_spatial(mesh, u, coeff, *, dt):
    """u + coeff·dt·Δu with H sharded over 'spatial' (the zero-padded
    exterior of ``ops/stencil.py::laplacian_step``).  u: this rank's block
    (B, C, H/S, W); coeff: (C,), replicated."""
    top, bot = halo_exchange(u[:, :, :1, :], u[:, :, -1:, :], mesh, AXIS)
    up = torch.cat([top, u, bot], dim=2)          # (B, C, H/S + 2, W)
    lap = laplacian(up)[:, :, 1:-1, :]            # the block's rows only
    return u + coeff[None, :, None, None] * dt * lap


def adi_strang_step_spatial(mesh, u, alpha, beta, *, dt, dx=1.0, dy=1.0,
                            smooth=False, eps=1e-6):
    """One Strang ADI step with H sharded over 'spatial'.  u: this rank's
    block (B, H/S, W); alpha/beta: its (H/S, W) blocks of the fields.
    K1 takes contiguous float32 bands and right-hand sides: every view is
    made contiguous before a sweep."""
    u, alpha, beta = u.contiguous(), alpha.contiguous(), beta.contiguous()
    u = sweep_last_axis(u, alpha, dt / 2, dx, smooth=smooth, eps=eps)
    u_sw = all_to_all(u, mesh, AXIS, -1, -2)          # (B, H, W/S)
    beta_sw = all_to_all(beta, mesh, AXIS, -1, -2)    # (H, W/S)
    u_sw = sweep_y(u_sw.contiguous(), beta_sw.contiguous(), dt, dy,
                   smooth=smooth, eps=eps)
    u = all_to_all(u_sw, mesh, AXIS, -2, -1)          # (B, H/S, W)
    return sweep_last_axis(u.contiguous(), alpha, dt / 2, dx, smooth=smooth,
                           eps=eps)
