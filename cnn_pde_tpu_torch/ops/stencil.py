"""Explicit PDE time steps — port of ``cnn_pde_tpu/ops/stencil.py``.

* ``ftcs_evolve``: the emotion layer's FTCS scheme with the reference's
  frozen ring: the state is reflect-padded once, before the step loop, and
  the four strips of that ring stay the neighbours of the edge rows and
  columns at every step; only the interior is carried.
* ``laplacian`` and ``laplacian_step``: the Tiny-ImageNet front end's
  5-point Laplacian with zero padding (a Dirichlet-0 exterior) as
  shift-adds, and its explicit step u + coeff·dt·Δu per channel.

The expressions keep the JAX functions' order (``u_xx = u_up + u_dn −
2u``, then ``u + α·u_xx + β·u_yy``): the emotion layer is CFL-unstable at
its own init (β·dt/dy² ≈ 1.6), so ten steps amplify values about 1e6× and
any reassociation with them.  These are plain PyTorch ops: XLA fuses them
in the JAX package, and no Pallas kernel is involved.  One fused FTCS
launch is a later optimisation (ROADMAP.md queue B).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ftcs_evolve", "laplacian", "laplacian_step"]


def ftcs_evolve(u, alpha_grid, beta_grid, nt):
    """``nt`` explicit FTCS steps on (B, H, W) with a one-time
    reflect-padded ring:

        u[i,j] += α·(u[i+1,j] − 2u[i,j] + u[i−1,j])
                  + β·(u[i,j+1] − 2u[i,j] + u[i,j−1])

    ``alpha_grid`` and ``beta_grid`` are (H, W), already folded with
    dt/dx², shared by the batch."""
    up0 = F.pad(u[:, None], (1, 1, 1, 1), mode="reflect")[:, 0]
    top, bot = up0[:, 0:1, 1:-1], up0[:, -1:, 1:-1]       # (B, 1, W)
    left, right = up0[:, 1:-1, 0:1], up0[:, 1:-1, -1:]    # (B, H, 1)
    ui = u
    for _ in range(nt):
        u_up = torch.cat([top, ui[:, :-1, :]], dim=1)
        u_dn = torch.cat([ui[:, 1:, :], bot], dim=1)
        u_lf = torch.cat([left, ui[:, :, :-1]], dim=2)
        u_rt = torch.cat([ui[:, :, 1:], right], dim=2)
        u_xx = u_up + u_dn - 2.0 * ui
        u_yy = u_lf + u_rt - 2.0 * ui
        ui = ui + alpha_grid * u_xx + beta_grid * u_yy
    return ui


def laplacian(u):
    """5-point Laplacian of NCHW ``u`` with zero padding, as zero-padded
    shift-adds: (up + down) + (left + right) − 4u."""
    z_row = torch.zeros_like(u[:, :, :1, :])
    down = torch.cat([u[:, :, 1:, :], z_row], dim=2)     # u[i+1, j]
    up = torch.cat([z_row, u[:, :, :-1, :]], dim=2)      # u[i-1, j]
    z_col = torch.zeros_like(u[..., :1])
    right = torch.cat([u[..., 1:], z_col], dim=-1)       # u[i, j+1]
    left = torch.cat([z_col, u[..., :-1]], dim=-1)       # u[i, j-1]
    return (up + down) + (left + right) - 4.0 * u


def laplacian_step(u, coeff, dt):
    """u + coeff·dt·Δu with a per-channel ``coeff`` (C,)."""
    return u + coeff[None, :, None, None] * dt * laplacian(u)
