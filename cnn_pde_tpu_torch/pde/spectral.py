"""The emotion family's FTCS layer with Fourier-parameterised coefficient
fields — port of ``cnn_pde_tpu/pde/spectral.py::FourierFTCSLayer``.

Only six scalar weights are learnable; the coefficient grids are

    α(y) = 0.5·dt·(w₁ + w₂·sin 2πy + w₃·sin 4πy)/dx²   (applied to u_xx)
    β(x) =     dt·(w₁ + w₂·cos 2πx + w₃·cos 4πx)/dy²   (applied to u_yy)

on ``meshgrid(y, x, indexing='ij')``, so α varies along the first spatial
axis.  The coordinate grids are buffers under the reference's names
(``x``, ``y``: ``pde.x`` and ``pde.y`` in a reference ``best_model.pth``),
so such a checkpoint loads with ``strict=True``.  The evolution is
``ops/stencil.py::ftcs_evolve``, ``Nt = int(T/dt)`` steps.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.stencil import ftcs_evolve

__all__ = ["FourierFTCSLayer"]

# the JAX layer's init: (alpha_w1, alpha_w2, alpha_w3, beta_w1, beta_w2,
# beta_w3)
_INIT = {"alpha_w1": 0.1, "alpha_w2": 0.1, "alpha_w3": 0.1,
         "beta_w1": 0.3, "beta_w2": 0.2, "beta_w3": 0.2}


class FourierFTCSLayer(nn.Module):
    def __init__(self, Nx=48, Ny=48, Lx=1.0, Ly=1.0, T=0.01, dt=0.001,
                 device=None):
        super().__init__()
        self.Nx, self.Ny, self.Lx, self.Ly = Nx, Ny, Lx, Ly
        self.T, self.dt = T, dt
        self.dx = Lx / Nx
        self.dy = Ly / Ny
        self.Nt = int(T / dt)
        for name, value in _INIT.items():
            self.register_parameter(name, nn.Parameter(
                torch.tensor(value, dtype=torch.float32, device=device)))
        self.register_buffer("x", torch.linspace(0.0, Lx, Nx, device=device))
        self.register_buffer("y", torch.linspace(0.0, Ly, Ny, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The JAX init (constants: the generator is not drawn from)."""
        for name, value in _INIT.items():
            getattr(self, name).fill_(value)

    def coefficient_grids(self):
        """(α, β) on (Ny, Nx), computed in float64 and rounded once to the
        weights' dtype: the evolution amplifies the grids' rounding with
        its values (§ module docstring), and float32 sines of float32
        arguments put the port's grids further from the exact ones than
        the JAX layer's."""
        dtype = self.alpha_w1.dtype
        yy, xx = torch.meshgrid(self.y.double(), self.x.double(),
                                indexing="ij")
        w = {name: getattr(self, name).double() for name in _INIT}
        two_pi = 2.0 * math.pi
        alpha = 0.5 * self.dt * (
            w["alpha_w1"]
            + w["alpha_w2"] * torch.sin(two_pi * yy)
            + w["alpha_w3"] * torch.sin(2 * two_pi * yy)
        ) / self.dx ** 2
        beta = self.dt * (
            w["beta_w1"]
            + w["beta_w2"] * torch.cos(two_pi * xx)
            + w["beta_w3"] * torch.cos(2 * two_pi * xx)
        ) / self.dy ** 2
        return alpha.to(dtype), beta.to(dtype)

    def forward(self, u):
        alpha, beta = self.coefficient_grids()
        return ftcs_evolve(u[:, 0], alpha, beta, self.Nt)[:, None]
