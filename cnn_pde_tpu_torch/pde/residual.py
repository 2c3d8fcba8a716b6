"""The Tiny-ImageNet residual diffusion front end — port of
``cnn_pde_tpu/pde/residual.py::ResidualDiffusion``.

Each step: clamp α to [eps, max_coeff], scale u by channel, take the
explicit 5-point Laplacian step (``ops/stencil.py::laplacian_step``), then
the damped update u ← u + 0.1·(u_new − u).  ``beta_base`` is a parameter
that the explicit forward never reads (kept for state_dict parity).

``use_implicit=True`` takes an x sweep then a y sweep at dt/2 with dx = 1,
per-channel scalar coefficients broadcast to (C, H, W) and no smoothing:
``ops/adi.py::sweep_x`` and ``sweep_y``, one K1 launch each on the card and
one K3 launch each in the backward.  ``solve_impl`` routes those two
solves: 'auto' follows ``tridiag_solve``'s global default
(``set_default_impl``); 'matinv_bf16' (set by ``pde.enable_amp``) builds
each sweep's inverse operator at the call (one K1 launch), stores it in
bf16 and applies it by one GEMM, as the JAX AMP grade's global
'matinv_bf16' does for this layer, without touching the global.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.adi import sweep_x, sweep_y
from ..ops.stencil import laplacian_step
from .linearize import linearized_apply

__all__ = ["ResidualDiffusion"]


class ResidualDiffusion(nn.Module):
    def __init__(self, size=64, channels=3, dt=0.01, num_steps=1,
                 use_implicit=False, eps=1e-6, max_coeff=0.15,
                 solve_impl="auto", device=None):
        super().__init__()
        self.size = size
        self.channels = channels
        self.dt = dt
        self.num_steps = num_steps
        self.use_implicit = use_implicit
        self.eps = eps
        self.max_coeff = max_coeff
        self.solve_impl = solve_impl
        for name in ("alpha_base", "beta_base", "channel_scaling"):
            self.register_parameter(name, nn.Parameter(
                torch.empty(channels, device=device)))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The JAX init (constants: the generator is not drawn from)."""
        self.alpha_base.fill_(0.05)
        self.beta_base.fill_(0.05)
        self.channel_scaling.fill_(1.0)

    def forward(self, u):
        lin = linearized_apply(self, u)
        if lin is not None:
            return lin
        impl = None if self.solve_impl == "auto" else self.solve_impl
        for _ in range(self.num_steps):
            alpha_eff = self.alpha_base.clamp(self.eps, self.max_coeff)
            u_scaled = u * self.channel_scaling[None, :, None, None]
            if self.use_implicit:
                beta_eff = self.beta_base.clamp(self.eps, self.max_coeff)
                shape = (self.channels, *u.shape[-2:])
                af = alpha_eff[:, None, None].expand(shape)
                bf = beta_eff[:, None, None].expand(shape)
                u_new = sweep_x(u_scaled, af, self.dt / 2, 1.0,
                                eps=self.eps, impl=impl)
                u_new = sweep_y(u_new, bf, self.dt / 2, 1.0, eps=self.eps,
                                impl=impl)
            else:
                u_new = laplacian_step(u_scaled, alpha_eff, self.dt)
            u = u + 0.1 * (u_new - u)
        return u
