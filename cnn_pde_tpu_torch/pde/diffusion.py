"""MixedChannelDiffusion (P4/P5) and GrayscaleDiffusion (P1/P2) — port of
``cnn_pde_tpu/pde/diffusion.py``.

MixedChannelDiffusion.  Per step: learnable channel mixing, then implicit ADI
sweeps with per-channel coefficient fields clamped to [eps, clamp_max] and no
smoothing:
``strang`` runs x(dt/2), y(dt), x(dt/2) and ``lie`` runs x(dt/2), y(dt/2).
The coefficients are evaluated at t, t+dt/2 and t+dt within each step; t
advances by dt/2 after substeps 1 and 2 and never after substep 3.

Configurations:

* per-sweep (default): every sweep is one ``tridiag_solve``, i.e. one K1
  launch on the card — 3 per Strang step — and in training one K3 launch
  (the adjoint) per sweep in the backward;
* ``fused=True``: in training and in eval the whole layer is one
  ``fused_channel_diffusion`` call (``ops/fused_channel_vjp.py``): one K4
  launch forward and one K5 launch backward;
* ``fused_inference=True``: in eval, the whole layer is one K2 launch
  (``ops/fused_channel.py``); it takes precedence over ``fused`` in eval.

GrayscaleDiffusion (the MNIST and Fashion-MNIST front end).  One channel,
(H, W) coefficient fields clamped below at eps only, and each field smoothed
by ``smooth3`` along its sweep axis; Strang x(dt/2), y(dt), x(dt/2) per step,
no mixing.  Configurations: per-sweep (3 K1 launches a step, 3 K3 in the
backward), ``fused=True`` (one K7 launch forward, one K8 backward) and
``fused_inference=True`` (one K6 launch in eval, ahead of ``fused``).

On a CPU tensor every configuration runs its plain versions.  The
hoisted-operator grade (ROADMAP.md A6) and remat (A12) raise here.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.adi import sweep_x, sweep_y
from ..ops.fused_channel import fused_channel_diffusion_fwd
from ..ops.fused_channel_vjp import fused_channel_diffusion
from ..ops.fused_grayscale import fused_grayscale_diffusion_fwd
from ..ops.fused_grayscale_vjp import fused_grayscale_diffusion

__all__ = ["MixedChannelDiffusion", "GrayscaleDiffusion"]


def _substep_times_np(dt: float, num_steps: int) -> np.ndarray:
    """(num_steps, 3) coefficient evaluation times, accumulated in float64 as
    the reference's python-float bookkeeping does."""
    ts = np.empty((num_steps, 3), np.float64)
    t = 0.0
    for s in range(num_steps):
        ts[s, 0] = t
        t += dt / 2
        ts[s, 1] = t
        t += dt / 2
        ts[s, 2] = t
    return ts


def _coeff_at(base, time_coeff, t, eps, cmax=None):
    """α(t) = clamp(α_base + α_time·t, eps, cmax); no upper clamp if cmax is
    None."""
    c = base + time_coeff * t
    return c.clamp(eps, cmax) if cmax is not None else c.clamp_min(eps)


def _mix(mixing, u):
    """mixing @ u over the channel axis as an f32 broadcast multiply-reduce,
    not a matmul (the reference-parity form of the JAX layer)."""
    return (mixing[:, :, None, None] * u[:, None]).sum(dim=2)


def _refuse_unported(layer, hoisted, remat):
    for flag, name, item in ((hoisted, "hoisted", "A6"),
                             (remat, "remat", "A12")):
        if flag:
            raise NotImplementedError(
                f"{layer}({name}=True) is not ported yet: ROADMAP.md {item}")


def _times_buffer(module, dt, num_steps, device):
    module.register_buffer(
        "ts", torch.tensor(_substep_times_np(dt, num_steps),
                           dtype=torch.float32, device=device),
        persistent=False)


class MixedChannelDiffusion(nn.Module):
    """forward(u: (B, C, H, W)) -> (B, C, H, W)."""

    def __init__(self, size=32, channels=3, dt=0.001, dx=1.0, dy=1.0,
                 num_steps=10, splitting="strang", eps=1e-6, clamp_max=10.0,
                 fused_inference=False, fused=False, hoisted=False,
                 remat=False, device=None):
        super().__init__()
        if splitting not in ("strang", "lie"):
            raise ValueError(f"splitting must be 'strang' or 'lie': "
                             f"{splitting!r}")
        _refuse_unported("MixedChannelDiffusion", hoisted, remat)
        self.size = size
        self.channels = channels
        self.dt = dt
        self.dx = dx
        self.dy = dy
        self.num_steps = num_steps
        self.splitting = splitting
        self.eps = eps
        self.clamp_max = clamp_max
        self.fused_inference = fused_inference
        self.fused = fused
        shape = (channels, size, size)
        self.alpha_base = nn.Parameter(torch.ones(shape, device=device))
        self.beta_base = nn.Parameter(torch.ones(shape, device=device))
        self.alpha_time_coeff = nn.Parameter(torch.zeros(shape, device=device))
        self.beta_time_coeff = nn.Parameter(torch.zeros(shape, device=device))
        self.channel_mixing = nn.Parameter(
            torch.eye(channels, device=device))
        _times_buffer(self, dt, num_steps, device)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The JAX layer's init: unit bases, zero time coefficients, and
        mixing = I + 0.01·N(0, 1) drawn from ``generator`` (a CPU one)."""
        self.alpha_base.fill_(1.0)
        self.beta_base.fill_(1.0)
        self.alpha_time_coeff.zero_()
        self.beta_time_coeff.zero_()
        C = self.channels
        noise = torch.randn((C, C), generator=generator) * 0.01
        self.channel_mixing.copy_(torch.eye(C) + noise)

    def forward(self, u):
        eps, cmax = self.eps, self.clamp_max
        params = (self.alpha_base, self.alpha_time_coeff, self.beta_base,
                  self.beta_time_coeff, self.channel_mixing)
        kw = dict(dt=self.dt, dx=self.dx, dy=self.dy, ts=self.ts,
                  splitting=self.splitting, eps=eps, cmax=cmax)
        if self.fused_inference and not self.training:
            return fused_channel_diffusion_fwd(u, *params, **kw)
        if self.fused:
            return fused_channel_diffusion(u, *params, **kw)
        strang = self.splitting == "strang"
        dt_y = self.dt if strang else self.dt / 2
        ts = self.ts
        for s in range(self.num_steps):
            u = _mix(self.channel_mixing, u)
            alpha = _coeff_at(self.alpha_base, self.alpha_time_coeff,
                              ts[s, 0], eps, cmax)
            u = sweep_x(u, alpha, self.dt / 2, self.dx, eps=eps)
            beta = _coeff_at(self.beta_base, self.beta_time_coeff, ts[s, 1],
                             eps, cmax)
            u = sweep_y(u, beta, dt_y, self.dy, eps=eps)
            if strang:
                alpha = _coeff_at(self.alpha_base, self.alpha_time_coeff,
                                  ts[s, 2], eps, cmax)
                u = sweep_x(u, alpha, self.dt / 2, self.dx, eps=eps)
        return u


class GrayscaleDiffusion(nn.Module):
    """forward(u: (B, 1, H, W)) -> (B, 1, H, W), with H = W = ``size``."""

    def __init__(self, size=28, dt=0.001, dx=1.0, dy=1.0, num_steps=10,
                 init_value=2.0, eps=1e-6, fused_inference=False, fused=False,
                 hoisted=False, remat=False, device=None):
        super().__init__()
        _refuse_unported("GrayscaleDiffusion", hoisted, remat)
        self.size = size
        self.dt = dt
        self.dx = dx
        self.dy = dy
        self.num_steps = num_steps
        self.init_value = init_value
        self.eps = eps
        self.fused_inference = fused_inference
        self.fused = fused
        shape = (size, size)
        self.alpha_base = nn.Parameter(
            torch.full(shape, float(init_value), device=device))
        self.beta_base = nn.Parameter(
            torch.full(shape, float(init_value), device=device))
        self.alpha_time_coeff = nn.Parameter(torch.zeros(shape, device=device))
        self.beta_time_coeff = nn.Parameter(torch.zeros(shape, device=device))
        _times_buffer(self, dt, num_steps, device)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The JAX layer's init: bases at ``init_value``, zero time
        coefficients (no random draw)."""
        self.alpha_base.fill_(self.init_value)
        self.beta_base.fill_(self.init_value)
        self.alpha_time_coeff.zero_()
        self.beta_time_coeff.zero_()

    def forward(self, u):
        x = u[:, 0]
        eps = self.eps
        fields = (self.alpha_base, self.alpha_time_coeff, self.beta_base,
                  self.beta_time_coeff)
        kw = dict(dt=self.dt, dx=self.dx, dy=self.dy, ts=self.ts, eps=eps)
        if self.fused_inference and not self.training:
            return fused_grayscale_diffusion_fwd(x.contiguous(), *fields,
                                                 **kw)[:, None]
        if self.fused:
            return fused_grayscale_diffusion(x.contiguous(), *fields,
                                             **kw)[:, None]
        ts = self.ts
        for s in range(self.num_steps):
            alpha = _coeff_at(self.alpha_base, self.alpha_time_coeff,
                              ts[s, 0], eps)
            x = sweep_x(x, alpha, self.dt / 2, self.dx, eps=eps, smooth=True)
            beta = _coeff_at(self.beta_base, self.beta_time_coeff, ts[s, 1],
                             eps)
            x = sweep_y(x, beta, self.dt, self.dy, eps=eps, smooth=True)
            alpha = _coeff_at(self.alpha_base, self.alpha_time_coeff,
                              ts[s, 2], eps)
            x = sweep_x(x, alpha, self.dt / 2, self.dx, eps=eps, smooth=True)
        return x[:, None]

    @torch.no_grad()
    def stability_info(self):
        """CFL diagnostic of the JAX layer: stable iff α·dt/dx² < 0.5 (and
        β·dt/dy²), with each field at its largest over the horizon."""
        horizon = self.dt * self.num_steps
        alpha_max = (self.alpha_base
                     + self.alpha_time_coeff.abs() * horizon).max()
        beta_max = (self.beta_base
                    + self.beta_time_coeff.abs() * horizon).max()
        cfl_x = float(alpha_max * self.dt / self.dx ** 2)
        cfl_y = float(beta_max * self.dt / self.dy ** 2)
        return {
            "cfl_x": cfl_x, "cfl_y": cfl_y,
            "dx": self.dx, "dy": self.dy, "dt": self.dt,
            "stable_x": cfl_x < 0.5, "stable_y": cfl_y < 0.5,
        }
