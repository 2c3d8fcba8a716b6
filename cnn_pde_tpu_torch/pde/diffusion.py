"""MixedChannelDiffusion (P4/P5), GrayscaleDiffusion (P1/P2) and
ChannelCoupledDiffusion (P3) — port of ``cnn_pde_tpu/pde/diffusion.py``.

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

ChannelCoupledDiffusion (the SVHN front end).  Per-channel (C, H, W)
fields clamped below at eps and smoothed along each sweep's axis; Strang
x(dt/2), y(dt), x(dt/2) per step with the y-sweep reusing dx; after each
step's sweeps the channels are coupled, u ← Σ coup[:, :, None, None]·u;
the output is sigmoid(skip)·u₀ + (1 − sigmoid(skip))·u.  Per-sweep only
(3 K1 launches a step, 3 K3 in the backward), and hoisted.

``hoisted=True`` (all three layers; the AMP grade with
``operator_dtype=torch.bfloat16``): every sweep's inverse operator of the
whole evolution is built once a forward, batch-free, by two K1 launches
(the x stack and the y stack, ``ops/adi.py::sweep_operator``), and each
sweep is then one batched GEMM (``apply_sweep``), its backward one
transposed GEMM and the band sums; ``hoisted_refine=True`` takes the
two-GEMM refined form.  An ``operator_cache`` pinned by
``serve.cache_hoisted_operators`` replaces the build in eval and raises in
training.  The fused configurations take precedence over ``hoisted``, as
in the JAX layers.

``remat=True`` (MixedChannelDiffusion and GrayscaleDiffusion, as in the
JAX package) recomputes each step of the per-sweep and hoisted branches in
the backward instead of keeping its intermediates
(``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint`` of the
scan body): the same arithmetic, so the same outputs and gradients bit for
bit.  The fused branches ignore it, as in JAX, where they return first.

On a CPU tensor every configuration runs its plain versions.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.adi import (apply_sweep, apply_sweep_y, sweep_operator, sweep_x,
                       sweep_y)
from ..ops.fused_channel import fused_channel_diffusion_fwd
from ..ops.fused_channel_vjp import fused_channel_diffusion
from ..ops.fused_grayscale import fused_grayscale_diffusion_fwd
from ..ops.fused_grayscale_vjp import fused_grayscale_diffusion

__all__ = ["MixedChannelDiffusion", "GrayscaleDiffusion",
           "ChannelCoupledDiffusion"]


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


def _coeff_at_times(base, time_coeff, times, eps, cmax=None):
    """``_coeff_at`` over a stack of times: shape times.shape + base.shape."""
    t = times.reshape(times.shape + (1,) * base.ndim)
    return _coeff_at(base, time_coeff, t, eps, cmax)


def _mix(mixing, u):
    """mixing @ u over the channel axis as an f32 broadcast multiply-reduce,
    not a matmul (the reference-parity form of the JAX layer)."""
    return (mixing[:, :, None, None] * u[:, None]).sum(dim=2)


def _step_fn(layer, step):
    """``step`` or, with ``layer.remat``, ``step`` recomputed in the
    backward.  The steps draw no random numbers, so the RNG state is not
    kept (and a step captured in a CUDA graph reads none on the host)."""
    if not getattr(layer, "remat", False):
        return step
    return lambda *args: checkpoint(step, *args, use_reentrant=False,
                                    preserve_rng_state=False)


def _hoisted_operators(layer, dt_y, dy, *, smooth, cmax=None, strang=True):
    """Every sweep operator of ``layer``'s evolution, built in two stacks
    (x and y) from its fields at the static substep times: per step
    (x@t, y@t+dt/2, x@t+dt) for Strang, (x@t, y@t+dt/2) for Lie, each a
    tuple (a, b, c, X) stacked over the steps."""
    ts, eps = layer.ts, layer.eps
    x_times = ts[:, 0::2] if strang else ts[:, :1]
    alpha = _coeff_at_times(layer.alpha_base, layer.alpha_time_coeff,
                            x_times, eps, cmax)
    ops_x = sweep_operator(alpha, layer.dt / 2, layer.dx, eps=eps,
                           smooth=smooth, dtype=layer.operator_dtype)
    beta = _coeff_at_times(layer.beta_base, layer.beta_time_coeff, ts[:, 1],
                           eps, cmax)
    ops_y = sweep_operator(beta.transpose(-1, -2), dt_y, dy, eps=eps,
                           smooth=smooth, dtype=layer.operator_dtype)
    x0 = tuple(t[:, 0] for t in ops_x)
    if strang:
        return x0, ops_y, tuple(t[:, 1] for t in ops_x)
    return x0, ops_y


def _layer_operators(layer):
    """The hoisted branch's operators: the pinned ``operator_cache``
    (serving with frozen weights) or a fresh build.  The cache carries no
    gradient and goes stale when the weights change, so training with one
    pinned raises."""
    cache = getattr(layer, "operator_cache", None)
    if cache is not None:
        if layer.training:
            raise ValueError(
                "operator_cache is pinned on this layer (frozen-weights "
                "serving) and it is in training mode; "
                "clear_operator_cache(model) before training")
        return cache
    return layer.hoisted_operators()


def _hoisted_steps(layer, u, ops, before=None, after=None):
    """Apply the per-step operators (each stacked over the steps) to u:
    ``before`` and ``after`` act on u around each step's sweeps."""
    refine = layer.hoisted_refine

    def step(u, *step_ops):
        if before is not None:
            u = before(u)
        for i, op in enumerate(step_ops):
            apply = apply_sweep_y if i == 1 else apply_sweep
            u = apply(op, u, refine=refine)
        if after is not None:
            u = after(u)
        return u

    step = _step_fn(layer, step)
    for s in range(layer.num_steps):
        u = step(u, *(tuple(t[s] for t in stack) for stack in ops))
    return u


def runs_hoisted(layer) -> bool:
    """Whether ``layer``'s eval forward takes the hoisted branch (a fused
    configuration takes precedence)."""
    return (getattr(layer, "hoisted", False)
            and not getattr(layer, "fused_inference", False)
            and not getattr(layer, "fused", False))


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
                 operator_dtype=torch.float32, hoisted_refine=False,
                 remat=False, device=None):
        super().__init__()
        if splitting not in ("strang", "lie"):
            raise ValueError(f"splitting must be 'strang' or 'lie': "
                             f"{splitting!r}")
        self.remat = remat
        self.hoisted = hoisted
        self.operator_dtype = operator_dtype
        self.hoisted_refine = hoisted_refine
        self.operator_cache = None
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
        if self.hoisted:
            return _hoisted_steps(
                self, u, _layer_operators(self),
                before=lambda u: _mix(self.channel_mixing, u))
        def step(u, t3):
            u = _mix(self.channel_mixing, u)
            alpha = _coeff_at(self.alpha_base, self.alpha_time_coeff,
                              t3[0], eps, cmax)
            u = sweep_x(u, alpha, self.dt / 2, self.dx, eps=eps)
            beta = _coeff_at(self.beta_base, self.beta_time_coeff, t3[1],
                             eps, cmax)
            u = sweep_y(u, beta, dt_y, self.dy, eps=eps)
            if strang:
                alpha = _coeff_at(self.alpha_base, self.alpha_time_coeff,
                                  t3[2], eps, cmax)
                u = sweep_x(u, alpha, self.dt / 2, self.dx, eps=eps)
            return u

        step = _step_fn(self, step)
        for s in range(self.num_steps):
            u = step(u, self.ts[s])
        return u

    def hoisted_operators(self):
        """Every sweep operator of the evolution (``_hoisted_operators``)."""
        strang = self.splitting == "strang"
        return _hoisted_operators(
            self, self.dt if strang else self.dt / 2, self.dy, smooth=False,
            cmax=self.clamp_max, strang=strang)


class GrayscaleDiffusion(nn.Module):
    """forward(u: (B, 1, H, W)) -> (B, 1, H, W), with H = W = ``size``."""

    def __init__(self, size=28, dt=0.001, dx=1.0, dy=1.0, num_steps=10,
                 init_value=2.0, eps=1e-6, fused_inference=False, fused=False,
                 hoisted=False, operator_dtype=torch.float32,
                 hoisted_refine=False, remat=False, device=None):
        super().__init__()
        self.remat = remat
        self.hoisted = hoisted
        self.operator_dtype = operator_dtype
        self.hoisted_refine = hoisted_refine
        self.operator_cache = None
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
        if self.hoisted:
            return _hoisted_steps(self, x, _layer_operators(self))[:, None]
        def step(x, t3):
            alpha = _coeff_at(self.alpha_base, self.alpha_time_coeff,
                              t3[0], eps)
            x = sweep_x(x, alpha, self.dt / 2, self.dx, eps=eps, smooth=True)
            beta = _coeff_at(self.beta_base, self.beta_time_coeff, t3[1],
                             eps)
            x = sweep_y(x, beta, self.dt, self.dy, eps=eps, smooth=True)
            alpha = _coeff_at(self.alpha_base, self.alpha_time_coeff,
                              t3[2], eps)
            x = sweep_x(x, alpha, self.dt / 2, self.dx, eps=eps, smooth=True)
            return x

        step = _step_fn(self, step)
        for s in range(self.num_steps):
            x = step(x, self.ts[s])
        return x[:, None]

    def hoisted_operators(self):
        """Every sweep operator of the evolution (``_hoisted_operators``)."""
        return _hoisted_operators(self, self.dt, self.dy, smooth=True)

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


class ChannelCoupledDiffusion(nn.Module):
    """forward(u: (B, C, H, W)) -> (B, C, H, W), with H = W = ``size``."""

    def __init__(self, size=32, channels=3, dt=0.01, dx=1.0, num_steps=10,
                 eps=1e-6, hoisted=False, operator_dtype=torch.float32,
                 hoisted_refine=False, device=None):
        super().__init__()
        self.size = size
        self.channels = channels
        self.dt = dt
        self.dx = dx
        self.num_steps = num_steps
        self.eps = eps
        self.hoisted = hoisted
        self.operator_dtype = operator_dtype
        self.hoisted_refine = hoisted_refine
        self.operator_cache = None
        shape = (channels, size, size)
        self.alpha_base = nn.Parameter(torch.full(shape, 0.1, device=device))
        self.beta_base = nn.Parameter(torch.full(shape, 0.1, device=device))
        self.alpha_time_coeff = nn.Parameter(torch.zeros(shape, device=device))
        self.beta_time_coeff = nn.Parameter(torch.zeros(shape, device=device))
        self.channel_coupling = nn.Parameter(
            0.01 * torch.eye(channels, device=device))
        self.skip_weight = nn.Parameter(torch.tensor(0.9, device=device))
        _times_buffer(self, dt, num_steps, device)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The JAX layer's init: bases 0.1, time coefficients 1e-3·N(0, 1)
        drawn from ``generator`` (a CPU one), coupling 0.01·I, skip 0.9."""
        self.alpha_base.fill_(0.1)
        self.beta_base.fill_(0.1)
        for p in (self.alpha_time_coeff, self.beta_time_coeff):
            p.copy_(torch.randn(p.shape, generator=generator) * 0.001)
        self.channel_coupling.copy_(0.01 * torch.eye(self.channels))
        self.skip_weight.fill_(0.9)

    def forward(self, u):
        u0 = u
        eps = self.eps

        def couple(u):
            return _mix(self.channel_coupling, u)

        if self.hoisted:
            u = _hoisted_steps(self, u, _layer_operators(self), after=couple)
        else:
            ts = self.ts
            for s in range(self.num_steps):
                alpha = _coeff_at(self.alpha_base, self.alpha_time_coeff,
                                  ts[s, 0], eps)
                u = sweep_x(u, alpha, self.dt / 2, self.dx, eps=eps,
                            smooth=True)
                beta = _coeff_at(self.beta_base, self.beta_time_coeff,
                                 ts[s, 1], eps)
                u = sweep_y(u, beta, self.dt, self.dx, eps=eps, smooth=True)
                alpha = _coeff_at(self.alpha_base, self.alpha_time_coeff,
                                  ts[s, 2], eps)
                u = sweep_x(u, alpha, self.dt / 2, self.dx, eps=eps,
                            smooth=True)
                u = couple(u)
        skip = torch.sigmoid(self.skip_weight)
        return skip * u0 + (1.0 - skip) * u

    def hoisted_operators(self):
        """Every sweep operator of the evolution (``_hoisted_operators``)."""
        return _hoisted_operators(self, self.dt, self.dx, smooth=True)
