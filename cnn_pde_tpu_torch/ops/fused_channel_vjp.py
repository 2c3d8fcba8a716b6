"""The trainable fused channel diffusion: K4 (forward with residuals) and K5
(backward), and their plain versions.

Counterpart of ``cnn_pde_tpu/ops/pallas_fused_channel_vjp.py::
fused_channel_diffusion``.  ``fused_channel_diffusion`` is a
``torch.autograd.Function`` over a whole MixedChannelDiffusion layer:

* forward: the layer's S steps, writing each step's input state to a
  (S, B, C, H, W) residual tensor — K4 (``csrc/fused_channel.cu`` with its
  residual pointer set), or K2's plain version collecting the same states;
* backward: the steps in reverse.  Each recomputes u_mix, x1 and (Strang)
  x2 from its residual, applies the sweep adjoints last sweep first — the
  transposed solve (``_sweepT_nosmooth``), ``_grad_r`` folded onto the
  Neumann rows, the strict clamp gate eps < raw < cmax and the weight t on
  the time coefficients — then the mixing adjoint
  grad_mix[k, c] += Σ cot[:, k]·u_s[:, c], cot ← mixᵀ·cot.  K5
  (``csrc/fused_channel_vjp.cu``) on the card, ``fused_channel_bwd_plain``
  elsewhere.

The clamp gate is applied as a mask, never as autograd through ``clamp``,
whose gradient passes 1 at the bounds.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels
from .fused_channel import (MAX_SMEM, _abc_nosmooth, _dt_factors,
                            _sweep_nosmooth, _sweep_y_nosmooth,
                            check_layer_args, fused_channel_diffusion_plain,
                            launch_forward)
from .tridiag import _transpose_system, tridiag_solve_pcr

__all__ = ["fused_channel_diffusion", "fused_channel_fwd_res",
           "fused_channel_fwd_res_plain", "fused_channel_bwd",
           "fused_channel_bwd_plain", "TILE_B_BWD"]

TILE_B_BWD = 2          # images a K5 block: 192 threads, 101.6 KB at 3×32×32
_BWD_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 7
                 + [ctypes.c_float] * 4 + [ctypes.c_void_p])


def _sweepT_nosmooth(lines, field, dtfac, eps):
    """λ = T⁻ᵀ·lines along the last axis, T the sweep system of the raw
    field (``_abc_nosmooth``), transposed by ``_transpose_system``."""
    return tridiag_solve_pcr(
        *_transpose_system(*_abc_nosmooth(field, dtfac, eps)), lines)


def _grad_r(lam, x_out):
    """d(loss)/dr along the last axis from the sweep's adjoint pair: the
    band cotangents gb = −λx, ga[i] = −λ[i]x[i−1], gc[i] = −λ[i]x[i+1]
    folded onto r: 2gb − ga − gc inside the line, gb − gc on the first row
    and gb − ga on the last (the Neumann rows b = 1 + r)."""
    zero = torch.zeros_like(x_out[..., :1])
    gb = -lam * x_out
    ga = torch.cat([zero, -lam[..., 1:] * x_out[..., :-1]], dim=-1)
    gc = torch.cat([-lam[..., :-1] * x_out[..., 1:], zero], dim=-1)
    n = x_out.shape[-1]
    idx = torch.arange(n, device=x_out.device)
    return torch.where(idx == 0, gb - gc,
                       torch.where(idx == n - 1, gb - ga,
                                   2.0 * gb - ga - gc))


def fused_channel_fwd_res_plain(u, alpha_base, alpha_tc, beta_base, beta_tc,
                                mixing, *, dt, dx, dy, ts, splitting="strang",
                                eps=1e-6, cmax=10.0):
    """Plain PyTorch version of K4: (out, residuals (S, B, C, H, W))."""
    res = []
    out = fused_channel_diffusion_plain(
        u, alpha_base, alpha_tc, beta_base, beta_tc, mixing, dt=dt, dx=dx,
        dy=dy, ts=ts, splitting=splitting, eps=eps, cmax=cmax, residuals=res)
    return out, torch.stack(res)


def fused_channel_fwd_res(u, alpha_base, alpha_tc, beta_base, beta_tc,
                          mixing, *, dt, dx, dy, ts, splitting="strang",
                          eps=1e-6, cmax=10.0):
    """(out, residuals): K4 on a CUDA tensor, the plain version on a CPU
    tensor."""
    fields = (alpha_base, alpha_tc, beta_base, beta_tc, mixing)
    kw = dict(dt=dt, dx=dx, dy=dy, ts=ts, splitting=splitting, eps=eps,
              cmax=cmax)
    if not kernels.use_kernel(u):
        return fused_channel_fwd_res_plain(u, *fields, **kw)
    check_layer_args("fused_channel_fwd_res", u, *fields, ts, splitting)
    res = torch.empty((ts.shape[0], *u.shape), dtype=u.dtype,
                      device=u.device)
    out = launch_forward(u, *fields, res=res, **kw)
    fused_channel_fwd_res.launches += 1
    return out, res


fused_channel_fwd_res.launches = 0


def fused_channel_bwd_plain(g, res, out, alpha_base, alpha_tc, beta_base,
                            beta_tc, mixing, *, dt, dx, dy, ts,
                            splitting="strang", eps=1e-6, cmax=10.0):
    """Plain PyTorch version of K5, step by step as the JAX backward kernel
    (``_make_bwd_kernel``): (grad_u, grad_alpha_base, grad_alpha_tc,
    grad_beta_base, grad_beta_tc, grad_mixing)."""
    from ..pde.diffusion import _coeff_at, _mix

    dtf_x, dtf_y = _dt_factors(dt, dx, dy, splitting)
    grads = {k: torch.zeros_like(alpha_base) for k in ("ab", "atc", "bb",
                                                        "btc")}
    g_mix = torch.zeros_like(mixing)

    def gate(base, tc, t, gfield, kb, kt):
        raw = base + tc * t
        mask = ((raw > eps) & (raw < cmax)).to(gfield.dtype)
        grads[kb] += mask * gfield
        grads[kt] += mask * gfield * t

    def x_adjoint(cot, x_out, t):
        alpha = _coeff_at(alpha_base, alpha_tc, t, eps, cmax)
        lam = _sweepT_nosmooth(cot, alpha, dtf_x, eps)
        gate(alpha_base, alpha_tc, t,
             _grad_r(lam, x_out).sum(dim=0) * dtf_x, "ab", "atc")
        return lam

    def y_adjoint(cot, x_out, t):
        beta = _coeff_at(beta_base, beta_tc, t, eps, cmax)
        lam_t = _sweepT_nosmooth(cot.transpose(-1, -2),
                                 beta.transpose(-1, -2), dtf_y, eps)
        gfield = (_grad_r(lam_t, x_out.transpose(-1, -2)).sum(dim=0)
                  * dtf_y).transpose(-1, -2)
        gate(beta_base, beta_tc, t, gfield, "bb", "btc")
        return lam_t.transpose(-1, -2)

    cot = g
    S = ts.shape[0]
    for s in reversed(range(S)):
        u_s = res[s]
        out_s = out if s == S - 1 else res[s + 1]
        x1 = _sweep_nosmooth(_mix(mixing, u_s),
                             _coeff_at(alpha_base, alpha_tc, ts[s, 0], eps,
                                       cmax), dtf_x, eps)
        if splitting == "strang":
            x2 = _sweep_y_nosmooth(
                x1, _coeff_at(beta_base, beta_tc, ts[s, 1], eps, cmax),
                dtf_y, eps)
            cot = x_adjoint(cot, out_s, ts[s, 2])
            cot = y_adjoint(cot, x2, ts[s, 1])
        else:
            cot = y_adjoint(cot, out_s, ts[s, 1])
        cot = x_adjoint(cot, x1, ts[s, 0])
        g_mix += (cot[:, :, None] * u_s[:, None]).sum(dim=(0, 3, 4))
        cot = _mix(mixing.t(), cot)
    return cot, grads["ab"], grads["atc"], grads["bb"], grads["btc"], g_mix


def _bwd_launch_shape(C, H, W):
    threads = -(-TILE_B_BWD * C * max(H, W) // 32) * 32
    smem = 4 * (4 * TILE_B_BWD * C * H * (W + 1) + threads // 32 * C * C)
    return threads, smem


def fused_channel_bwd(g, res, out, alpha_base, alpha_tc, beta_base, beta_tc,
                      mixing, *, dt, dx, dy, ts, splitting="strang",
                      eps=1e-6, cmax=10.0):
    """The six gradients: K5 on a CUDA tensor, the plain version on a CPU
    tensor.  K5 writes one partial gradient per block; they are summed
    here, in a fixed order."""
    fields = (alpha_base, alpha_tc, beta_base, beta_tc, mixing)
    kw = dict(dt=dt, dx=dx, dy=dy, ts=ts, splitting=splitting, eps=eps,
              cmax=cmax)
    if not kernels.use_kernel(g):
        return fused_channel_bwd_plain(g, res, out, *fields, **kw)
    check_layer_args("fused_channel_bwd", g, *fields, ts, splitting)
    B, C, H, W = g.shape
    S = ts.shape[0]
    if tuple(res.shape) != (S, B, C, H, W) or out.shape != g.shape:
        raise ValueError(f"fused_channel_bwd: residuals {tuple(res.shape)} "
                         f"and output {tuple(out.shape)} do not match g "
                         f"{tuple(g.shape)} over {S} steps")
    kernels.check_float32("fused_channel_bwd", g.device, res=res, out=out)
    threads, smem = _bwd_launch_shape(C, H, W)
    if threads > 1024 or smem > MAX_SMEM:
        raise ValueError(f"{TILE_B_BWD} images of {(C, H, W)} need "
                         f"{threads} threads and {smem} bytes of shared "
                         f"memory a block (limits 1024 and {MAX_SMEM})")
    G = -(-B // TILE_B_BWD)
    gu = torch.empty_like(g)
    partials = [torch.empty((G, C, H, W), dtype=g.dtype, device=g.device)
                for _ in range(4)]
    g_mix = torch.empty((G, C, C), dtype=g.dtype, device=g.device)
    if B == 0:
        return (gu, *(torch.zeros_like(f) for f in fields))
    dtf_x, dtf_y = _dt_factors(dt, dx, dy, splitting)
    fn = kernels.function("fused_channel_vjp", "fused_channel_diffusion_bwd",
                          _BWD_ARGTYPES)
    with torch.cuda.device(g.device):
        code = fn(g.data_ptr(), res.data_ptr(), out.data_ptr(),
                  *(f.data_ptr() for f in fields), ts.data_ptr(),
                  gu.data_ptr(), *(p.data_ptr() for p in partials),
                  g_mix.data_ptr(), B, C, H, W, TILE_B_BWD, S,
                  int(splitting == "strang"), dtf_x, dtf_y, eps, cmax,
                  kernels.stream_handle(g.device))
    kernels.raise_on_error("fused_channel_bwd", code)
    fused_channel_bwd.launches += 1
    return (gu, *(p.sum(dim=0) for p in partials), g_mix.sum(dim=0))


fused_channel_bwd.launches = 0


class _FusedChannelDiffusion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, alpha_base, alpha_tc, beta_base, beta_tc, mixing,
                ts, kw):
        ctx.kernel = kernels.use_kernel(u)
        if ctx.kernel:
            out, res = fused_channel_fwd_res(u, alpha_base, alpha_tc,
                                             beta_base, beta_tc, mixing,
                                             ts=ts, **kw)
        else:
            out, res = fused_channel_fwd_res_plain(
                u, alpha_base, alpha_tc, beta_base, beta_tc, mixing, ts=ts,
                **kw)
        ctx.kw = kw
        ctx.save_for_backward(res, out, alpha_base, alpha_tc, beta_base,
                              beta_tc, mixing, ts)
        return out

    @staticmethod
    def backward(ctx, g):
        res, out, *fields, ts = ctx.saved_tensors
        if ctx.kernel:
            grads = fused_channel_bwd(g.contiguous(), res, out, *fields,
                                      ts=ts, **ctx.kw)
        else:
            grads = fused_channel_bwd_plain(g, res, out, *fields, ts=ts,
                                            **ctx.kw)
        return (*grads, None, None)


def fused_channel_diffusion(u, alpha_base, alpha_tc, beta_base, beta_tc,
                            mixing, *, dt, dx, dy, ts, splitting="strang",
                            eps=1e-6, cmax=10.0):
    """A whole MixedChannelDiffusion layer, differentiable in u and all five
    parameters: K4 forward and K5 backward on a CUDA tensor, their plain
    versions on a CPU tensor (or inside ``plain_versions()``).  u
    (B, C, H, W), fields (C, H, W), mixing (C, C), ts (num_steps, 3)."""
    if splitting not in ("strang", "lie"):
        raise ValueError(f"splitting must be 'strang' or 'lie': {splitting!r}")
    kw = dict(dt=dt, dx=dx, dy=dy, splitting=splitting, eps=eps, cmax=cmax)
    return _FusedChannelDiffusion.apply(u, alpha_base, alpha_tc, beta_base,
                                        beta_tc, mixing, ts, kw)
