"""The trainable fused grayscale diffusion: K7 (forward with residuals) and K8
(backward), and their plain versions.

Counterpart of ``cnn_pde_tpu/ops/pallas_fused_adi_vjp.py::
fused_grayscale_diffusion``.  ``fused_grayscale_diffusion`` is a
``torch.autograd.Function`` over a whole GrayscaleDiffusion layer:

* forward: the layer's S Strang steps, writing each step's input state to a
  (S, B, H, W) residual tensor — K7 (``csrc/fused_grayscale.cu`` with its
  residual pointer set), or K6's plain version collecting the same states;
* backward: the steps in reverse.  Each recomputes x1 and x2 from its
  residual (x3 is the next residual, or the layer's output at the last
  step), then applies the sweep adjoints last sweep first: the transposed
  solve (``_sweepT_smooth``), ``_grad_r`` folded onto the Neumann rows and
  summed over the batch, the adjoint of ``smooth3`` along the sweep axis
  (``_smooth3_adjoint``), the one-sided clamp gate raw > eps and the weight
  t on the time coefficients.  K8 (``csrc/fused_grayscale_vjp.cu``) on the
  card, ``fused_grayscale_bwd_plain`` elsewhere.  K8's blocks each take a
  tile of whole images (``fused_grayscale.plan_grayscale``), accumulate
  their field gradients over all steps and write them once as partials,
  which a last kernel of the same call sums over the tiles in a fixed
  order; ``fused_grayscale_bwd_tiled`` is the plain mirror of that
  structure.  Past 64 pixels a side, K7 and K8 take the wide scheme
  (``csrc/fused_grayscale_wide.cu``, ``fused_grayscale.choose_gray_scheme``):
  a block walks its tile's images one at a time and adds each adjoint's
  smoothed, gated field gradients of each image to its partial row as it
  goes, summed over the blocks in the same fixed order;
  ``fused_grayscale_bwd_tiled(per_image=True)`` is its plain mirror.

The clamp gate is applied as a mask, never as autograd through
``clamp_min``, whose gradient passes 1 at the bound.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels
from .fused_channel import _dt_factors
from .fused_channel_vjp import _grad_r, _sum_tile_partials, _tile_bounds
from .fused_grayscale import (GrayWidePlan, _abc_smooth, _coeff,
                              _sweep_smooth, _sweep_y_smooth, bind,
                              check_layer_args, check_workspace,
                              choose_gray_scheme, factor_table,
                              fused_grayscale_diffusion_plain, launch_forward,
                              partial_floats, wide_bytes)
from .tridiag import _sms, _transpose_system, tridiag_solve_pcr

__all__ = ["fused_grayscale_diffusion", "fused_grayscale_fwd_res",
           "fused_grayscale_fwd_res_plain", "fused_grayscale_bwd",
           "fused_grayscale_bwd_plain", "fused_grayscale_bwd_tiled"]

_BWD_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
                 + [ctypes.c_float] * 3 + [ctypes.c_void_p])
_WIDE_BWD_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 5
                      + [ctypes.c_float] * 3 + [ctypes.c_void_p])


def _sweepT_smooth(lines, field, dtfac, eps):
    """λ = T⁻ᵀ·lines along the last axis, T the smoothed sweep system of
    the clamped field (``_sweepT_rows``)."""
    return tridiag_solve_pcr(
        *_transpose_system(*_abc_smooth(field, dtfac, eps)), lines)


def _smooth3_adjoint(g):
    """Adjoint of ``smooth3`` along the last axis, as the TPU kernel writes
    it: the 3-tap sum with zeros outside the line, over 3, plus one more
    third of g on the two edge elements (the replicate pad)."""
    zero = torch.zeros_like(g[..., :1])
    left = torch.cat([zero, g[..., :-1]], dim=-1)
    right = torch.cat([g[..., 1:], zero], dim=-1)
    k = 1.0 / 3.0
    gsm = (left + g + right) * k
    n = g.shape[-1]
    idx = torch.arange(n, device=g.device)
    return gsm + torch.where((idx == 0) | (idx == n - 1), g * k, 0.0)


def fused_grayscale_fwd_res_plain(u, alpha_base, alpha_tc, beta_base,
                                  beta_tc, *, dt, dx, dy, ts, eps=1e-6):
    """Plain PyTorch version of K7: (out, residuals (S, B, H, W))."""
    res = []
    out = fused_grayscale_diffusion_plain(
        u, alpha_base, alpha_tc, beta_base, beta_tc, dt=dt, dx=dx, dy=dy,
        ts=ts, eps=eps, residuals=res)
    return out, torch.stack(res)


def fused_grayscale_fwd_res(u, alpha_base, alpha_tc, beta_base, beta_tc, *,
                            dt, dx, dy, ts, eps=1e-6):
    """(out, residuals): K7 on a CUDA tensor, the plain version on a CPU
    tensor."""
    fields = (alpha_base, alpha_tc, beta_base, beta_tc)
    kw = dict(dt=dt, dx=dx, dy=dy, ts=ts, eps=eps)
    if not kernels.use_kernel(u):
        return fused_grayscale_fwd_res_plain(u, *fields, **kw)
    check_layer_args("fused_grayscale_fwd_res", u, *fields, ts)
    res = torch.empty((ts.shape[0], *u.shape), dtype=u.dtype,
                      device=u.device)
    out, plan = launch_forward(u, *fields, res=res, **kw)
    fused_grayscale_fwd_res.launches += 1
    fused_grayscale_fwd_res.wide_launches += isinstance(plan, GrayWidePlan)
    return out, res


fused_grayscale_fwd_res.launches = 0       # either scheme
fused_grayscale_fwd_res.wide_launches = 0  # the wide scheme's


def fused_grayscale_bwd_plain(g, res, out, alpha_base, alpha_tc, beta_base,
                              beta_tc, *, dt, dx, dy, ts, eps=1e-6, acc=None):
    """Plain PyTorch version of K8, step by step as the JAX backward kernel
    (``_make_bwd_kernel``): (grad_u, grad_alpha_base, grad_alpha_tc,
    grad_beta_base, grad_beta_tc).  With ``acc`` (four tensors of the
    fields' shape) the field gradients are added to those, in place, each
    adjoint as it comes, and returned."""
    dtf_x, dtf_y = _dt_factors(dt, dx, dy, "strang")
    if acc is None:
        acc = [torch.zeros_like(alpha_base) for _ in range(4)]
    grads = dict(zip(("ab", "atc", "bb", "btc"), acc))

    def gate(base, tc, t, gfield, kb, kt):
        mask = ((base + tc * t) > eps).to(gfield.dtype)
        grads[kb] += mask * gfield
        grads[kt] += mask * gfield * t

    def x_adjoint(cot, x_out, t):
        lam = _sweepT_smooth(cot, _coeff(alpha_base, alpha_tc, t, eps),
                             dtf_x, eps)
        gfield = _grad_r(lam, x_out).sum(dim=0) * dtf_x
        gate(alpha_base, alpha_tc, t, _smooth3_adjoint(gfield), "ab", "atc")
        return lam

    def y_adjoint(cot, x_out, t):
        beta_t = _coeff(beta_base, beta_tc, t, eps).transpose(-1, -2)
        lam_t = _sweepT_smooth(cot.transpose(-1, -2), beta_t, dtf_y, eps)
        gfield_t = _grad_r(lam_t, x_out.transpose(-1, -2)).sum(dim=0) * dtf_y
        gate(beta_base, beta_tc, t,
             _smooth3_adjoint(gfield_t).transpose(-1, -2), "bb", "btc")
        return lam_t.transpose(-1, -2)

    cot = g
    S = ts.shape[0]
    for s in reversed(range(S)):
        x1 = _sweep_smooth(res[s], _coeff(alpha_base, alpha_tc, ts[s, 0], eps),
                           dtf_x, eps)
        x2 = _sweep_y_smooth(x1, _coeff(beta_base, beta_tc, ts[s, 1], eps),
                             dtf_y, eps)
        x3 = out if s == S - 1 else res[s + 1]
        cot = x_adjoint(cot, x3, ts[s, 2])
        cot = y_adjoint(cot, x2, ts[s, 1])
        cot = x_adjoint(cot, x1, ts[s, 0])
    return cot, grads["ab"], grads["atc"], grads["bb"], grads["btc"]


def fused_grayscale_bwd_tiled(g, res, out, alpha_base, alpha_tc,
                              beta_base, beta_tc, *, grid, dt, dx, dy, ts,
                              eps=1e-6, per_image=False):
    """Plain mirror of K8's reduction structure: the images split over
    ``grid`` tiles as K8's blocks take them; each tile's field gradients
    accumulated over all steps (the plain backward on its images) into one
    partial row (4·H·W); the rows summed over tiles in K8's fixed order
    (``fused_channel_vjp._sum_tile_partials``).  With ``per_image``, the
    wide K8's order (csrc/fused_grayscale_wide.cu): each tile walks its
    images one at a time, adding each adjoint's smoothed, gated gradients
    of one image to its row as they come.  The same five gradients as
    ``fused_grayscale_bwd_plain``."""
    fields = (alpha_base, alpha_tc, beta_base, beta_tc)
    kw = dict(dt=dt, dx=dx, dy=dy, ts=ts, eps=eps)
    gus, rows = [], []
    for first, last in _tile_bounds(g.shape[0], grid):
        if per_image:
            acc = [torch.zeros_like(alpha_base) for _ in fields]
            for b in range(first, last):
                gus.append(fused_grayscale_bwd_plain(
                    g[b:b + 1], res[:, b:b + 1], out[b:b + 1], *fields,
                    acc=acc, **kw)[0])
        else:
            gu, *acc = fused_grayscale_bwd_plain(
                g[first:last], res[:, first:last], out[first:last], *fields,
                **kw)
            gus.append(gu)
        rows.append(torch.cat([t.reshape(-1) for t in acc]))
    total = _sum_tile_partials(torch.stack(rows))
    return (torch.cat(gus),
            *total.view(4, *alpha_base.shape).unbind(0))


def fused_grayscale_bwd(g, res, out, alpha_base, alpha_tc, beta_base,
                        beta_tc, *, dt, dx, dy, ts, eps=1e-6):
    """The five gradients: K8 on a CUDA tensor, the plain version on a CPU
    tensor.  K8's one C call, by the scheme ``choose_gray_scheme`` picks,
    makes the factor table, writes each block's partial field gradients
    into a scratch and sums them over blocks in a fixed order."""
    fields = (alpha_base, alpha_tc, beta_base, beta_tc)
    kw = dict(dt=dt, dx=dx, dy=dy, ts=ts, eps=eps)
    if not kernels.use_kernel(g):
        return fused_grayscale_bwd_plain(g, res, out, *fields, **kw)
    check_layer_args("fused_grayscale_bwd", g, *fields, ts)
    B, H, W = g.shape
    S = ts.shape[0]
    if tuple(res.shape) != (S, B, H, W) or out.shape != g.shape:
        raise ValueError(f"fused_grayscale_bwd: residuals {tuple(res.shape)} "
                         f"and output {tuple(out.shape)} do not match g "
                         f"{tuple(g.shape)} over {S} steps")
    kernels.check_float32("fused_grayscale_bwd", g.device, res=res, out=out)
    gu = torch.empty_like(g)
    grads = [torch.empty_like(f) for f in fields]
    if B == 0:
        return (gu, *(t.zero_() for t in grads))
    plan = choose_gray_scheme(B, H, W, _sms(g.device), backward=True)
    wide = isinstance(plan, GrayWidePlan)
    if wide:
        check_workspace("fused_grayscale_wide_backward",
                        wide_bytes(plan, H, W, S), g.device)
    table = factor_table(plan, S, g.device)
    partials = torch.empty((plan.grid, partial_floats(H, W)), dtype=g.dtype,
                           device=g.device)
    dtf_x, dtf_y = _dt_factors(dt, dx, dy, "strang")
    ptrs = (g.data_ptr(), res.data_ptr(), out.data_ptr(),
            *(f.data_ptr() for f in fields), ts.data_ptr(), gu.data_ptr(),
            *(t.data_ptr() for t in grads), table.data_ptr(),
            partials.data_ptr())
    tail = (dtf_x, dtf_y, eps, kernels.stream_handle(g.device))
    if wide:
        ws = torch.empty(plan.grid * plan.workspace, dtype=g.dtype,
                         device=g.device)
        fn = bind("fused_grayscale_wide", "fused_grayscale_wide_backward",
                  _WIDE_BWD_ARGTYPES, "fused_grayscale_wide_layout", (H, W),
                  plan)
        with torch.cuda.device(g.device):
            code = fn(*ptrs, ws.data_ptr(), B, H, W, plan.grid, S, *tail)
    else:
        fn = bind("fused_grayscale_vjp", "fused_grayscale_diffusion_bwd",
                  _BWD_ARGTYPES, "fused_grayscale_bwd_layout", (H, W), plan)
        with torch.cuda.device(g.device):
            code = fn(*ptrs, B, H, W, plan.grid, S, *tail)
    kernels.raise_on_error("fused_grayscale_bwd" + ("_wide" if wide else ""),
                           code)
    fused_grayscale_bwd.launches += 1
    fused_grayscale_bwd.wide_launches += wide
    return (gu, *grads)


fused_grayscale_bwd.launches = 0       # either scheme
fused_grayscale_bwd.wide_launches = 0  # the wide scheme's


class _FusedGrayscaleDiffusion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, alpha_base, alpha_tc, beta_base, beta_tc, ts, kw):
        ctx.kernel = kernels.use_kernel(u)
        fields = (alpha_base, alpha_tc, beta_base, beta_tc)
        if ctx.kernel:
            out, res = fused_grayscale_fwd_res(u, *fields, ts=ts, **kw)
        else:
            out, res = fused_grayscale_fwd_res_plain(u, *fields, ts=ts, **kw)
        ctx.kw = kw
        ctx.save_for_backward(res, out, *fields, ts)
        return out

    @staticmethod
    def backward(ctx, g):
        res, out, *fields, ts = ctx.saved_tensors
        if ctx.kernel:
            grads = fused_grayscale_bwd(g.contiguous(), res, out, *fields,
                                        ts=ts, **ctx.kw)
        else:
            grads = fused_grayscale_bwd_plain(g, res, out, *fields, ts=ts,
                                              **ctx.kw)
        return (*grads, None, None)


def fused_grayscale_diffusion(u, alpha_base, alpha_tc, beta_base, beta_tc, *,
                              dt, dx, dy, ts, eps=1e-6):
    """A whole GrayscaleDiffusion layer, differentiable in u and all four
    fields: K7 forward and K8 backward on a CUDA tensor, their plain versions
    on a CPU tensor (or inside ``plain_versions()``).  u (B, H, W), fields
    (H, W), ts (num_steps, 3)."""
    kw = dict(dt=dt, dx=dx, dy=dy, eps=eps)
    return _FusedGrayscaleDiffusion.apply(u, alpha_base, alpha_tc, beta_base,
                                          beta_tc, ts, kw)
