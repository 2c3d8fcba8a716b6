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
  elsewhere.  K5's blocks each take a tile of whole images
  (``fused_channel.plan_tiles``), accumulate their parameter gradients over
  all steps and write them once as partials, which a second kernel of the
  same call sums over the tiles in a fixed order;
  ``fused_channel_bwd_tiled`` is the plain mirror of that structure.  Past
  the shapes one block's shared memory holds, K4 and K5 take the wide
  scheme (``csrc/fused_channel_wide.cu``, ``fused_channel.choose_scheme``):
  a block walks its tile's images one at a time and adds each adjoint's
  gated gradients to its partial row as it goes, summed over the blocks in
  the same fixed order; ``fused_channel_bwd_streamed`` is its plain
  mirror.

The clamp gate is applied as a mask, never as autograd through ``clamp``,
whose gradient passes 1 at the bounds.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels
from .fused_channel import (BWD_BUFFERS, WidePlan, _abc_nosmooth,
                            _dt_factors, _sweep_nosmooth, _sweep_y_nosmooth,
                            bind, bwd_extra_floats, check_layer_args,
                            check_workspace, choose_scheme,
                            fused_channel_diffusion_plain, launch_forward,
                            plan_tiles)
from .tridiag import _sms, _transpose_system, tridiag_solve_pcr

__all__ = ["fused_channel_diffusion", "fused_channel_fwd_res",
           "fused_channel_fwd_res_plain", "fused_channel_bwd",
           "fused_channel_bwd_plain", "fused_channel_bwd_tiled",
           "fused_channel_bwd_streamed"]

SUM_SLICES = 8          # the partial sum's interleaved slices (kSumSlices)
_BWD_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 9
                 + [ctypes.c_float] * 4 + [ctypes.c_void_p])
_WIDE_BWD_ARGTYPES = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 7
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
    out, plan = launch_forward(u, *fields, res=res, **kw)
    fused_channel_fwd_res.launches += 1
    fused_channel_fwd_res.wide_launches += isinstance(plan, WidePlan)
    return out, res


fused_channel_fwd_res.launches = 0       # either scheme
fused_channel_fwd_res.wide_launches = 0  # the wide scheme's


def fused_channel_bwd_plain(g, res, out, alpha_base, alpha_tc, beta_base,
                            beta_tc, mixing, *, dt, dx, dy, ts,
                            splitting="strang", eps=1e-6, cmax=10.0,
                            acc=None):
    """Plain PyTorch version of K5, step by step as the JAX backward kernel
    (``_make_bwd_kernel``): (grad_u, grad_alpha_base, grad_alpha_tc,
    grad_beta_base, grad_beta_tc, grad_mixing).  With ``acc`` (five tensors
    of the parameters' shapes) the parameter gradients are added to those,
    in place, each adjoint as it comes, and returned."""
    from ..pde.diffusion import _coeff_at, _mix

    dtf_x, dtf_y = _dt_factors(dt, dx, dy, splitting)
    if acc is None:
        acc = [torch.zeros_like(t) for t in (alpha_base, alpha_tc, beta_base,
                                             beta_tc, mixing)]
    grads = dict(zip(("ab", "atc", "bb", "btc"), acc))
    g_mix = acc[4]

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


def bwd_plan(B, C, H, W, sms):
    """K5's first-scheme launch plan (``fused_channel.plan_tiles``); raises
    where one image does not fit (``choose_scheme`` picks the scheme)."""
    return plan_tiles(B, C, H, W, sms, BWD_BUFFERS,
                      bwd_extra_floats(C, H, W))


def _tile_bounds(B, grid):
    """The images [first, last) of each of ``grid`` blocks: B split as
    evenly as whole images allow (csrc/channel_lines.cuh::block_images)."""
    return [(b * B // grid, (b + 1) * B // grid) for b in range(grid)]


def _sum_tile_partials(partials, slices=SUM_SLICES):
    """K5's second kernel: the sum of the tiles' partial rows in its fixed
    order — slice k sums tiles k, k + slices, … in order, then the slices
    are added in order."""
    sums = []
    for k in range(min(slices, partials.shape[0])):
        acc = partials[k]
        for part in partials[k + slices::slices]:
            acc = acc + part
        sums.append(acc)
    total = sums[0]
    for acc in sums[1:]:
        total = total + acc
    return total


def fused_channel_bwd_tiled(g, res, out, alpha_base, alpha_tc, beta_base,
                            beta_tc, mixing, *, grid, dt, dx, dy, ts,
                            splitting="strang", eps=1e-6, cmax=10.0):
    """Plain mirror of K5's reduction structure: the images split over
    ``grid`` tiles as K5's blocks take them; each tile's parameter gradients
    accumulated over all steps (the plain backward on its images) into one
    partial row (4·C·H·W field gradients, then C·C for the mixing); the rows
    summed over tiles in K5's fixed order.  The same six gradients as
    ``fused_channel_bwd_plain``."""
    fields = (alpha_base, alpha_tc, beta_base, beta_tc, mixing)
    kw = dict(dt=dt, dx=dx, dy=dy, ts=ts, splitting=splitting, eps=eps,
              cmax=cmax)
    gus, rows = [], []
    for first, last in _tile_bounds(g.shape[0], grid):
        gu, *grads = fused_channel_bwd_plain(
            g[first:last], res[:, first:last], out[first:last], *fields,
            **kw)
        gus.append(gu)
        rows.append(torch.cat([t.reshape(-1) for t in grads]))
    total = _sum_tile_partials(torch.stack(rows))
    chw = alpha_base.numel()
    grads = [total[i * chw:(i + 1) * chw].view_as(alpha_base)
             for i in range(4)]
    return (torch.cat(gus), *grads, total[4 * chw:].view_as(mixing))


def fused_channel_bwd_streamed(g, res, out, alpha_base, alpha_tc, beta_base,
                               beta_tc, mixing, *, grid, dt, dx, dy, ts,
                               splitting="strang", eps=1e-6, cmax=10.0):
    """Plain mirror of the wide K5's reduction (csrc/fused_channel_wide.cu):
    the images split over ``grid`` tiles as its blocks take them; each tile
    walks its images one at a time, adding each adjoint's gated field
    gradients and each step's mixing gradient to one partial row (4·C·H·W,
    then C·C) as they come; the rows summed over tiles in K5's fixed order.
    The same six gradients as ``fused_channel_bwd_plain``."""
    fields = (alpha_base, alpha_tc, beta_base, beta_tc, mixing)
    kw = dict(dt=dt, dx=dx, dy=dy, ts=ts, splitting=splitting, eps=eps,
              cmax=cmax)
    gus, rows = [], []
    for first, last in _tile_bounds(g.shape[0], grid):
        acc = [torch.zeros_like(t) for t in fields]
        for b in range(first, last):
            gus.append(fused_channel_bwd_plain(
                g[b:b + 1], res[:, b:b + 1], out[b:b + 1], *fields, acc=acc,
                **kw)[0])
        rows.append(torch.cat([t.reshape(-1) for t in acc]))
    total = _sum_tile_partials(torch.stack(rows))
    chw = alpha_base.numel()
    grads = [total[i * chw:(i + 1) * chw].view_as(alpha_base)
             for i in range(4)]
    return (torch.cat(gus), *grads, total[4 * chw:].view_as(mixing))


def fused_channel_bwd(g, res, out, alpha_base, alpha_tc, beta_base, beta_tc,
                      mixing, *, dt, dx, dy, ts, splitting="strang",
                      eps=1e-6, cmax=10.0):
    """The six gradients: K5 on a CUDA tensor, the plain version on a CPU
    tensor.  K5's one C call, by the scheme ``choose_scheme`` picks, writes
    each block's partial parameter gradients into a scratch and sums them
    over blocks in a fixed order."""
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
    gu = torch.empty_like(g)
    grads = [torch.empty_like(f) for f in fields]
    if B == 0:
        return (gu, *(t.zero_() for t in grads))
    plan = choose_scheme(B, C, H, W, _sms(g.device), backward=True)
    wide = isinstance(plan, WidePlan)
    row = 4 * C * H * W + C * C
    if wide:
        check_workspace("fused_channel_wide_backward",
                        4 * plan.grid * (plan.workspace + row), g.device)
    partials = torch.empty((plan.grid, row), dtype=g.dtype, device=g.device)
    dtf_x, dtf_y = _dt_factors(dt, dx, dy, splitting)
    ptrs = (g.data_ptr(), res.data_ptr(), out.data_ptr(),
            *(f.data_ptr() for f in fields), ts.data_ptr(), gu.data_ptr(),
            *(t.data_ptr() for t in grads), partials.data_ptr())
    tail = (S, int(splitting == "strang"), dtf_x, dtf_y, eps, cmax,
            kernels.stream_handle(g.device))
    if wide:
        ws = torch.empty(plan.grid * plan.workspace, dtype=g.dtype,
                         device=g.device)
        fn = bind("fused_channel_wide", "fused_channel_wide_backward",
                  _WIDE_BWD_ARGTYPES, "fused_channel_wide_layout",
                  (C, H, W), plan)
        with torch.cuda.device(g.device):
            code = fn(*ptrs, ws.data_ptr(), B, C, H, W, plan.grid, *tail)
    else:
        fn = bind("fused_channel_vjp", "fused_channel_diffusion_bwd",
                  _BWD_ARGTYPES, "fused_channel_bwd_layout", (C, H, W), plan)
        with torch.cuda.device(g.device):
            code = fn(*ptrs, B, C, H, W, plan.grid, plan.nbuf, plan.staged,
                      *tail)
    kernels.raise_on_error("fused_channel_bwd" + ("_wide" if wide else ""),
                           code)
    fused_channel_bwd.launches += 1
    fused_channel_bwd.wide_launches += wide
    return (gu, *grads)


fused_channel_bwd.launches = 0       # either scheme
fused_channel_bwd.wide_launches = 0  # the wide scheme's


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
