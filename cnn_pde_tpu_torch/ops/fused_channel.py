"""K2: a whole MixedChannelDiffusion eval forward in one launch, and its plain
version.  The same kernel with a residual output is K4, the trainable
forward (``ops/fused_channel_vjp.py``).

Counterpart of ``cnn_pde_tpu/ops/pallas_fused_channel.py::
fused_channel_diffusion_fwd``.  The kernel is ``csrc/fused_channel.cu``: one
block keeps ``TILE_B`` images' (C, H, W) state in shared memory for every
step.  Per step: channel mixing, the coefficient fields at the step's
substep times clamped to [eps, cmax], then x(dt/2), y(dt, or dt/2 for Lie)
and, for Strang, x(dt/2) again.  The plain version runs the same steps with
the TPU kernel's own sweep (``_abc_nosmooth`` + PCR, as ``_pcr_rows`` does);
the kernel solves each line by Thomas, which is the same system.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels
from .tridiag import tridiag_solve_pcr

__all__ = ["fused_channel_diffusion_fwd", "fused_channel_diffusion_plain"]

TILE_B = 4              # images a block: 384 threads, 50.7 KB at 3×32×32
MAX_C = 8               # per-pixel mixing registers (csrc/fused_channel.cu)
MAX_N = 64              # per-thread c* array
MAX_SMEM = 232_448      # bytes a block may use on Hopper
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
             + [ctypes.c_float] * 4 + [ctypes.c_void_p])


def _abc_nosmooth(field, dtfac, eps):
    """The sweep system along the last axis for a raw coefficient field:
    a = c = -r, b = 1 + 2r with Neumann edge rows 1 + r, plus eps on b;
    a[0] and c[n-1] zeroed (outside the matrix)."""
    r = field * dtfac
    n = r.shape[-1]
    idx = torch.arange(n, device=r.device)
    b = torch.where((idx == 0) | (idx == n - 1), 1.0 + r, 1.0 + 2.0 * r) + eps
    a = torch.where(idx == 0, 0.0, -r)
    c = torch.where(idx == n - 1, 0.0, -r)
    return a, b, c


def _sweep_nosmooth(u, field, dtfac, eps):
    return tridiag_solve_pcr(*_abc_nosmooth(field, dtfac, eps), u)


def _dt_factors(dt, dx, dy, splitting):
    dtf_y = dt if splitting == "strang" else dt / 2
    return dt / 2 / (dx * dx), dtf_y / (dy * dy)


def _sweep_y_nosmooth(u, field, dtfac, eps):
    return _sweep_nosmooth(u.transpose(-1, -2), field.transpose(-1, -2),
                           dtfac, eps).transpose(-1, -2)


def fused_channel_diffusion_plain(u, alpha_base, alpha_tc, beta_base,
                                  beta_tc, mixing, *, dt, dx, dy, ts,
                                  splitting="strang", eps=1e-6, cmax=10.0,
                                  residuals=None):
    """Plain PyTorch version of K2: u (B, C, H, W), fields (C, H, W),
    mixing (C, C), ts (num_steps, 3) float32.  With a list as
    ``residuals`` (K4's plain version) each step's input state is appended
    to it."""
    from ..pde.diffusion import _coeff_at, _mix

    dtf_x, dtf_y = _dt_factors(dt, dx, dy, splitting)
    for s in range(ts.shape[0]):
        if residuals is not None:
            residuals.append(u)
        u = _mix(mixing, u)
        alpha = _coeff_at(alpha_base, alpha_tc, ts[s, 0], eps, cmax)
        u = _sweep_nosmooth(u, alpha, dtf_x, eps)
        beta = _coeff_at(beta_base, beta_tc, ts[s, 1], eps, cmax)
        u = _sweep_y_nosmooth(u, beta, dtf_y, eps)
        if splitting == "strang":
            alpha = _coeff_at(alpha_base, alpha_tc, ts[s, 2], eps, cmax)
            u = _sweep_nosmooth(u, alpha, dtf_x, eps)
    return u


def check_layer_args(name, u, alpha_base, alpha_tc, beta_base, beta_tc,
                     mixing, ts, splitting):
    """Raise on anything the fused kernels (K2, K4, K5) do not take."""
    if splitting not in ("strang", "lie"):
        raise ValueError(f"splitting must be 'strang' or 'lie': {splitting!r}")
    if u.ndim != 4:
        raise ValueError(f"{name}: u must be (B, C, H, W), got "
                         f"{tuple(u.shape)}")
    _, C, H, W = u.shape
    for key, t in (("alpha_base", alpha_base), ("alpha_tc", alpha_tc),
                   ("beta_base", beta_base), ("beta_tc", beta_tc)):
        if tuple(t.shape) != (C, H, W):
            raise ValueError(f"{name}: {key} must be {(C, H, W)}, got "
                             f"{tuple(t.shape)}")
    if tuple(mixing.shape) != (C, C):
        raise ValueError(f"{name}: mixing must be {(C, C)}, got "
                         f"{tuple(mixing.shape)}")
    if ts.ndim != 2 or ts.shape[1] != 3:
        raise ValueError(f"{name}: ts must be (num_steps, 3), got "
                         f"{tuple(ts.shape)}")
    kernels.check_float32(name, u.device, u=u, alpha_base=alpha_base,
                          alpha_tc=alpha_tc, beta_base=beta_base,
                          beta_tc=beta_tc, mixing=mixing, ts=ts)
    if C > MAX_C or not (1 <= H <= MAX_N and 1 <= W <= MAX_N):
        raise ValueError(f"{name}: C <= {MAX_C} and H, W in [1, {MAX_N}] "
                         f"required, got C={C}, H={H}, W={W}")


def launch_forward(u, alpha_base, alpha_tc, beta_base, beta_tc, mixing, *,
                   dt, dx, dy, ts, splitting, eps, cmax, res=None):
    """Launch csrc/fused_channel.cu on checked CUDA tensors: K2, or K4 when
    ``res`` is a (num_steps, B, C, H, W) tensor to hold the residuals."""
    B, C, H, W = u.shape
    threads = TILE_B * C * max(H, W)
    smem = 4 * TILE_B * C * H * (W + 1)
    if threads > 1024 or smem > MAX_SMEM:
        raise ValueError(f"{TILE_B} images of {(C, H, W)} need {threads} "
                         f"threads and {smem} bytes of shared memory a block "
                         f"(limits 1024 and {MAX_SMEM})")
    out = torch.empty_like(u)
    if B == 0:
        return out
    dtf_x, dtf_y = _dt_factors(dt, dx, dy, splitting)
    fn = kernels.function("fused_channel", "fused_channel_diffusion",
                          _ARGTYPES)
    with torch.cuda.device(u.device):
        code = fn(u.data_ptr(), out.data_ptr(), alpha_base.data_ptr(),
                  alpha_tc.data_ptr(), beta_base.data_ptr(),
                  beta_tc.data_ptr(), mixing.data_ptr(), ts.data_ptr(),
                  None if res is None else res.data_ptr(),
                  B, C, H, W, TILE_B, ts.shape[0],
                  int(splitting == "strang"), dtf_x, dtf_y, eps, cmax,
                  kernels.stream_handle(u.device))
    kernels.raise_on_error(
        "fused_channel_diffusion" + ("_fwd" if res is None else "_res"), code)
    return out


def fused_channel_diffusion_fwd(u, alpha_base, alpha_tc, beta_base, beta_tc,
                                mixing, *, dt, dx, dy, ts,
                                splitting="strang", eps=1e-6, cmax=10.0):
    """K2 on a CUDA tensor; the plain version on a CPU tensor.  Forward
    only: the trainable layer is ``fused_channel_vjp.fused_channel_diffusion``
    (``MixedChannelDiffusion(fused=True)``)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (u, alpha_base, alpha_tc, beta_base,
                                      beta_tc, mixing)):
        raise NotImplementedError(
            "fused_channel_diffusion_fwd (K2) is the eval forward and has no "
            "gradient: use ops.fused_channel_vjp.fused_channel_diffusion")
    if splitting not in ("strang", "lie"):
        raise ValueError(f"splitting must be 'strang' or 'lie': {splitting!r}")
    kw = dict(dt=dt, dx=dx, dy=dy, ts=ts, splitting=splitting, eps=eps,
              cmax=cmax)
    fields = (alpha_base, alpha_tc, beta_base, beta_tc, mixing)
    if not kernels.use_kernel(u):
        return fused_channel_diffusion_plain(u, *fields, **kw)
    check_layer_args("fused_channel_diffusion_fwd", u, *fields, ts,
                     splitting)
    out = launch_forward(u, *fields, **kw)
    fused_channel_diffusion_fwd.launches += 1
    return out


fused_channel_diffusion_fwd.launches = 0
