"""K6: a whole GrayscaleDiffusion eval forward in one launch, and its plain
version.  The same kernel with a residual output is K7, the trainable
forward (``ops/fused_grayscale_vjp.py``).

Counterpart of ``cnn_pde_tpu/ops/pallas_fused_adi.py::
fused_grayscale_diffusion_fwd``.  The kernel is ``csrc/fused_grayscale.cu``:
one block keeps ``TILE_B`` images' (H, W) state in shared memory for every
step.  Per Strang step: x(dt/2) at ts[s, 0], y(dt) at ts[s, 1], x(dt/2) at
ts[s, 2], each with the coefficient field clamped below at eps
(``max(raw, eps)``: no upper clamp) and smoothed by ``smooth3`` along the
sweep axis (W for x, H for y).  The plain version runs the same steps with
the TPU kernel's own sweep (``_abc_smooth`` + PCR, as ``_sweep_rows`` does);
the kernel solves each line by Thomas, which is the same system.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels
from .fused_channel import MAX_N, MAX_SMEM, _abc_nosmooth, _dt_factors
from .smoothing import smooth3
from .tridiag import tridiag_solve_pcr

__all__ = ["fused_grayscale_diffusion_fwd", "fused_grayscale_diffusion_plain",
           "TILE_B"]

TILE_B = 8              # images a block: 224 threads, 26.0 KB at 28×28
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
             + [ctypes.c_float] * 3 + [ctypes.c_void_p])


def _abc_smooth(field, dtfac, eps):
    """The sweep system along the last axis for a clamped coefficient
    field, smoothed along that axis first (``_sweep_rows(smooth=True)``)."""
    return _abc_nosmooth(smooth3(field), dtfac, eps)


def _sweep_smooth(u, field, dtfac, eps):
    return tridiag_solve_pcr(*_abc_smooth(field, dtfac, eps), u)


def _sweep_y_smooth(u, field, dtfac, eps):
    """The y-sweep as the TPU kernel does it: transpose, sweep (smoothing
    along the transposed last axis, H), transpose back."""
    return _sweep_smooth(u.transpose(-1, -2), field.transpose(-1, -2),
                         dtfac, eps).transpose(-1, -2)


def _coeff(base, tc, t, eps):
    return (base + tc * t).clamp_min(eps)


def fused_grayscale_diffusion_plain(u, alpha_base, alpha_tc, beta_base,
                                    beta_tc, *, dt, dx, dy, ts, eps=1e-6,
                                    residuals=None):
    """Plain PyTorch version of K6: u (B, H, W), fields (H, W), ts
    (num_steps, 3) float32.  With a list as ``residuals`` (K7's plain
    version) each step's input state is appended to it."""
    dtf_x, dtf_y = _dt_factors(dt, dx, dy, "strang")
    for s in range(ts.shape[0]):
        if residuals is not None:
            residuals.append(u)
        u = _sweep_smooth(u, _coeff(alpha_base, alpha_tc, ts[s, 0], eps),
                          dtf_x, eps)
        u = _sweep_y_smooth(u, _coeff(beta_base, beta_tc, ts[s, 1], eps),
                            dtf_y, eps)
        u = _sweep_smooth(u, _coeff(alpha_base, alpha_tc, ts[s, 2], eps),
                          dtf_x, eps)
    return u


def check_layer_args(name, u, alpha_base, alpha_tc, beta_base, beta_tc, ts):
    """Raise on anything the grayscale kernels (K6, K7, K8) do not take."""
    if u.ndim != 3:
        raise ValueError(f"{name}: u must be (B, H, W), got "
                         f"{tuple(u.shape)}")
    _, H, W = u.shape
    for key, t in (("alpha_base", alpha_base), ("alpha_tc", alpha_tc),
                   ("beta_base", beta_base), ("beta_tc", beta_tc)):
        if tuple(t.shape) != (H, W):
            raise ValueError(f"{name}: {key} must be {(H, W)}, got "
                             f"{tuple(t.shape)}")
    if ts.ndim != 2 or ts.shape[1] != 3:
        raise ValueError(f"{name}: ts must be (num_steps, 3), got "
                         f"{tuple(ts.shape)}")
    kernels.check_float32(name, u.device, u=u, alpha_base=alpha_base,
                          alpha_tc=alpha_tc, beta_base=beta_base,
                          beta_tc=beta_tc, ts=ts)
    if not (1 <= H <= MAX_N and 1 <= W <= MAX_N):
        raise ValueError(f"{name}: H, W in [1, {MAX_N}] required, got "
                         f"H={H}, W={W}")


def launch_shape(tile_b, H, W, buffers, field_buffers=0):
    """(threads, shared bytes) of a grayscale block of ``tile_b`` images
    with ``buffers`` padded (H, W + 1) buffers an image and
    ``field_buffers`` (H, W) buffers a block (K6 and K7: 1 and 0; K8: 4 and
    1), as the C entry points compute them; raises above the card's
    limits."""
    threads = -(-tile_b * max(H, W) // 32) * 32
    smem = 4 * (buffers * tile_b * H * (W + 1) + field_buffers * H * W)
    if threads > 1024 or smem > MAX_SMEM:
        raise ValueError(f"{tile_b} images of {(H, W)} need {threads} "
                         f"threads and {smem} bytes of shared memory a block "
                         f"(limits 1024 and {MAX_SMEM})")
    return threads, smem


def launch_forward(u, alpha_base, alpha_tc, beta_base, beta_tc, *, dt, dx,
                   dy, ts, eps, res=None):
    """Launch csrc/fused_grayscale.cu on checked CUDA tensors: K6, or K7
    when ``res`` is a (num_steps, B, H, W) tensor to hold the residuals."""
    B, H, W = u.shape
    launch_shape(TILE_B, H, W, 1)
    out = torch.empty_like(u)
    if B == 0:
        return out
    dtf_x, dtf_y = _dt_factors(dt, dx, dy, "strang")
    fn = kernels.function("fused_grayscale", "fused_grayscale_diffusion",
                          _ARGTYPES)
    with torch.cuda.device(u.device):
        code = fn(u.data_ptr(), out.data_ptr(), alpha_base.data_ptr(),
                  alpha_tc.data_ptr(), beta_base.data_ptr(),
                  beta_tc.data_ptr(), ts.data_ptr(),
                  None if res is None else res.data_ptr(),
                  B, H, W, TILE_B, ts.shape[0], dtf_x, dtf_y, eps,
                  kernels.stream_handle(u.device))
    kernels.raise_on_error(
        "fused_grayscale_diffusion" + ("_fwd" if res is None else "_res"),
        code)
    return out


def fused_grayscale_diffusion_fwd(u, alpha_base, alpha_tc, beta_base,
                                  beta_tc, *, dt, dx, dy, ts, eps=1e-6):
    """K6 on a CUDA tensor; the plain version on a CPU tensor.  Forward
    only: the trainable layer is ``fused_grayscale_vjp.
    fused_grayscale_diffusion`` (``GrayscaleDiffusion(fused=True)``)."""
    fields = (alpha_base, alpha_tc, beta_base, beta_tc)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (u, *fields)):
        raise NotImplementedError(
            "fused_grayscale_diffusion_fwd (K6) is the eval forward and has "
            "no gradient: use ops.fused_grayscale_vjp."
            "fused_grayscale_diffusion")
    kw = dict(dt=dt, dx=dx, dy=dy, ts=ts, eps=eps)
    if not kernels.use_kernel(u):
        return fused_grayscale_diffusion_plain(u, *fields, **kw)
    check_layer_args("fused_grayscale_diffusion_fwd", u, *fields, ts)
    out = launch_forward(u, *fields, **kw)
    fused_grayscale_diffusion_fwd.launches += 1
    return out


fused_grayscale_diffusion_fwd.launches = 0
