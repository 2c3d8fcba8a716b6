"""K2: a whole MixedChannelDiffusion eval forward in one launch, and its plain
version.  The same kernel with a residual output is K4, the trainable
forward (``ops/fused_channel_vjp.py``).

Counterpart of ``cnn_pde_tpu/ops/pallas_fused_channel.py::
fused_channel_diffusion_fwd``.  The kernel is ``csrc/fused_channel.cu``: one
block keeps its images' (C, H, W) state in shared memory for every step.
Per step: channel mixing, the coefficient fields at the step's substep
times clamped to [eps, cmax], then x(dt/2), y(dt, or dt/2 for Lie) and, for
Strang, x(dt/2) again.  The plain version solves each line by PCR, as the
TPU kernel's ``_pcr_rows`` does (``_abc_nosmooth`` and
``tridiag_solve_pcr``).  The kernel solves the same system by the Thomas
recurrence split in two: one thread a line makes the line's factors once
a block, one thread a (line, image) applies them; ``thomas_factors`` and
``thomas_apply`` are the plain mirror of that arithmetic, which the CPU
tests hold against the plain version and the JAX package.  ``plan_tiles``
spreads the batch over the blocks.

K2 is registered as the op ``cnn_pde_tpu_torch::fused_channel_fwd``
(``fused_channel_fwd_op``, with a fake implementation), so that
``torch.export`` traces an eval forward that reaches it; the wrapper calls
it on every device (its CPU implementation is the plain version).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import kernels
from .tridiag import _sms, tridiag_solve_pcr

__all__ = ["fused_channel_diffusion_fwd", "fused_channel_diffusion_plain",
           "fused_channel_fwd_op",
           "Plan", "plan_tiles", "thomas_factors", "thomas_apply"]

MAX_C = 8               # per-pixel mixing registers (csrc/channel_lines.cuh)
MAX_N = 64              # rows a line
MAX_SMEM = 232_448      # bytes a block may use on Hopper
THREADS = 512           # threads a block (csrc/channel_lines.cuh::kThreads)
FWD_BUFFERS = 1         # image buffers a block image in csrc/fused_channel.cu
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
             + [ctypes.c_float] * 4 + [ctypes.c_void_p])
_layout_checked: set = set()  # (source, shape, plan) held against the C side


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


def thomas_factors(r, eps, transpose=False):
    """Plain mirror of csrc/channel_lines.cuh::factor_line along the last
    axis: (rd, f2) for the sweep system of the clamped, scaled coefficients
    r (``_abc_nosmooth``'s a = c = -r) or, with ``transpose``, of its
    transpose.  rd[i] = 1/d[i], d[i] = b[i] - rs[i] up[i-1], up[i] =
    ru[i] / d[i] with rs, ru the negated sub- and super-diagonal; f2 is
    m[i] = r[i] rd[i] for T and r[i] for the transpose."""
    n = r.shape[-1]
    zero = torch.zeros_like(r[..., 0])
    up = zero
    rd, f2 = [], []
    for i in range(n):
        rc = r[..., i]
        b = (1.0 + rc if i in (0, n - 1) else 1.0 + 2.0 * rc) + eps
        rs = zero if i == 0 else (r[..., i - 1] if transpose else rc)
        ru = zero if i == n - 1 else (r[..., i + 1] if transpose else rc)
        d = 1.0 / (b - rs * up)
        up = ru * d
        rd.append(d)
        f2.append(rc if transpose else rc * d)
    return torch.stack(rd, dim=-1), torch.stack(f2, dim=-1)


def thomas_apply(factors, d, transpose=False):
    """Plain mirror of csrc/channel_lines.cuh::solve_line: x = T⁻¹d (or
    T⁻ᵀd) along the last axis from ``thomas_factors``, broadcast over d's
    leading axes: dp[i] = rd[i] d[i] + lo[i] dp[i-1], x[i] = dp[i] +
    up[i] x[i+1], with lo = up = m for T and lo[i] = r[i-1] rd[i],
    up[i] = r[i+1] rd[i] for the transpose."""
    rd, f2 = factors
    n = d.shape[-1]
    dp = rd[..., 0] * d[..., 0]
    out = [dp]
    for i in range(1, n):
        lo = f2[..., i - 1] * rd[..., i] if transpose else f2[..., i]
        dp = lo * dp + rd[..., i] * d[..., i]
        out.append(dp)
    x = dp
    for i in range(n - 2, -1, -1):
        up = f2[..., i + 1] * rd[..., i] if transpose else f2[..., i]
        x = up * x + out[i]
        out[i] = x
    return torch.stack(out, dim=-1)


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


def factor_threads(C, H, W):
    """Threads a block that factor the lines of a sweep, one a line of the
    longer sweep, whole warps (csrc/channel_lines.cuh::factor_threads)."""
    return -(-C * max(H, W) // 32) * 32


class Plan(NamedTuple):
    """A fused channel launch: ``grid`` blocks of at most ``tile`` images,
    ``nbuf`` factor buffers a block, the fields of ``staged`` coefficients
    (0, alpha's, or alpha's and beta's) in shared memory, and the ``smem``
    bytes of shared memory a block takes."""
    grid: int
    tile: int
    nbuf: int
    staged: int
    smem: int


def plan_tiles(B, C, H, W, sms, buffers=FWD_BUFFERS, extra_floats=0):
    """The launch plan over B >= 1 images, where ``buffers`` image buffers
    of (C, H, W | 1) floats a block image sit beside the mixing matrix,
    ``extra_floats``, the factor buffers (two floats a row of every line of
    either sweep, lines n | 1 floats apart) and the staged fields.  At least
    ``sms`` blocks where the batch allows it (one image a block at
    B <= sms), more where the images would pass the shared memory a block
    may use; whole images, as evenly as they split.  Two factor buffers
    where they fit beside one image (else one); then alpha's two fields
    staged where they fit beside the tile, then beta's.  The kernels take
    ``nbuf`` and ``staged`` from the plan; ``bind`` holds the plan's bytes
    against the C side's count.  Raises if one image does not fit."""
    image = C * H * (W | 1)
    per_image = 4 * buffers * image
    base = 4 * (C * C + extra_floats)
    factors = 4 * 2 * max(image, C * W * (H | 1))
    nbuf = 2 if base + 2 * factors + per_image <= MAX_SMEM else 1
    fixed = base + nbuf * factors
    most = (MAX_SMEM - fixed) // per_image
    if most < 1:
        raise ValueError(f"one image of {(C, H, W)} needs {per_image + fixed} "
                         f"bytes of shared memory a block (limit {MAX_SMEM})")
    grid = max(min(B, sms), -(-B // most))
    tile = -(-B // grid)
    smem = fixed + tile * per_image
    staged = 0
    while staged < 2 and smem + 8 * image <= MAX_SMEM:
        smem += 8 * image
        staged += 1
    return Plan(grid, tile, nbuf, staged, smem)


def bind(name, symbol, argtypes, layout_symbol, shape, plan):
    """The C entry point ``symbol`` of csrc/<name>.cu.  The first time a
    plan is launched for a (C, H, W) ``shape``, raise unless
    ``layout_symbol`` reports for it the threads a block and the bytes of
    shared memory that the wrapper planned with."""
    key = (name, tuple(shape), plan)
    if key not in _layout_checked:
        threads, smem = ctypes.c_int(), ctypes.c_int()
        kernels.function(name, layout_symbol,
                         [ctypes.c_int] * 6
                         + [ctypes.POINTER(ctypes.c_int)] * 2)(
            *shape, plan.tile, plan.nbuf, plan.staged, ctypes.byref(threads),
            ctypes.byref(smem))
        if (threads.value, smem.value) != (THREADS, plan.smem):
            raise RuntimeError(
                f"{name}.cu reports {layout_symbol} = {threads.value} "
                f"threads and {smem.value} bytes for {plan} of "
                f"{tuple(shape)}; the wrapper plans {THREADS} threads and "
                f"{plan.smem} bytes")
        _layout_checked.add(key)
    return kernels.function(name, symbol, argtypes)


def launch_forward(u, alpha_base, alpha_tc, beta_base, beta_tc, mixing, *,
                   dt, dx, dy, ts, splitting, eps, cmax, res=None):
    """Launch csrc/fused_channel.cu on checked CUDA tensors: K2, or K4 when
    ``res`` is a (num_steps, B, C, H, W) tensor to hold the residuals."""
    B, C, H, W = u.shape
    out = torch.empty_like(u)
    if B == 0:
        return out
    plan = plan_tiles(B, C, H, W, _sms(u.device))
    dtf_x, dtf_y = _dt_factors(dt, dx, dy, splitting)
    fn = bind("fused_channel", "fused_channel_diffusion", _ARGTYPES,
              "fused_channel_layout", (C, H, W), plan)
    with torch.cuda.device(u.device):
        code = fn(u.data_ptr(), out.data_ptr(), alpha_base.data_ptr(),
                  alpha_tc.data_ptr(), beta_base.data_ptr(),
                  beta_tc.data_ptr(), mixing.data_ptr(), ts.data_ptr(),
                  None if res is None else res.data_ptr(),
                  B, C, H, W, plan.grid, plan.nbuf, plan.staged, ts.shape[0],
                  int(splitting == "strang"), dtf_x, dtf_y, eps, cmax,
                  kernels.stream_handle(u.device))
    kernels.raise_on_error(
        "fused_channel_diffusion" + ("_fwd" if res is None else "_res"), code)
    return out


torch.library.define(
    "cnn_pde_tpu_torch::fused_channel_fwd",
    "(Tensor u, Tensor alpha_base, Tensor alpha_tc, Tensor beta_base, "
    "Tensor beta_tc, Tensor mixing, Tensor ts, float dt, float dx, "
    "float dy, str splitting, float eps, float cmax) -> Tensor")


@torch.library.impl("cnn_pde_tpu_torch::fused_channel_fwd", ("cpu", "cuda"))
def _fused_channel_fwd_impl(u, alpha_base, alpha_tc, beta_base, beta_tc,
                            mixing, ts, dt, dx, dy, splitting, eps, cmax):
    """K2 as a registered op, so that ``torch.export`` can trace a forward
    that reaches it: on a CUDA tensor the kernel (or, inside
    ``plain_versions()``, its plain version), on a CPU tensor the plain
    version.  Its output has u's shape, contiguous."""
    fields = (alpha_base, alpha_tc, beta_base, beta_tc, mixing)
    kw = dict(dt=dt, dx=dx, dy=dy, ts=ts, splitting=splitting, eps=eps,
              cmax=cmax)
    if not kernels.use_kernel(u):
        return fused_channel_diffusion_plain(u, *fields, **kw).contiguous()
    check_layer_args("fused_channel_diffusion_fwd", u, *fields, ts,
                     splitting)
    out = launch_forward(u, *fields, **kw)
    fused_channel_diffusion_fwd.launches += 1
    return out


@torch.library.register_fake("cnn_pde_tpu_torch::fused_channel_fwd")
def _(u, alpha_base, alpha_tc, beta_base, beta_tc, mixing, ts, dt, dx, dy,
      splitting, eps, cmax):
    return torch.empty_like(u, memory_format=torch.contiguous_format)


fused_channel_fwd_op = torch.ops.cnn_pde_tpu_torch.fused_channel_fwd.default


def fused_channel_diffusion_fwd(u, alpha_base, alpha_tc, beta_base, beta_tc,
                                mixing, *, dt, dx, dy, ts,
                                splitting="strang", eps=1e-6, cmax=10.0):
    """K2 on a CUDA tensor; the plain version on a CPU tensor
    (``fused_channel_fwd_op``).  Forward only: the trainable layer is
    ``fused_channel_vjp.fused_channel_diffusion``
    (``MixedChannelDiffusion(fused=True)``)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (u, alpha_base, alpha_tc, beta_base,
                                      beta_tc, mixing)):
        raise NotImplementedError(
            "fused_channel_diffusion_fwd (K2) is the eval forward and has no "
            "gradient: use ops.fused_channel_vjp.fused_channel_diffusion")
    if splitting not in ("strang", "lie"):
        raise ValueError(f"splitting must be 'strang' or 'lie': {splitting!r}")
    return fused_channel_fwd_op(u, alpha_base, alpha_tc, beta_base, beta_tc,
                                mixing, ts, float(dt), float(dx), float(dy),
                                splitting, float(eps), float(cmax))


fused_channel_diffusion_fwd.launches = 0
