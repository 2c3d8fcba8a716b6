"""Batched tridiagonal solves with an analytic adjoint: K1 and K3.

Port of ``cnn_pde_tpu/ops/tridiag.py``; ``tridiag_solve`` is the
counterpart of ``cnn_pde_tpu/ops/pallas_thomas.py::pallas_tridiag_solve``
and its custom VJP.  Both kernels are in ``csrc/thomas.cu``: K1 solves,
K3 (``tridiag_adjoint``) solves the transposed system λ = T⁻ᵀg and sums the
band gradients over the batch.

The reference adds ``eps`` into every forward-elimination denominator, which
is exactly the Thomas recurrence on the matrix whose main diagonal is
``b + eps``.  So the solvers here are exact linear solves and the callers
pass ``b + eps``; no solver adds ``eps`` itself.

Shapes: the bands ``a, b, c`` have a batch-free shape ``S`` and the right-hand
side ``d`` has shape ``(*batch, *S)``; the solve runs along axis ``dim`` of
``S`` (``-1`` for an x-sweep, ``-2`` for a y-sweep down the columns, in place
and without a transpose).  Row ``i`` of a line reads
``a[i]·x[i-1] + b[i]·x[i] + c[i]·x[i+1] = d[i]``; ``a[0]`` and ``c[N-1]`` lie
outside the matrix and are ignored.

``tridiag_solve_pcr`` is parallel cyclic reduction in plain PyTorch: the same
system in ceil(log2 N) levels, the plain version of K2's in-kernel solve.

The gradient (``_TridiagSolve.backward``): λ = T⁻ᵀg, grad_d = λ,
grad_b = −Σ_batch λ∘x, grad_a[i] = −Σ λ[i]x[i−1], grad_c[i] = −Σ λ[i]x[i+1],
with grad_a[0] = grad_c[N−1] = 0.  Whether the kernels or the plain versions
run is decided in the forward, from ``d``'s device and ``plain_versions()``,
and the backward follows that choice (it may run on another thread).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import kernels

__all__ = ["tridiag_solve", "tridiag_solve_plain", "tridiag_solve_pcr",
           "tridiag_adjoint", "tridiag_adjoint_plain", "MAX_N"]

MAX_N = 64  # c* lives in a per-thread array of this length (csrc/thomas.cu)
_SHAPE_ARGS = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p]
_ARGTYPES = [ctypes.c_void_p] * 5 + _SHAPE_ARGS
_ADJOINT_ARGTYPES = [ctypes.c_void_p] * 9 + _SHAPE_ARGS


def _thomas_last_axis(a, b, c, d):
    """The Thomas recurrence along the last axis, batched by broadcasting —
    the port of the JAX ``_thomas_scan`` (ops/tridiag.py there)."""
    n = d.shape[-1]
    cs = [c[..., 0] / b[..., 0]]
    ds = [d[..., 0] / b[..., 0]]
    for i in range(1, n):
        denom = b[..., i] - a[..., i] * cs[i - 1]
        cs.append(c[..., i] / denom)
        ds.append((d[..., i] - a[..., i] * ds[i - 1]) / denom)
    xs = [ds[-1]]
    for i in range(n - 2, -1, -1):
        xs.append(ds[i] - cs[i] * xs[-1])
    shape = torch.broadcast_shapes(a.shape, b.shape, c.shape, d.shape)
    return torch.stack([x.expand(shape[:-1]) for x in xs[::-1]], dim=-1)


def tridiag_solve_plain(a, b, c, d, dim=-1):
    """Plain PyTorch version of K1: the same recurrence over tensors."""
    if dim == -1:
        return _thomas_last_axis(a, b, c, d)
    a, b, c, d = (t.movedim(dim, -1) for t in (a, b, c, d))
    return _thomas_last_axis(a, b, c, d).movedim(-1, dim)


def _transpose_system(a, b, c, dim=-1):
    """Bands of Tᵀ for T = (a, b, c) along ``dim``: sub'[i] = c[i-1],
    super'[i] = a[i+1]."""
    a, c = a.movedim(dim, -1), c.movedim(dim, -1)
    zero = torch.zeros_like(c[..., :1])
    a_t = torch.cat([zero, c[..., :-1]], dim=-1)
    c_t = torch.cat([a[..., 1:], zero], dim=-1)
    return a_t.movedim(-1, dim), b, c_t.movedim(-1, dim)


def _reduce_like(grad, ref):
    """Sum a gradient of the solve's shape over its leading batch axes onto
    the batch-free band shape of ``ref``."""
    if grad.ndim > ref.ndim:
        grad = grad.sum(dim=tuple(range(grad.ndim - ref.ndim)))
    return grad


def _adjoint_band_grads(a, b, c, x, lam, dim=-1):
    """(grad_a, grad_b, grad_c) from λ and x, reduced onto the bands'
    shapes."""
    lam_l, x_l = lam.movedim(dim, -1), x.movedim(dim, -1)
    zero = torch.zeros_like(x_l[..., :1])
    grads = (torch.cat([zero, -lam_l[..., 1:] * x_l[..., :-1]], dim=-1),
             -lam_l * x_l,
             torch.cat([-lam_l[..., :-1] * x_l[..., 1:], zero], dim=-1))
    return tuple(_reduce_like(g.movedim(-1, dim), ref)
                 for g, ref in zip(grads, (a, b, c)))


def tridiag_adjoint_plain(a, b, c, g, x, dim=-1):
    """Plain PyTorch version of K3: (λ, grad_a, grad_b, grad_c)."""
    lam = tridiag_solve_plain(*_transpose_system(a, b, c, dim), g, dim)
    return (lam, *_adjoint_band_grads(a, b, c, x, lam, dim))


def _line_shape(name, a, b, c, d, dim):
    """Check the kernels' layout and return (batch, P, N, Q)."""
    shape = tuple(a.shape)
    if b.shape != a.shape or c.shape != a.shape:
        raise ValueError(f"{name}: bands must share one shape, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    if d.ndim < len(shape) or tuple(d.shape[d.ndim - len(shape):]) != shape:
        raise ValueError(f"{name}: {tuple(d.shape)} must end with the band "
                         f"shape {shape}")
    if not -len(shape) <= dim < 0:
        raise ValueError(f"{name}: dim {dim} outside the band shape")
    n = shape[dim]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{name}: line length {n} outside [1, {MAX_N}]")
    q = math.prod(shape[len(shape) + dim + 1:])
    p = math.prod(shape[:len(shape) + dim])
    return d.numel() // math.prod(shape), p, n, q


def _thomas_kernel(a, b, c, d, dim):
    """K1 on CUDA tensors."""
    batch, p, n, q = _line_shape("tridiag_solve", a, b, c, d, dim)
    kernels.check_float32("tridiag_solve", d.device, a=a, b=b, c=c, d=d)
    x = torch.empty_like(d)
    if batch == 0:
        return x
    fn = kernels.function("thomas", "thomas_solve", _ARGTYPES)
    with torch.cuda.device(d.device):
        code = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
                  x.data_ptr(), batch, p, n, q,
                  kernels.stream_handle(d.device))
    kernels.raise_on_error("tridiag_solve", code)
    tridiag_solve.launches += 1
    return x


def tridiag_adjoint(a, b, c, g, x, dim=-1):
    """(λ = T⁻ᵀg, grad_a, grad_b, grad_c) for x = T⁻¹d: K3 on a CUDA tensor,
    the plain version on a CPU tensor.  The bands are batch-free; g and x
    have the solve's shape."""
    if not kernels.use_kernel(g):
        return tridiag_adjoint_plain(a, b, c, g, x, dim)
    batch, p, n, q = _line_shape("tridiag_adjoint", a, b, c, g, dim)
    if x.shape != g.shape:
        raise ValueError(f"tridiag_adjoint: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} differ")
    kernels.check_float32("tridiag_adjoint", g.device, a=a, b=b, c=c, g=g,
                          x=x)
    lam = torch.empty_like(g)
    ga, gb, gc = (torch.empty_like(a) for _ in range(3))
    if batch == 0:
        return lam, ga.zero_(), gb.zero_(), gc.zero_()
    fn = kernels.function("thomas", "thomas_adjoint", _ADJOINT_ARGTYPES)
    with torch.cuda.device(g.device):
        code = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), g.data_ptr(),
                  x.data_ptr(), lam.data_ptr(), ga.data_ptr(), gb.data_ptr(),
                  gc.data_ptr(), batch, p, n, q,
                  kernels.stream_handle(g.device))
    kernels.raise_on_error("tridiag_adjoint", code)
    tridiag_adjoint.launches += 1
    return lam, ga, gb, gc


tridiag_adjoint.launches = 0


class _TridiagSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, c, d, dim):
        ctx.kernel = kernels.use_kernel(d)
        x = (_thomas_kernel(a, b, c, d, dim) if ctx.kernel
             else tridiag_solve_plain(a, b, c, d, dim))
        ctx.dim = dim
        ctx.save_for_backward(a, b, c, x)
        return x

    @staticmethod
    def backward(ctx, g):
        a, b, c, x = ctx.saved_tensors
        if ctx.kernel:
            lam, ga, gb, gc = tridiag_adjoint(a, b, c, g.contiguous(),
                                              x.contiguous(), ctx.dim)
        else:
            lam, ga, gb, gc = tridiag_adjoint_plain(a, b, c, g, x, ctx.dim)
        return ga, gb, gc, lam, None


def tridiag_solve(a, b, c, d, dim=-1):
    """x = T⁻¹d along axis ``dim`` of the band shape: K1 on a CUDA tensor,
    the plain version on a CPU tensor; differentiable in all four inputs
    (K3 or its plain version)."""
    return _TridiagSolve.apply(a, b, c, d, dim)


tridiag_solve.launches = 0


def tridiag_solve_pcr(a, b, c, d):
    """Parallel cyclic reduction along the last axis.  The band reduction is
    batch-free when (a, b, c) broadcast against a batched d; only the
    d-update runs at batch size."""
    n = d.shape[-1]
    zero = torch.zeros_like(a[..., :1])
    a = torch.cat([zero, a[..., 1:]], dim=-1)
    c = torch.cat([c[..., :-1], zero], dim=-1)

    def shift_right(x, s, fill):  # x[i-s], out of range -> fill
        pad = torch.full_like(x[..., :1], fill).expand(*x.shape[:-1], s)
        return torch.cat([pad, x], dim=-1)[..., :n]

    def shift_left(x, s, fill):  # x[i+s], out of range -> fill
        pad = torch.full_like(x[..., :1], fill).expand(*x.shape[:-1], s)
        return torch.cat([x, pad], dim=-1)[..., s:]

    s = 1
    for _ in range(max(1, (n - 1).bit_length())):
        alpha = -a / shift_right(b, s, 1.0)
        gamma = -c / shift_left(b, s, 1.0)
        a, b, c, d = (
            alpha * shift_right(a, s, 0.0),
            b + alpha * shift_right(c, s, 0.0) + gamma * shift_left(a, s, 0.0),
            gamma * shift_left(c, s, 0.0),
            d + alpha * shift_right(d, s, 0.0) + gamma * shift_left(d, s, 0.0),
        )
        s *= 2
    return d / b
