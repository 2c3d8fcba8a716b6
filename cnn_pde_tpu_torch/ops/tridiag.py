"""Batched tridiagonal solves, forward only, and K1.

Port of ``cnn_pde_tpu/ops/tridiag.py``; ``tridiag_solve`` is the
counterpart of ``cnn_pde_tpu/ops/pallas_thomas.py::pallas_tridiag_solve``
(forward), and its kernel is ``csrc/thomas.cu`` (K1).

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
Gradients are the training slice (ROADMAP.md A5) and raise here.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import kernels

__all__ = ["tridiag_solve", "tridiag_solve_plain", "tridiag_solve_pcr",
           "MAX_N"]

MAX_N = 64  # c* lives in a per-thread array of this length (csrc/thomas.cu)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


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


def _check_grad(name, *tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} is forward only: the analytic adjoint is the training "
            "slice, ROADMAP.md A5 (B1's VJP as a K1 adjoint kernel)")


def tridiag_solve(a, b, c, d, dim=-1):
    """x = T⁻¹d along axis ``dim`` of the band shape: K1 on a CUDA tensor,
    the plain version on a CPU tensor."""
    _check_grad("tridiag_solve", a, b, c, d)
    if not kernels.use_kernel(d):
        return tridiag_solve_plain(a, b, c, d, dim)
    shape = tuple(a.shape)
    if b.shape != a.shape or c.shape != a.shape:
        raise ValueError(f"tridiag_solve: bands must share one shape, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    if d.ndim < len(shape) or tuple(d.shape[d.ndim - len(shape):]) != shape:
        raise ValueError(f"tridiag_solve: d {tuple(d.shape)} must end with the "
                         f"band shape {shape}")
    if not -len(shape) <= dim < 0:
        raise ValueError(f"tridiag_solve: dim {dim} outside the band shape")
    kernels.check_float32("tridiag_solve", d.device, a=a, b=b, c=c, d=d)
    n = shape[dim]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"tridiag_solve: line length {n} outside [1, {MAX_N}]")
    q = math.prod(shape[len(shape) + dim + 1:])
    p = math.prod(shape[:len(shape) + dim])
    batch = d.numel() // math.prod(shape)
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
