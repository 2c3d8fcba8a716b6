"""Full-evolution linearization for frozen-weights serving — port of
``cnn_pde_tpu/pde/linearize.py``.

Every PDE front-end layer of the port is linear in its input ``u``: the
clamps, sigmoids and smoothing act on coefficients (weights), never on
activations (the implicit ADI sweeps, channel mixing and coupling, the
sigmoid skip blend, the frozen-ring FTCS stencil and the damped
Laplacian step).  So with frozen weights a layer's whole multi-step
evolution is one dense (D, D) matrix, D = C·H·W, and serving replaces its
sequential sweeps with one product ``u.reshape(B, D) @ M``.  The matrix is
built by evolving the identity basis (D one-hot images) through the layer's
own forward, so every variant of the layer is baked in by construction.  On
the card that forward runs the layer's kernels at batch D: K1 over
D·C·H lines a sweep (per-sweep), K2 at B = D (``fused_inference``), K6 at
B = D (the grayscale layer fused).

Applying a matrix (``_apply_mat``) is a library product, as the JAX package
leaves it to XLA:

* float32: ``u.reshape(B, D) @ M`` in float32.  The port never takes TF32,
  so every float32 product is exact and ``precision`` changes nothing;
* bf16 (``dtype=torch.bfloat16``): bf16 operands, a float32 result,
  through ``ops/tridiag.py::gemm_route`` as the AMP grade's sweeps are;
* int8 (``QuantizedMatrix``): W8A8, the rows of ``u`` quantized at the call
  (symmetric, row max / 127, round half to even as ``jnp.round``), an
  int8 × int8 → int32 product by ``torch._int_mm``, then one rescale.  On
  the card ``_int_mm`` takes at least 17 rows, and K and N multiples of 8
  (every linearized D of the repo, 784, 2,304 and 3,072, is): fewer rows
  are padded with zero rows that are sliced off after; a shape it refuses
  raises.

The capture is kept per thread: a server that builds a new model's
matrices in one thread (a reload) does not capture another thread's
requests.
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import NamedTuple

import torch

from ..ops.tridiag import _bmm

__all__ = ["capture_linearized", "linearized_apply", "iter_linear_pde_layers",
           "QuantizedMatrix", "quantize_int8"]

# torch._int_mm on a CUDA device takes more than 16 rows
_INT_MM_MIN_ROWS = 17


class QuantizedMatrix(NamedTuple):
    """An int8-quantized evolution matrix, ``M ≈ q * scale[None, :]``:
    ``q`` (D, D) int8 (column-major), ``scale`` (D,) float32, one symmetric
    scale an output column (its largest |entry| / 127)."""

    q: torch.Tensor
    scale: torch.Tensor


def quantize_int8(mat):
    """Per-output-column symmetric int8 quantization of a (D, D) float32
    matrix, rounding half to even.  ``q`` is laid out column-major: the
    layout cuBLASLt's int8 products take as their second operand, where a
    row-major one is transposed at every call."""
    m = mat.float()
    scale = m.abs().amax(dim=0).clamp_min(1e-30) / 127.0
    q = torch.round(m / scale[None, :]).clamp(-127, 127).to(torch.int8)
    return QuantizedMatrix(q.t().contiguous().t(), scale)


class _Capture:
    def __init__(self, max_dim):
        self.max_dim = max_dim
        self.items = []    # [(layer, (D, D) float32 matrix)]
        self.skipped = []  # [(layer, D)]: over max_dim, left sequential


_state = threading.local()


@contextmanager
def capture_linearized(max_dim=4096):
    """While active (in this thread), every linearizable PDE layer in eval
    mode with D = C·H·W <= ``max_dim`` builds its composed matrix on its
    first call, appends ``(layer, M)`` to the yielded capture, and returns
    the matrix applied to its input."""
    prev, cap = getattr(_state, "capture", None), _Capture(max_dim)
    _state.capture = cap
    try:
        yield cap
    finally:
        _state.capture = prev


def _int8_apply(x, mat):
    """(B, D) float32 through a QuantizedMatrix: rows quantized at the
    call, an int32 product, the rescale (acc · r) · scale."""
    r = x.abs().amax(dim=1).clamp_min(1e-30) / 127.0
    xq = torch.round(x / r[:, None]).clamp(-127, 127).to(torch.int8)
    rows = xq.shape[0]
    if xq.is_cuda and rows < _INT_MM_MIN_ROWS:
        xq = torch.cat([xq, xq.new_zeros((_INT_MM_MIN_ROWS - rows,
                                          xq.shape[1]))])
    acc = torch._int_mm(xq, mat.q)[:rows]
    return acc.float() * r[:, None] * mat.scale[None, :]


def _apply_mat(u, mat):
    B = u.shape[0]
    x = u.reshape(B, -1)
    if isinstance(mat, QuantizedMatrix):
        out = _int8_apply(x, mat)
    elif mat.dtype == torch.bfloat16:
        out = _bmm(x[None], mat[None])[0]
    else:
        out = x @ mat.to(x.dtype)
    return out.reshape(u.shape)


def linearized_apply(layer, u):
    """Layer-entry hook: the linearized output, or None to run the layer's
    own evolution.

    * ``layer.linear_cache`` pinned (``serve.linearize_pde_layers``): apply
      it.  A layer in training mode with a cache pinned raises: the matrix
      carries no gradient and goes stale when the weights change.
    * inside ``capture_linearized`` (eval mode): build the matrix by
      evolving the identity basis through the layer's own forward, with the
      capture suspended, record it, and apply it to ``u``.
    """
    mat = getattr(layer, "linear_cache", None)
    if mat is not None:
        if layer.training:
            raise ValueError(
                "linear_cache is pinned on this layer (frozen-weights "
                "linearized serving) but it is in training mode; "
                "serve.clear_linear_cache(model) before training")
        return _apply_mat(u, mat)
    cap = getattr(_state, "capture", None)
    if cap is None or layer.training:
        return None
    D = math.prod(u.shape[1:])
    if D > cap.max_dim:
        cap.skipped.append((layer, D))
        return None
    _state.capture = None  # the basis runs the layer's own evolution
    try:
        basis = torch.eye(D, dtype=u.dtype, device=u.device).reshape(
            (D,) + tuple(u.shape[1:]))
        with torch.no_grad():
            mat = layer(basis).reshape(D, D)  # row i: the image of e_i
    finally:
        _state.capture = cap
    cap.items.append((layer, mat))
    return _apply_mat(u, mat)


def iter_linear_pde_layers(module):
    """Every linearizable PDE layer of ``module``: the ADI diffusion
    layers, the FTCS layer and the residual diffusion (the Ruthotto blocks
    are nonlinear and excluded)."""
    from .amp import _ADI_CLASSES, iter_modules
    from .residual import ResidualDiffusion
    from .spectral import FourierFTCSLayer

    return iter_modules(
        module, _ADI_CLASSES + (FourierFTCSLayer, ResidualDiffusion))
