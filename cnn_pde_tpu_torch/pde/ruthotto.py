"""Ruthotto–Haber blocks — port of ``cnn_pde_tpu/pde/ruthotto.py``
(``SymmetricLayer``, ``ParabolicBlock``, ``HamiltonianBlock``).

SymmetricLayer computes F_sym(Y) = −σ(BN(y·w))·wᵀ on the flattened
(B, C·H·W) features y, with w = K.weightᵀ (the reference's
``nn.Linear(bias=False)`` K, its output projection the weight itself).
ParabolicBlock steps Y ← Y + dt·F_sym(Y); HamiltonianBlock runs the
symplectic two-field integrator Y ← Y − dt·F_Y(Z), Z ← Z − dt·F_Z(Y) from
Z = 0.  Every call of a layer in training updates its BatchNorm's running
statistics, as the JAX blocks thread the layer's state through the loop.

The two K products of a call are plain dense products (the JAX package
computes them outside any Pallas kernel), one autograd Function
(``_KProduct``) in two grades, set by ``compute_dtype``:

* **torch.float32, the exact grade** (the layer's default): float32
  products that never take TF32, in the forward or the backward, whatever
  the process's flags say (``layers.no_tf32``).
* **torch.bfloat16** (the hybrid model's default, and ``enable_amp``'s):
  the JAX semantics, ``dot(y.astype(bf16), w.astype(bf16),
  preferred_element_type=float32)``.  K is cast once a block forward, not
  once a call, as XLA's CSE leaves it.  The backward rounds where JAX's
  transpose rules for that product round: the cotangent of each bf16
  operand is a float32 product of the float32 cotangent and the other
  (bf16) operand, rounded to bf16; the two products of one call sum their
  bf16 cotangents of the cast K in bf16, and each call's sum goes to the
  float32 K.weight as float32.  The forward's products go through
  ``ops/tridiag.py::gemm_route``: on the card, bf16 operands and a float32
  result (``bmm(out_dtype=float32)``); their plain version (a CPU tensor,
  or inside ``kernels.plain_versions()``) is the float32 product of the
  bf16-rounded operands, exact products summed in float32.  The
  backward's products, a float32 cotangent times a bf16 operand, are
  float32 products (never TF32) on every device, as JAX computes them.
  No product returns bf16.

Under tensor parallelism (``parallel/tensor_parallel.py``) K.weight holds
this rank's block of K's rows (its out features, JAX's ``w`` split on its
out dim) and ``norm`` that block's features: y·Kᵀ is column-parallel, the
BatchNorm per feature block, and σ(·)·K contracts over the same block,
summed by one all-reduce over 'model' a call.  Both grades apply.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import layers
from ..ops.tridiag import gemm_route

__all__ = ["SymmetricLayer", "ParabolicBlock", "HamiltonianBlock"]

BF16 = torch.bfloat16
_OWN = object()  # a layer called on its own casts its K itself


def _gemm_bf16(a, b):
    """a @ b for bf16 a and b on the card: bf16 operands on the tensor
    cores, float32 accumulation and result."""
    return torch.bmm(a[None], b[None], out_dtype=torch.float32)[0]


def _product(a, b):
    """a @ b, never TF32: two bf16 operands through ``gemm_route`` (on the
    card, the tensor cores with a float32 result); a bf16 operand beside a
    float32 one (the bf16 grade's backward) as a float32 product, exact
    products of the bf16 values; otherwise at the operands' dtype (float32,
    or float64 for a reference)."""
    if a.dtype == b.dtype == BF16 and gemm_route(
            BF16, a.device) == "bmm_out_dtype":
        return _gemm_bf16(a, b)
    if BF16 in (a.dtype, b.dtype):
        a, b = a.float(), b.float()
    with layers.no_tf32():
        return a @ b


class _KProduct(torch.autograd.Function):
    """out = x·kᵀ (``transpose`` False: y·w) or x·k (True: s·wᵀ) for a
    SymmetricLayer's K as stored, (out, in): the float32 K.weight (the
    exact grade) or its bf16 cast (the bf16 grade, x rounded to bf16).
    ``round_gx`` False leaves x's cotangent in float32 (a tensor-parallel
    product's partial cotangent, rounded after its all-reduce by
    ``_RoundCotangent``)."""

    @staticmethod
    def forward(ctx, x, k, transpose, round_gx=True):
        if k.dtype == BF16:
            x = x.to(BF16)
        ctx.transpose, ctx.round_gx = transpose, round_gx
        ctx.save_for_backward(x, k)
        return _product(x, k if transpose else k.t())

    @staticmethod
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        kk = k if ctx.transpose else k.t()  # out = x·kk
        gx = gk = None
        if ctx.needs_input_grad[0]:
            gx = _product(g, kk.t())
            if k.dtype == BF16 and ctx.round_gx:  # x's bf16 cast's
                gx = gx.to(BF16).float()
        if ctx.needs_input_grad[1]:
            gkk = _product(x.t(), g)
            gk = gkk if ctx.transpose else gkk.t()
            if k.dtype == BF16:
                gk = gk.to(BF16)
        return gx, gk, None, None


class _RoundCotangent(torch.autograd.Function):
    """Identity forward; the cotangent rounded to bf16 (returned in
    float32): the bf16 cast of a product's operand whose cotangent is
    summed across ranks first."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(BF16).float()


class _CallCast(torch.autograd.Function):
    """One call's view of the block's bf16 cast of K: its forward returns
    the cast, its backward takes the call's bf16 cotangent (the two
    products' summed in bf16) to the float32 weight as float32."""

    @staticmethod
    def forward(ctx, weight, cast):
        return cast.view_as(cast)

    @staticmethod
    def backward(ctx, g):
        return g.float(), None


class SymmetricLayer(nn.Module):
    """F_sym(Y) = −σ(BN(y·w))·wᵀ on (B, C, H, W) → (B, C, H, W), with
    K an (D, D) ``nn.Linear`` without bias, D = C·H·W, initialised to
    I + 0.01·N(0, 1), and a ``BatchNorm1d(D)`` named ``norm``."""

    def __init__(self, channels, spatial_size, activation="relu",
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        if activation not in ("relu", "tanh", None):
            raise ValueError(f"activation must be 'relu', 'tanh' or None: "
                             f"{activation!r}")
        self.channels = channels
        self.spatial_size = spatial_size
        self.feature_dim = channels * spatial_size * spatial_size
        # a module, so that a forward hook sees each call's pre-activation
        self.act = {"relu": nn.ReLU, "tanh": nn.Tanh,
                    None: nn.Identity}[activation]()
        self.compute_dtype = compute_dtype
        self.K = nn.Linear(self.feature_dim, self.feature_dim, bias=False,
                           device=device)
        self.norm = nn.BatchNorm1d(self.feature_dim, device=device)
        # (mesh, axis) once parallel/tensor_parallel.py shards K's rows
        self.tp = None

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """K = I + 0.01·N(0, 1) drawn from ``generator`` (a CPU one), the
        norm at torch's init."""
        d = self.feature_dim
        self.K.weight.copy_(torch.eye(d) + torch.randn(
            (d, d), generator=generator) * 0.01)
        self.norm.reset_parameters()

    def operand(self):
        """What a block passes to each call of its forward: None in the
        exact grade; in the bf16 grade, K.weight cast to bf16 once."""
        if self.compute_dtype == torch.float32:
            return None
        if self.compute_dtype != BF16:
            raise ValueError(f"compute_dtype {self.compute_dtype} is not a "
                             "grade of the port (float32 or bfloat16)")
        return self.K.weight.detach().to(BF16)

    def forward(self, Y, operand=_OWN):
        """F_sym(Y); ``operand``: what ``operand()`` gave the calling
        block, by default made for this call."""
        if operand is _OWN:
            operand = self.operand()
        k = self.K.weight
        if operand is not None:
            k = _CallCast.apply(k, operand)
        y = Y.reshape(Y.shape[0], -1)
        if self.tp is not None:  # y·Kᵀ column-parallel on K's row block
            from ..parallel.collectives import copy_to

            if operand is not None:  # y's cotangent rounded once, summed
                y = _RoundCotangent.apply(y)
            y = copy_to(y, *self.tp)
        ky = self.norm(_KProduct.apply(y, k, False, self.tp is None))
        out = -_KProduct.apply(self.act(ky), k, True)
        if self.tp is not None:  # s·K row-parallel: one all-reduce a call
            from ..parallel.collectives import reduce_from

            out = reduce_from(out, *self.tp)
        return out.reshape(Y.shape)


class ParabolicBlock(nn.Module):
    """∂_t Y = F_sym(Y) by forward Euler: Y ← Y + dt·F_sym(Y),
    ``num_steps`` times, one layer ``symmetric_layer``."""

    def __init__(self, channels, spatial_size, num_steps=3, dt=1.0,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        self.num_steps = num_steps
        self.dt = dt
        self.symmetric_layer = SymmetricLayer(
            channels, spatial_size, compute_dtype=compute_dtype,
            device=device)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.symmetric_layer.reset_parameters(generator)

    def forward(self, Y):
        layer = self.symmetric_layer
        w = layer.operand()
        for _ in range(self.num_steps):
            Y = Y + self.dt * layer(Y, w)
        return Y


class HamiltonianBlock(nn.Module):
    """The symplectic two-field integrator from Z = 0:
    Y ← Y + dt·(−F_Y(Z)), Z ← Z − dt·F_Z(Y), ``num_steps`` times."""

    def __init__(self, channels, spatial_size, num_steps=3, dt=1.0,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        self.num_steps = num_steps
        self.dt = dt
        self.F_Y = SymmetricLayer(channels, spatial_size,
                                  compute_dtype=compute_dtype, device=device)
        self.F_Z = SymmetricLayer(channels, spatial_size,
                                  compute_dtype=compute_dtype, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.F_Y.reset_parameters(generator)
        self.F_Z.reset_parameters(generator)

    def forward(self, Y):
        Z = torch.zeros_like(Y)
        wy, wz = self.F_Y.operand(), self.F_Z.operand()
        for _ in range(self.num_steps):
            Y = Y + self.dt * (-self.F_Y(Z, wy))
            Z = Z - self.dt * self.F_Z(Y, wz)
        return Y
