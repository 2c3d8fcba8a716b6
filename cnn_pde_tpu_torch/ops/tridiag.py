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
``a[i]·x[i-1] + b[i]·x[i] + c[i]·x[i+1] = d[i]``; ``a[0]`` and ``c[N-1]``
lie outside the matrix and are ignored.

The kernels solve by parallel cyclic reduction (PCR): ``pcr_factor`` reduces
the batch-free bands once, ``pcr_apply`` runs the per-image levels;
``tridiag_solve_pcr`` is their composition, the plain version of
K1's and K3's arithmetic and of the fused kernels' line solves.
``_adjoint_band_partials`` and ``_sum_band_partials`` mirror K3's band sums
(per chunk of images, then over chunks in fixed order).  Lines longer than
``SHORT_N`` (64) rows, up to ``MAX_N`` (1,440), take a second scheme in the
same kernels, chosen by N at launch: partition + PCR, whose batch-free and
per-image phases ``partition_factor`` and ``partition_apply`` mirror.  The
plain versions of K1 and K3 are the Thomas recurrence, the reference the
kernels are held against, at every N.

K1 is registered as the op ``cnn_pde_tpu_torch::thomas_solve``
(``thomas_solve_op``, with a fake implementation; ``torch.library.define``
and ``impl``), so that
``torch.export`` traces a forward that reaches it; ``_TridiagSolve`` and
``tridiag_inverse_operator`` call it on every device (its CPU
implementation is the plain version).  K3 appears in no eval forward and
is not registered.

The gradient (``_TridiagSolve.backward``): λ = T⁻ᵀg, grad_d = λ,
grad_b = −Σ_batch λ∘x, grad_a[i] = −Σ λ[i]x[i−1], grad_c[i] = −Σ λ[i]x[i+1],
with grad_a[0] = grad_c[N−1] = 0.  Whether the kernels or the plain versions
run is decided in the forward, from ``d``'s device and ``plain_versions()``,
and the backward follows that choice (it may run on another thread).

The inverse-operator solves (the AMP grade's, ROADMAP.md A6):
``tridiag_inverse_operator`` builds X with X[..., k, i] = (T⁻¹)[i, k] for
batch-free bands, once, by one K1 launch on the identity (the bands' lines
as rows, the batch N); a solve is then one batched GEMM over the bands'
rows, x = d·X (``tridiag_solve_precomputed``, backward λ = X·g by one more
GEMM and the band sums; ``tridiag_solve_with_operator`` adds one
Richardson refinement).  A bf16 X takes bf16 operands with float32
accumulation and a float32 result; the route (``gemm_route``) is chosen
once per device by the torch version, not by trying.
``set_default_impl('matinv' | 'matinv_bf16')`` sends ``tridiag_solve``
itself through an operator built at each call.

The JAX package's XLA solvers are opt-ins here too
(``set_default_impl('scan' | 'pcr' | 'pcr2')``, or ``impl=`` a call):
the Thomas recurrence, PCR and PCR with the right-hand side updated in
fused level pairs (``tridiag_solve_pcr_fused``), plain PyTorch on every
device, with the JAX custom VJP (``_PlainSolve``); 'pallas', the JAX TPU
kernel, is K1 and K3 here, as 'auto' is.

The JAX package's test oracles are public here too, plain PyTorch on
every device (a CUDA tensor goes through PyTorch ops, never a kernel):
``tridiag_solve_scan`` (the Thomas recurrence differentiated by autograd,
no custom Function: the oracle of the custom VJPs),
``tridiag_solve_unrolled`` (the reference's loop, one Python iteration a
row) and ``thomas_solve_reference`` (the reference's eps'd Thomas, an
exact solve on ``b + eps``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import kernels

__all__ = ["tridiag_solve", "tridiag_solve_plain", "tridiag_solve_pcr",
           "tridiag_solve_pcr_fused", "thomas_solve_op",
           "pcr_factor", "pcr_apply", "tridiag_adjoint",
           "tridiag_adjoint_plain", "tridiag_inverse_operator",
           "tridiag_solve_precomputed", "tridiag_solve_with_operator",
           "set_default_impl", "gemm_route", "tridiag_solve_scan",
           "tridiag_solve_unrolled", "thomas_solve_reference", "MAX_N",
           "partition_factor", "partition_apply", "rows_a_lane",
           "launch_layout"]

# csrc/thomas.cu's tiling, checked against thomas_layout() for every N at
# the first bind.  A line is one warp.  Up to SHORT_N rows: one row a lane
# or two past 32, PCR's factors in the warp's registers, LINES lines a
# block, STAGE images a stage, a ring of BUFFERS stages.  Past it: m =
# ``rows_a_lane(N)`` rows a lane (partition + PCR), the factors (and K3's
# band sums) in shared memory, LONG_STAGE images a stage, LONG_BUFFERS
# stages, and the most of 8, 4, 2, 1 lines a block that fits SMEM_LIMIT.
# MAX_N: the longest line whose K3 block of one line fits (kMaxN).
SHORT_N = 64           # kShortN
LINES = 8              # band lines a block, one warp each (kLines)
STAGE = 8              # images a pipeline stage (kStage)
BUFFERS = 3            # stage buffers a ring (kBufs)
LONG_STAGE = 4         # kLongStage
LONG_BUFFERS = 2       # kLongBufs
COEFS, SUMS = 4, 3     # floats a row: f, g, c', a'; K3's three band sums
MAX_N = 1440
BLOCKS_PER_SM = 2      # the grid the chunk size aims for
SMEM_LIMIT = 232_448   # bytes of shared memory a block may use on Hopper
_SHAPE_ARGS = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_void_p]
_ARGTYPES = [ctypes.c_void_p] * 5 + _SHAPE_ARGS
_ADJOINT_ARGTYPES = [ctypes.c_void_p] * 10 + _SHAPE_ARGS
_sm_count: dict = {}
_layout_checked = False


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


def tridiag_solve_scan(a, b, c, d):
    """The Thomas recurrence along the last axis, differentiated by
    autograd through its elementwise ops (no custom Function): the oracle
    that the custom VJPs (K3, ``_PlainSolve``) are held against."""
    return _thomas_last_axis(a, b, c, d)


def tridiag_solve_unrolled(a, b, c, d):
    """The reference's loop structure, one Python iteration a row
    (mnist_test.py:176-196).  PyTorch has no scan to trace, so this is the
    recurrence of ``tridiag_solve_scan``; kept under the JAX package's
    name for the oracles' callers."""
    return _thomas_last_axis(a, b, c, d)


def thomas_solve_reference(a, b, c, d, eps=1e-6):
    """The reference-facing entry point: Thomas with ``eps`` added into
    every denominator (mnist_test.py:169,177), i.e. an exact solve on
    ``b + eps``; plain PyTorch with the custom VJP ('scan') on every
    device."""
    return tridiag_solve(a, b + eps, c, d, impl="scan")


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


def _long_bytes(n, lines, arrays):
    """Shared memory of a block of the long-line kernel (csrc/thomas.cu::
    long_floats): every row's factors (K3 also its band sums), then
    ``arrays`` rings of LONG_BUFFERS stages of LONG_STAGE images, each
    image (lines + 1)·33·m floats (32·m rows and a pad word every 32)."""
    m = rows_a_lane(n)
    return 4 * ((COEFS + (SUMS if arrays == 2 else 0)) * lines * 32 * m
                + arrays * LONG_BUFFERS * LONG_STAGE * 33 * m * (lines + 1))


def launch_layout(n, arrays=1):
    """(lines a block, images a stage, stage buffers, shared-memory bytes a
    block) of K1 (``arrays`` 1: d) or K3 (2: g and x) on lines of ``n``
    rows, as csrc/thomas.cu::thomas_layout reports them.  Raises outside
    [1, MAX_N]."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"thomas: line length {n} outside [1, {MAX_N}]")
    if n <= SHORT_N:
        return (LINES, STAGE, BUFFERS,
                4 * BUFFERS * arrays * STAGE * (LINES + 1) * n)
    lines = 8
    while lines > 1 and _long_bytes(n, lines, arrays) > SMEM_LIMIT:
        lines //= 2
    return lines, LONG_STAGE, LONG_BUFFERS, _long_bytes(n, lines, arrays)


def _plan(batch, p, n, q, sms, arrays=1):
    """(images a block, chunks, shared-memory bytes) of a launch: chunks of
    consecutive images sized so that the grid of band tiles × chunks has
    about ``BLOCKS_PER_SM`` blocks on each of ``sms`` SMs where the batch
    allows it, with ``launch_layout``'s lines a block.  ``arrays``: 1 for K1
    (d), 2 for K3 (g and x).  Raises if the budget passes what a block
    may use."""
    lines, _, _, smem = launch_layout(n, arrays)
    tiles = -(-p // lines) if q == 1 else p * -(-q // lines)
    chunk = max(1, batch // -(-BLOCKS_PER_SM * sms // tiles))
    if smem > SMEM_LIMIT:
        raise ValueError(f"thomas: {smem} bytes of shared memory a block "
                         f"(limit {SMEM_LIMIT})")
    return chunk, -(-batch // chunk), smem


def _sms(device):
    if device.index not in _sm_count:
        _sm_count[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sm_count[device.index]


def _bind(symbol, argtypes):
    """The C entry point ``symbol`` of csrc/thomas.cu.  At the first bind,
    raise unless the kernel's tiling at every N in [1, MAX_N], for K1 and
    K3, is the one ``_plan`` sizes launches and shared memory with, and
    unless the kernel refuses MAX_N + 1."""
    global _layout_checked
    if not _layout_checked:
        report = kernels.function(
            "thomas", "thomas_layout",
            [ctypes.c_int, ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
            + [ctypes.POINTER(ctypes.c_longlong)])
        vals = [ctypes.c_int() for _ in range(3)] + [ctypes.c_longlong()]
        ptrs = list(map(ctypes.byref, vals))
        for n in range(1, MAX_N + 2):
            for arrays in (1, 2):
                code = report(n, arrays - 1, *ptrs)
                got = tuple(v.value for v in vals) if code == 0 else None
                want = launch_layout(n, arrays) if n <= MAX_N else None
                if got != want:
                    raise RuntimeError(
                        f"thomas.cu tiles (lines, stage, buffers, bytes) at "
                        f"N = {n}, {arrays} arrays: {got}; the wrapper "
                        f"plans for {want}")
        _layout_checked = True
    return kernels.function("thomas", symbol, argtypes)


def _thomas_kernel(a, b, c, d, dim):
    """K1 on CUDA tensors."""
    batch, p, n, q = _line_shape("tridiag_solve", a, b, c, d, dim)
    kernels.check_float32("tridiag_solve", d.device, a=a, b=b, c=c, d=d)
    x = torch.empty_like(d)
    if batch == 0:
        return x
    chunk = _plan(batch, p, n, q, _sms(d.device))[0]
    fn = _bind("thomas_solve", _ARGTYPES)
    with torch.cuda.device(d.device):
        code = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
                  x.data_ptr(), batch, p, n, q, chunk,
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
    chunk, chunks, _ = _plan(batch, p, n, q, _sms(g.device), arrays=2)
    partials = torch.empty((chunks, 3, *a.shape), dtype=torch.float32,
                           device=g.device)
    fn = _bind("thomas_adjoint", _ADJOINT_ARGTYPES)
    with torch.cuda.device(g.device):
        code = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), g.data_ptr(),
                  x.data_ptr(), lam.data_ptr(), ga.data_ptr(), gb.data_ptr(),
                  gc.data_ptr(), partials.data_ptr(), batch, p, n, q, chunk,
                  kernels.stream_handle(g.device))
    kernels.raise_on_error("tridiag_adjoint", code)
    tridiag_adjoint.launches += 1
    return lam, ga, gb, gc


tridiag_adjoint.launches = 0


torch.library.define(
    "cnn_pde_tpu_torch::thomas_solve",
    "(Tensor a, Tensor b, Tensor c, Tensor d, int dim) -> Tensor")


@torch.library.impl("cnn_pde_tpu_torch::thomas_solve", ("cpu", "cuda"))
def _thomas_solve_impl(a, b, c, d, dim):
    """K1 as a registered op, so that ``torch.export`` can trace a forward
    that reaches it: on a CUDA tensor the kernel (or, inside
    ``plain_versions()``, its plain version), on a CPU tensor the plain
    version.  Its output has d's shape, contiguous."""
    if kernels.use_kernel(d):
        return _thomas_kernel(a, b, c, d, dim)
    return tridiag_solve_plain(a, b, c, d, dim).contiguous()


@torch.library.register_fake("cnn_pde_tpu_torch::thomas_solve")
def _(a, b, c, d, dim):
    return torch.empty_like(d, memory_format=torch.contiguous_format)


# the op's overload itself: calling it costs one dispatch (a
# ``custom_op``'s Python wrapper costs about five times as much a call)
thomas_solve_op = torch.ops.cnn_pde_tpu_torch.thomas_solve.default


class _PlainSolve(torch.autograd.Function):
    """A solve by one of the JAX package's XLA solvers ('scan', 'pcr',
    'pcr2'), plain PyTorch on any device, with the JAX custom VJP: λ =
    T⁻ᵀg by the same solver, then the band gradients."""

    @staticmethod
    def forward(ctx, a, b, c, d, dim, impl):
        x = _plain_solve(impl, a, b, c, d, dim)
        ctx.dim, ctx.impl = dim, impl
        ctx.save_for_backward(a, b, c, x)
        return x

    @staticmethod
    def backward(ctx, g):
        a, b, c, x = ctx.saved_tensors
        lam = _plain_solve(ctx.impl, *_transpose_system(a, b, c, ctx.dim), g,
                           ctx.dim)
        return (*_adjoint_band_grads(a, b, c, x, lam, ctx.dim), lam, None,
                None)


def _plain_solve(impl, a, b, c, d, dim):
    if impl == "scan":
        return tridiag_solve_plain(a, b, c, d, dim)
    solve = tridiag_solve_pcr if impl == "pcr" else tridiag_solve_pcr_fused
    a, b, c, d = (t.movedim(dim, -1) for t in (a, b, c, d))
    return solve(a, b, c, d).movedim(-1, dim)


class _TridiagSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, c, d, dim):
        ctx.kernel = kernels.use_kernel(d)
        x = thomas_solve_op(a, b, c, d, dim)
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


def tridiag_solve(a, b, c, d, dim=-1, impl=None):
    """x = T⁻¹d along axis ``dim`` of the band shape: K1 on a CUDA tensor,
    the plain version on a CPU tensor; differentiable in all four inputs
    (K3 or its plain version).  ``impl`` (one of ``set_default_impl``'s)
    chooses the solver for this call alone; None takes the global
    default.  'scan', 'pcr' and 'pcr2' are plain PyTorch on every device
    and launch no kernel; 'matinv' and 'matinv_bf16' build an inverse
    operator from the bands at this call and apply it by a GEMM, as the
    JAX impls do."""
    impl = _DEFAULT_IMPL if impl is None else impl
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {_IMPLS}")
    if impl in ("auto", "pallas"):
        return _TridiagSolve.apply(a, b, c, d, dim)
    if impl in ("scan", "pcr", "pcr2"):
        return _PlainSolve.apply(a, b, c, d, dim, impl)
    dtype = torch.bfloat16 if impl == "matinv_bf16" else d.dtype
    a, b, c, d = (t.movedim(dim, -1) for t in (a, b, c, d))
    X = tridiag_inverse_operator(a, b, c, dtype)
    return tridiag_solve_precomputed(a, b, c, d, X).movedim(-1, dim)


tridiag_solve.launches = 0


def _shift(x, s, fill, down):
    """x[i - s] (``down``) or x[i + s] along the last axis, ``fill``
    outside the line."""
    n = x.shape[-1]
    pad = torch.full_like(x[..., :1], fill).expand(*x.shape[:-1], min(s, n))
    if down:
        return torch.cat([pad, x], dim=-1)[..., :n]
    return torch.cat([x, pad], dim=-1)[..., -n:]


def pcr_factor(a, b, c, dim=-1):
    """PCR's batch-free phase along ``dim``: ([α_l], [γ_l], b_L) for the
    levels l < max(1, ceil(log2 N)) with stride s = 2^l, α_l[i] =
    −a_l[i]/b_l[i−s] and γ_l[i] = −c_l[i]/b_l[i+s] (out-of-range b is 1),
    and the bands reduced level by level.  The phase K1 and K3 run once a
    block (keeping 1/b_L)."""
    a, b, c = (t.movedim(dim, -1) for t in (a, b, c))
    n = b.shape[-1]
    zero = torch.zeros_like(a[..., :1])
    a = torch.cat([zero, a[..., 1:]], dim=-1)
    c = torch.cat([c[..., :-1], zero], dim=-1)
    alphas, gammas = [], []
    s = 1
    for _ in range(max(1, (n - 1).bit_length())):
        alpha = -a / _shift(b, s, 1.0, True)
        gamma = -c / _shift(b, s, 1.0, False)
        a, b, c = (
            alpha * _shift(a, s, 0.0, True),
            b + alpha * _shift(c, s, 0.0, True)
            + gamma * _shift(a, s, 0.0, False),
            gamma * _shift(c, s, 0.0, False),
        )
        alphas.append(alpha.movedim(-1, dim))
        gammas.append(gamma.movedim(-1, dim))
        s *= 2
    return alphas, gammas, b.movedim(-1, dim)


def pcr_apply(factors, d, dim=-1):
    """PCR's per-image phase: d ← d + α_l·d[i−s] + γ_l·d[i+s] for each level
    (out-of-range d is 0), then x = d/b_L.  ``factors`` from ``pcr_factor``
    broadcast against ``d``.  K1 and K3 multiply by 1/b_L, formed once a
    block, so that no division is left per image: one rounding apart.  The
    division keeps this the arithmetic the fused kernels' plain versions
    have always used."""
    alphas, gammas, b = factors
    d = d.movedim(dim, -1)
    s = 1
    for alpha, gamma in zip(alphas, gammas):
        d = (d + alpha.movedim(dim, -1) * _shift(d, s, 0.0, True)
             + gamma.movedim(dim, -1) * _shift(d, s, 0.0, False))
        s *= 2
    return (d / b.movedim(dim, -1)).movedim(-1, dim)


def rows_a_lane(n):
    """Rows each lane of a warp owns on a line of ``n`` rows in the
    kernels' partitioned scheme: ⌈n/32⌉, but 32 in place of 31 (csrc/
    thomas.cu pads every 32nd row in shared memory, and a stride of 31
    rows would put a warp's 32 lanes on one bank)."""
    m = -(-n // 32)
    return 32 if m == 31 else m


def partition_factor(a, b, c, dim=-1):
    """The batch-free phase of K1's and K3's scheme for lines longer than
    ``SHORT_N`` rows, along ``dim``.  The line is padded with identity rows
    to 32·m rows (m = ``rows_a_lane``) and cut into 32 partitions of m
    consecutive rows, one a lane.  Within a partition (rows s..e) the
    modified Thomas elimination (PaScaL_TDMA) leaves every row i > s as
    a'ᵢ·x_s + xᵢ + c'ᵢ·x_{i+1} = d'ᵢ with d'ᵢ = fᵢ·dᵢ − gᵢ·d'_{i−1}; the
    upward pass, done on the factors alone, turns rows s and e into the
    64-row interface system in (x_s, x_e) of all partitions, which
    ``pcr_factor`` factors.  Returns a dict of the per-row factors f, g,
    c', a' (shape (*S', 32, m), S' the band shape without the line
    axis), ρ and ρ·c'_s for row s's right-hand side ((*S', 32)), the
    interface's PCR factors, and n.  The mirror of the kernels' factor
    phase, which runs once a block."""
    a, b, c = (t.movedim(dim, -1) for t in (a, b, c))
    n = b.shape[-1]
    m = rows_a_lane(n)
    pad = 32 * m - n

    def rows(t, first_zero, last_zero, fill):
        if first_zero:
            t = torch.cat([torch.zeros_like(t[..., :1]), t[..., 1:]], -1)
        if last_zero:
            t = torch.cat([t[..., :-1], torch.zeros_like(t[..., :1])], -1)
        t = torch.cat([t, torch.full_like(t[..., :1], fill).expand(
            *t.shape[:-1], pad)], -1)
        return t.reshape(*t.shape[:-1], 32, m)
    lo, di, up = rows(a, True, False, 0.0), rows(b, False, False, 1.0), \
        rows(c, False, True, 0.0)
    f, g, cp, ap = [], [], [], []
    for j in range(m):
        if j < 2:
            r = 1.0 / di[..., j]
            gj = torch.zeros_like(r)
            apj = lo[..., j] * r
        else:
            r = 1.0 / (di[..., j] - lo[..., j] * cp[j - 1])
            gj = lo[..., j] * r
            apj = -gj * ap[j - 1]
        f.append(r)
        g.append(gj)
        cp.append(up[..., j] * r)
        ap.append(apj)
    # row s+1 in final form, x_{s+1} = d''_{s+1} − A·x_s − C·x_e
    A, C = ap[m - 2], cp[m - 2]
    for j in range(m - 3, 0, -1):
        A, C = ap[j] - cp[j] * A, -cp[j] * C
    rho = 1.0 / (1.0 - cp[0] * A)
    rhoc = rho * cp[0]
    lo2 = torch.stack([rho * ap[0], ap[m - 1]], -1).flatten(-2)
    up2 = torch.stack([-rhoc * C, cp[m - 1]], -1).flatten(-2)
    return {"f": torch.stack(f, -1), "g": torch.stack(g, -1),
            "cp": torch.stack(cp, -1), "ap": torch.stack(ap, -1),
            "rho": rho, "rhoc": rhoc,
            "interface": pcr_factor(lo2, torch.ones_like(lo2), up2),
            "n": n}


def partition_apply(factors, d, dim=-1):
    """The per-image phase for ``partition_factor``'s factors: the
    downward pass d'ᵢ = fᵢ·dᵢ − gᵢ·d'_{i−1} with the dot product
    Σ πᵢ·d'ᵢ that gives row s's right-hand side (π_{s+1} = 1,
    π_{i+1} = −c'ᵢ·πᵢ, over rows s+1..e−1), the interface solve by
    ``pcr_apply``, then xᵢ = d'ᵢ − a'ᵢ·x_s − c'ᵢ·x_{i+1} upward from
    row e−1.  No division; the arithmetic of the kernels' per-image path
    up to fma contraction and PCR's final division (a product by 1/b_L
    there)."""
    n = factors["n"]
    f, g, cp, ap = (factors[k] for k in ("f", "g", "cp", "ap"))
    m = f.shape[-1]
    d = d.movedim(dim, -1)
    d = torch.cat([d, d.new_zeros(*d.shape[:-1], 32 * m - n)], -1)
    d = d.reshape(*d.shape[:-1], 32, m)
    prev = torch.zeros_like(d[..., 0])
    acc = torch.zeros_like(prev)
    pi = torch.ones_like(f[..., 0])
    dp = []
    for j in range(m):
        prev = f[..., j] * d[..., j] - g[..., j] * prev
        dp.append(prev)
        if 1 <= j <= m - 2:
            acc = acc + pi * prev
            pi = -cp[..., j] * pi
    rhs = torch.stack([factors["rho"] * dp[0] - factors["rhoc"] * acc,
                       dp[m - 1]], -1).flatten(-2)
    xi = pcr_apply(factors["interface"], rhs).unflatten(-1, (32, 2))
    xs, nxt = xi[..., 0], xi[..., 1]
    x = [None] * m
    x[0], x[m - 1] = xs, nxt
    for j in range(m - 2, 0, -1):
        nxt = dp[j] - ap[..., j] * xs - cp[..., j] * nxt
        x[j] = nxt
    x = torch.stack(x, -1).flatten(-2)[..., :n]
    return x.movedim(-1, dim)


def tridiag_solve_pcr(a, b, c, d):
    """Parallel cyclic reduction along the last axis: ``pcr_factor`` then
    ``pcr_apply``.  The band reduction is batch-free when (a, b, c)
    broadcast against a batched d; only the d-update runs at batch size."""
    return pcr_apply(pcr_factor(a, b, c), d)


def tridiag_solve_pcr_fused(a, b, c, d):
    """PCR along the last axis with the batched right-hand side updated in
    fused level pairs — the port of the JAX ``tridiag_solve_pcr_fused``
    ('pcr2').  The coefficient chain stays batch-free (``pcr_factor``'s
    levels); two consecutive levels (α₁, γ₁, s) and (α₂, γ₂, 2s) compose
    into one 7-tap pass over d with the batch-free weights
    w[∓3s] = α₂·α₁[i−2s] | γ₂·γ₁[i+2s], w[∓2s] = α₂ | γ₂,
    w[−s] = α₁ + α₂·γ₁[i−2s], w[+s] = γ₁ + γ₂·α₁[i+2s];
    an odd count of levels ends with one single level.  The same system
    as ``tridiag_solve_pcr``, summed in another order."""
    alphas, gammas, b = pcr_factor(a, b, c)
    i, s = 0, 1
    while i < len(alphas):
        a1, g1 = alphas[i], gammas[i]
        if i + 1 < len(alphas):
            a2, g2 = alphas[i + 1], gammas[i + 1]
            w_m3 = a2 * _shift(a1, 2 * s, 0.0, True)
            w_m1 = a1 + a2 * _shift(g1, 2 * s, 0.0, True)
            w_p1 = g1 + g2 * _shift(a1, 2 * s, 0.0, False)
            w_p3 = g2 * _shift(g1, 2 * s, 0.0, False)
            d = (d
                 + w_m1 * _shift(d, s, 0.0, True)
                 + w_p1 * _shift(d, s, 0.0, False)
                 + a2 * _shift(d, 2 * s, 0.0, True)
                 + g2 * _shift(d, 2 * s, 0.0, False)
                 + w_m3 * _shift(d, 3 * s, 0.0, True)
                 + w_p3 * _shift(d, 3 * s, 0.0, False))
            i, s = i + 2, 4 * s
        else:
            d = (d + a1 * _shift(d, s, 0.0, True)
                 + g1 * _shift(d, s, 0.0, False))
            i, s = i + 1, 2 * s
    return d / b


def _adjoint_band_partials(lam, x, dim, chunk):
    """K3's in-block band sums: for each chunk of ``chunk`` consecutive
    images of λ and x (both (batch, *S)), Σ λ[i]x[i−1], Σ λx and
    Σ λ[i]x[i+1] accumulated in image order; shape (chunks, 3, *S)."""
    lam_l, x_l = lam.movedim(dim, -1), x.movedim(dim, -1)
    prods = torch.stack([lam_l * _shift(x_l, 1, 0.0, True), lam_l * x_l,
                         lam_l * _shift(x_l, 1, 0.0, False)], dim=1)
    partials = []
    for start in range(0, prods.shape[0], chunk):
        acc = prods[start]
        for n in range(start + 1, min(start + chunk, prods.shape[0])):
            acc = acc + prods[n]
        partials.append(acc)
    return torch.stack(partials).movedim(-1, dim)


def _sum_band_partials(partials, slices=8):
    """K3's second pass: (grad_a, grad_b, grad_c) = −Σ of the chunks'
    partials in the kernel's fixed order: slice k sums chunks k, k + slices,
    … in order, then the slices are added in order."""
    sums = []
    for k in range(min(slices, partials.shape[0])):
        acc = partials[k]
        for part in partials[k + slices::slices]:
            acc = acc + part
        sums.append(acc)
    total = sums[0]
    for acc in sums[1:]:
        total = total + acc
    return tuple(-total[j] for j in range(3))


# ---- inverse-operator solves (the AMP grade) --------------------------------

_DEFAULT_IMPL = "auto"
_IMPLS = ("scan", "pcr", "pcr2", "matinv", "matinv_bf16", "pallas", "auto")
# aten::bmm.dtype (bf16 operands, a float32 result) has a CUDA kernel from
# torch 2.8 on; no CPU kernel
_BMM_OUT_DTYPE_FROM = (2, 8)


def set_default_impl(impl: str) -> str:
    """The solver ``tridiag_solve`` runs, the JAX package's seven names:
    'auto' and 'pallas' (the JAX TPU kernel: here K1 and K3, or their
    plain versions on a CPU tensor); 'scan' (the Thomas recurrence,
    ``tridiag_solve_plain``), 'pcr' (``tridiag_solve_pcr``) and 'pcr2'
    (``tridiag_solve_pcr_fused``), plain PyTorch on every device, their
    backward λ = T⁻ᵀg by the same solver; 'matinv' (an inverse operator
    at the RHS's dtype, built at each call, applied by one GEMM; the
    backward one transposed GEMM) or 'matinv_bf16' (the operator and the
    GEMM's operands in bf16, float32 accumulation).  ``enable_amp``
    leaves this default as it is.  Returns the previous setting."""
    global _DEFAULT_IMPL
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {_IMPLS}")
    prev, _DEFAULT_IMPL = _DEFAULT_IMPL, impl
    return prev


def _torch_version():
    return tuple(int(p) for p in
                 torch.__version__.split("+")[0].split(".")[:2])


def gemm_route(dtype, device) -> str:
    """How an operator of ``dtype`` is applied on ``device``: 'f32' (a
    float32 GEMM, full float32: the port never enables TF32),
    'bmm_out_dtype' (a CUDA device: bf16 operands on the tensor cores,
    float32 accumulation and result) or 'bf16_rounded_f32' (the operands
    rounded to bf16, then a float32 GEMM: every product is exact in
    float32, so it computes the same sums; the CPU's route, the plain
    version inside ``plain_versions()``, and a torch without
    ``bmm(out_dtype=)``)."""
    if dtype != torch.bfloat16:
        return "f32"
    if (torch.device(device).type == "cuda"
            and not kernels.in_plain_versions()
            and _torch_version() >= _BMM_OUT_DTYPE_FROM):
        return "bmm_out_dtype"
    return "bf16_rounded_f32"


def _bmm(a, b):
    """a @ b over a leading batch, at ``b``'s grade (``gemm_route``)."""
    route = gemm_route(b.dtype, a.device)
    if route == "f32":
        return torch.bmm(a, b)
    a = a.to(torch.bfloat16)
    if route == "bmm_out_dtype":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _inv_apply(X, d, transpose):
    """Σ_k d[..., k]·X[..., k, i] (or, ``transpose``, Σ_i X[..., k, i]·
    d[..., i]) along the last axis: X (*rows, N, N) is batch-free and d
    (*batch, *rows, N); one GEMM a row, (batch, N) by (N, N), in one bmm.
    The result is float32 at d's shape."""
    n = X.shape[-1]
    rows = X.shape[:-2]
    if tuple(d.shape[d.ndim - 1 - len(rows):-1]) != tuple(rows) \
            or d.shape[-1] != n:
        raise ValueError(f"operator {tuple(X.shape)} does not fit "
                         f"{tuple(d.shape)}")
    R = math.prod(rows)
    Xm = X.reshape(R, n, n)
    if transpose:
        Xm = Xm.transpose(-1, -2)
    dm = d.reshape(-1, R, n).transpose(0, 1)
    return _bmm(dm, Xm).transpose(0, 1).reshape(d.shape)


_IDENTITY: dict = {}


def _identity_rhs(n, rows, device):
    """The identity as K1's right-hand side, (N, rows, N) with
    [k, r, i] = δ(k, i): made once for each (device, N, rows) and kept,
    since every build of a stack of that shape reads the same one.  Not
    kept while ``torch.export`` traces: its tensors are not real."""
    key = (torch.device(device), n, rows)
    if key in _IDENTITY:
        return _IDENTITY[key]
    eye = torch.eye(n, dtype=torch.float32, device=device)
    rhs = eye[:, None, :].expand(n, rows, n).contiguous()
    if not torch.compiler.is_compiling():
        _IDENTITY[key] = rhs
    return rhs


def tridiag_inverse_operator(a, b, c, dtype=torch.float32):
    """X (*S, N, N) with X[..., k, i] = (T⁻¹)[i, k] for the bands (*S, N),
    solved along the last axis in float32 and stored at ``dtype``.  On a
    CUDA tensor one K1 launch: the bands as (R, N) lines and the identity
    (N, R, N) as the right-hand side of batch N; on a CPU tensor the plain
    Thomas recurrence.  K1 writes the solutions image-major, (N, R, N); one
    copy puts them row-major and casts them to ``dtype``.  X carries no
    gradient (the solves that use it take their band gradients from the
    bands)."""
    shape, n = tuple(b.shape), b.shape[-1]
    with torch.no_grad():
        a, b, c = (t.detach().reshape(-1, n).float().contiguous()
                   for t in (a, b, c))
        rhs = _identity_rhs(n, b.shape[0], b.device)
        x = thomas_solve_op(a, b, c, rhs, -1)
        # x[k, r, i] = (T_r⁻¹)[i, k] = X[r, k, i]
        X = torch.empty((*shape, n), dtype=dtype, device=b.device)
        X.view(-1, n, n).copy_(x.transpose(0, 1))
        return X


def _band_product(a, b, c, x):
    """T·x along the last axis (a[0] and c[N−1] outside the matrix)."""
    zero = torch.zeros_like(x[..., :1])
    x_lo = torch.cat([zero, x[..., :-1]], dim=-1)
    x_hi = torch.cat([x[..., 1:], zero], dim=-1)
    return b * x + a * x_lo + c * x_hi


class _SolvePrecomputed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, c, d, X):
        x = _inv_apply(X, d, transpose=False)
        ctx.save_for_backward(a, b, c, x, X)
        return x

    @staticmethod
    def backward(ctx, g):
        a, b, c, x, X = ctx.saved_tensors
        lam = _inv_apply(X, g, transpose=True)  # λ = T⁻ᵀg, one GEMM
        ga, gb, gc = _adjoint_band_grads(a, b, c, x, lam)
        # X gets a zero gradient: the exact solve's derivative depends on
        # the bands, not on the inverse's representation
        gX = torch.zeros_like(X) if ctx.needs_input_grad[4] else None
        return ga, gb, gc, lam, gX


def tridiag_solve_precomputed(a, b, c, d, X):
    """x = T⁻¹d along the last axis with X from ``tridiag_inverse_operator``
    of the same bands (b with its eps): one GEMM forward; backward one
    transposed GEMM for λ = T⁻ᵀg and the band gradients from λ and x,
    summed over the batch onto the bands' shapes; X's gradient is zero.
    The port of the JAX ``tridiag_solve_precomputed`` and its custom VJP."""
    return _SolvePrecomputed.apply(a, b, c, d, X)


class _ApplyInverse(torch.autograd.Function):
    """x = X·d, differentiable in d alone (grad_d = Xᵀ·g, one GEMM)."""

    @staticmethod
    def forward(ctx, X, d):
        ctx.save_for_backward(X)
        return _inv_apply(X, d, transpose=False)

    @staticmethod
    def backward(ctx, g):
        (X,) = ctx.saved_tensors
        return None, _inv_apply(X, g, transpose=True)


def tridiag_solve_with_operator(a, b, c, d, X):
    """The implicit-function form with one Richardson refinement, x₀ = X·d
    and x = x₀ + X·(d − T·x₀), with X and x₀ detached: two GEMMs forward,
    gradients by autograd through the residual (grad_d and the bands'
    from λ = Xᵀg), none into X.  The port of the JAX
    ``tridiag_solve_with_operator`` (``hoisted_refine=True``)."""
    X = X.detach()
    with torch.no_grad():
        x0 = _inv_apply(X, d, transpose=False)
    return x0 + _ApplyInverse.apply(X, d - _band_product(a, b, c, x0))
