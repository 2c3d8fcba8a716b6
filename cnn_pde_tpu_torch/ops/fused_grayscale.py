"""K6: a whole GrayscaleDiffusion eval forward in one C call, and its plain
version.  The same call with a residual output is K7, the trainable
forward (``ops/fused_grayscale_vjp.py``).

Counterpart of ``cnn_pde_tpu/ops/pallas_fused_adi.py::
fused_grayscale_diffusion_fwd``.  Per Strang step: x(dt/2) at ts[s, 0],
y(dt) at ts[s, 1], x(dt/2) at ts[s, 2], each with the coefficient field
clamped below at eps (``max(raw, eps)``: no upper clamp) and smoothed by
``smooth3`` along the sweep axis (W for x, H for y).  The plain version runs
the same steps with the TPU kernel's own sweep (``_abc_smooth`` + PCR, as
``_sweep_rows`` does).  The kernels (``csrc/fused_grayscale.cu``) solve the
same systems by a twisted Thomas recurrence split in two: a first kernel
makes the factors of every sweep of the layer once a call, batch-free (a
table of m, piv and r a row, each line factored from both ends toward its
middle row); the second keeps each block's images in shared memory for
every step and applies the factors, two threads a (line, image) that meet
in the middle.  ``gray_factors`` and ``gray_solve`` are the plain mirror of
that arithmetic, which the CPU tests hold against the TPU kernel's sweeps;
``plan_grayscale`` spreads the batch over the blocks.

Two schemes, chosen by shape at launch (``choose_gray_scheme``): the first
(``csrc/fused_grayscale.cu``, ``fused_grayscale_vjp.cu``) keeps a tile of
whole images and a ring of factor buffers in one block's shared memory
(H, W ≤ SHARED_MAX_N = 64, which every such shape fits); the wide scheme
(``csrc/fused_grayscale_wide.cu``, a ``GrayWidePlan``) takes every other
shape up to H, W ≤ MAX_N (K1/K3's 1,440).  It keeps the same factor table,
whole, in device memory (3·S·``slab_floats(H, W)`` floats: 3.35 MB at
96 × 96 and 10 steps, about 0.75 GB at 1,440 × 1,440; the wrapper checks it
with the workspace against the card's free memory and raises, naming the
bytes, where they do not fit), built by a factor kernel that reads the
clamped fields from device memory, two threads a line across as many
blocks as the lines need; a block then walks its tile's images one at a
time with the state in device memory, two threads a line, staging each
sweep's factors and x-line state in shared memory a strip of lines at a
time (``strip_lines``).

K6 is registered as the op ``cnn_pde_tpu_torch::fused_grayscale_fwd``
(``fused_grayscale_fwd_op``, with a fake implementation), so that
``torch.export`` traces an eval forward that reaches it; the wrapper calls
it on every device (its CPU implementation is the plain version).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import kernels
from .fused_channel import (WIDE_BLOCKS_PER_SM, WIDE_WORKSPACE_BUDGET,
                            _abc_nosmooth, _dt_factors, check_limits,
                            check_workspace)
from .smoothing import smooth3
from .tridiag import MAX_N as TRIDIAG_MAX_N
from .tridiag import _sms, tridiag_solve_pcr

__all__ = ["fused_grayscale_diffusion_fwd", "fused_grayscale_diffusion_plain",
           "fused_grayscale_fwd_op", "choose_gray_scheme",
           "GrayPlan", "plan_grayscale", "GrayWidePlan", "gray_wide_plan",
           "gray_factors", "gray_solve"]

SHARED_MAX_N = 64       # the first scheme's rows a line: an image a block
MAX_N = TRIDIAG_MAX_N   # the wide scheme's, and so the wrappers': 1,440
MAX_SMEM = 232_448      # bytes a block may use on Hopper
# csrc/grayscale_lines.cuh: threads a block of a main kernel
MIN_THREADS, MAX_THREADS = 256, 512
# images a block (csrc/grayscale_lines.cuh::kMaxTile): past 4·SMs images
# two blocks of 4 an SM beat one of 8 (K8 by a sixth at B = 1024)
MAX_TILE = 4
# image buffers a block image: K6/K7 the state and its copy; K8 the
# cotangent, x1, x2, the step's input and its output
FWD_BUFFERS, BWD_BUFFERS = 2, 5
# factor buffers a block (csrc/fused_grayscale.cu::kRing; K8 two)
FWD_RING, BWD_RING = 4, 2
# the wide scheme (csrc/fused_grayscale_wide.cu::kMaxThreads, kMinThreads,
# kSmemBudget: two blocks an SM)
WIDE_MAX_THREADS, WIDE_MIN_THREADS = 512, 64
WIDE_SMEM_BUDGET = 113 * 1024
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
             + [ctypes.c_float] * 3 + [ctypes.c_void_p])
_WIDE_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                  + [ctypes.c_float] * 3 + [ctypes.c_void_p])
_layout_checked: set = set()  # (source, shape, plan) held against the C side


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
    """Raise on anything the grayscale kernels (K6, K7, K8) take in neither
    scheme; past MAX_N a ``ValueError`` that names it."""
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
    check_limits(name, 1, H, W)


def gray_factors(field, dtfac, eps):
    """Plain mirror of csrc/grayscale_lines.cuh::factor_table along the last
    axis: the table slots (m, piv, r) of the sweep system of a clamped
    coefficient field, smoothed along that axis and scaled by ``dtfac``
    into r (``_abc_smooth``'s a = c = -r), factored from both ends toward
    the twist row k = n // 2: piv[i] = 1/d[i] with d[i] = b[i] - r[i]
    m[i-1] for i < k and d[i] = b[i] - r[i] m[i+1] for i > k, m[i] =
    r[i] piv[i], and at k the twist pivot b[k] - r[k] (m[k-1] + m[k+1])."""
    r = smooth3(field) * dtfac
    n = r.shape[-1]
    k = n // 2
    zero = torch.zeros_like(r[..., 0])
    piv, m = [zero] * n, [zero] * n

    def row(i, m_next):
        rc = r[..., i]
        b = (1.0 + rc if i in (0, n - 1) else 1.0 + 2.0 * rc) + eps
        piv[i] = 1.0 / (b - rc * m_next)
        m[i] = rc * piv[i]
        return m[i]

    mt = zero
    for i in range(k):
        mt = row(i, mt)
    mb = zero
    for i in range(n - 1, k, -1):
        mb = row(i, mb)
    row(k, mt + mb)
    return torch.stack(m, dim=-1), torch.stack(piv, dim=-1), r


def gray_solve(factors, d, transpose=False):
    """Plain mirror of csrc/grayscale_lines.cuh::twisted_line: x = T⁻¹d
    (or, with ``transpose``, T⁻ᵀd) along the last axis from a
    ``gray_factors`` table, broadcast over d's leading axes.  Rows 0..k-1
    are eliminated downward and rows n-1..k+1 upward (for T: v[i] =
    piv[i] d[i] + m[i] v[i∓1]; for Tᵀ, whose pivots are T's: v[i] =
    piv[i] (d[i] + r[i∓1] v[i∓1])); row k takes both ends' last values;
    then each half is substituted back outward from k."""
    m, piv, r = factors
    n = d.shape[-1]
    k = n // 2
    v = [None] * n

    def eliminate(rows, step):
        acc = torch.zeros_like(d[..., 0])
        for c, i in enumerate(rows):
            term = piv[..., i] * d[..., i]
            if c > 0:
                lo = (r[..., i - step] * piv[..., i] if transpose
                      else m[..., i])
                term = lo * acc + term
            acc = v[i] = term
        return acc

    va = eliminate(range(k), 1)
    vb = eliminate(range(n - 1, k, -1), -1)
    if transpose:
        s = d[..., k]
        if k > 0:
            s = r[..., k - 1] * va + s
        if k + 1 < n:
            s = r[..., k + 1] * vb + s
        v[k] = piv[..., k] * s
    else:
        v[k] = m[..., k] * (va + vb) + piv[..., k] * d[..., k]

    def substitute(rows, step):
        x = v[k]
        for i in rows:
            up = r[..., i + step] * piv[..., i] if transpose else m[..., i]
            x = v[i] = up * x + v[i]

    substitute(range(k - 1, -1, -1), 1)
    substitute(range(k + 1, n), -1)
    return torch.stack(v, dim=-1)


def _round4(n):
    return -(-n // 4) * 4


def slab_floats(H, W):
    """Floats a sweep takes in the factor table: three slots of the larger
    sweep's lines, each line n | 1 floats, a slot rounded up to four
    floats (csrc/grayscale_lines.cuh::slab_floats)."""
    return 3 * max(_round4(H * (W | 1)), _round4(W * (H | 1)))


class GrayPlan(NamedTuple):
    """A grayscale launch: ``grid`` blocks of at most ``tile`` images,
    ``threads`` and ``smem`` bytes of shared memory a block, and ``slab``
    floats a sweep in the factor table."""
    grid: int
    tile: int
    threads: int
    smem: int
    slab: int


def plan_grayscale(B, H, W, sms, backward=False):
    """The first scheme's launch plan of K6/K7 (or, ``backward``, K8) over
    B >= 1 images of (H, W): at least ``sms`` blocks where the batch allows
    it (one image a block at B <= sms), more where the images would pass the
    shared memory a block may use or 4 images a block; whole images, as
    evenly as they split.  A block holds four factor buffers of two slots
    (K8 two, and its (4, H, W) partials and an (H, W) fold) beside its
    images' buffers, and 2P threads a line of the longer sweep (P the
    smallest power of two not below the tile: two a line and image, a
    line's images in one warp), whole warps, between 256 and 512.  ``bind``
    holds the plan against the C side's count.  Raises if one image does
    not fit (past SHARED_MAX_N; ``choose_gray_scheme`` sends such a shape
    to the wide scheme)."""
    slot = slab_floats(H, W) // 3
    image = H * (W | 1)
    per_image = 4 * image * (BWD_BUFFERS if backward else FWD_BUFFERS)
    fixed = 4 * (BWD_RING * 2 * slot + 5 * H * W if backward
                 else FWD_RING * 2 * slot)
    most = (MAX_SMEM - fixed) // per_image
    if most < 1:
        raise ValueError(f"one image of {(H, W)} needs {per_image + fixed} "
                         f"bytes of shared memory a block (limit {MAX_SMEM})")
    grid = max(min(B, sms), -(-B // min(most, MAX_TILE)))
    tile = -(-B // grid)
    lanes = 2 * (1 << (tile - 1).bit_length()) * max(H, W)
    threads = min(MAX_THREADS, max(MIN_THREADS, -(-lanes // 32) * 32))
    return GrayPlan(grid, tile, threads, fixed + tile * per_image,
                    slab_floats(H, W))


class GrayWidePlan(NamedTuple):
    """A wide-scheme launch (csrc/fused_grayscale_wide.cu): ``grid`` blocks
    of ``threads``, each a tile of at most ``tile`` whole images, ``smem``
    bytes of shared memory and ``workspace`` floats of device memory a
    block, ``slab`` floats a sweep in the factor table; ``backward``: K8's
    (else K6/K7's)."""
    grid: int
    tile: int
    threads: int
    smem: int
    workspace: int
    slab: int
    backward: bool


def partial_floats(H, W):
    """Floats of K8's partial row a block: the four (H, W) field
    gradients."""
    return 4 * H * W


def strip_lines(H, W, threads):
    """Lines of a sweep the wide scheme stages in a block's shared memory at
    once (csrc/fused_grayscale_wide.cu::strip_lines): one a pair of
    threads, at most the longer sweep's lines, no more than fit
    WIDE_SMEM_BUDGET with two factor slots of the longer line and an
    x-line's state each."""
    n = max(H, W)
    per_line = 2 * (n | 1) + (W | 1)
    return min(threads // 2, n, WIDE_SMEM_BUDGET // (4 * per_line))


def gray_wide_plan(B, H, W, sms, backward=False):
    """The wide scheme's launch over B >= 1 images of (H, W): two threads a
    line of the longer sweep (whole warps, between WIDE_MIN_THREADS and
    WIDE_MAX_THREADS; more lines loop); at most WIDE_BLOCKS_PER_SM blocks
    an SM, one a tile of whole images, and no more than keep the workspace
    (and K8's partial rows) under WIDE_WORKSPACE_BUDGET bytes, but at least
    one block.  Shared memory a block: a strip's factors and x-line state
    (``strip_lines``).  Workspace a block: two images, the sweeps' ping
    and pong (K6/K7); x1, x2, the cotangent's second buffer and the fold
    (K8)."""
    hw = H * W
    threads = min(WIDE_MAX_THREADS,
                  max(WIDE_MIN_THREADS, -(-2 * max(H, W) // 32) * 32))
    smem = 4 * strip_lines(H, W, threads) * (2 * (max(H, W) | 1) + (W | 1))
    workspace = (4 if backward else 2) * hw
    per_block = 4 * (workspace + (partial_floats(H, W) if backward else 0))
    grid = max(1, min(B, WIDE_BLOCKS_PER_SM * sms,
                      WIDE_WORKSPACE_BUDGET // per_block))
    return GrayWidePlan(grid, -(-B // grid), threads, smem, workspace,
                        slab_floats(H, W), backward)


def choose_gray_scheme(B, H, W, sms, backward=False):
    """The launch of K6/K7 (or, with ``backward``, K8) over B images of
    (H, W): the first scheme's ``GrayPlan`` (``plan_grayscale``) where
    H, W ≤ SHARED_MAX_N (one image with its factors fits MAX_SMEM at every
    such shape: (64, 64) in K8 takes 231,680 bytes), else a
    ``GrayWidePlan``.  Raises ``ValueError`` past MAX_N."""
    check_limits("choose_gray_scheme", 1, H, W)
    if H <= SHARED_MAX_N and W <= SHARED_MAX_N:
        return plan_grayscale(B, H, W, sms, backward)
    return gray_wide_plan(B, H, W, sms, backward)


def bind(name, symbol, argtypes, layout_symbol, shape, plan):
    """The C entry point ``symbol`` of csrc/<name>.cu.  The first time a
    plan is launched for an (H, W) ``shape``, raise unless
    ``layout_symbol`` reports for it the launch the wrapper planned: the
    threads a block, the bytes of shared memory a block and the floats a
    sweep in the table, and (a ``GrayWidePlan``) the floats of workspace a
    block."""
    key = (name, tuple(shape), plan)
    if key not in _layout_checked:
        threads, smem, slab = (ctypes.c_int() for _ in range(3))
        if isinstance(plan, GrayWidePlan):
            workspace = ctypes.c_longlong()
            kernels.function(name, layout_symbol,
                             [ctypes.c_int] * 3
                             + [ctypes.POINTER(ctypes.c_int)] * 2
                             + [ctypes.POINTER(ctypes.c_longlong),
                                ctypes.POINTER(ctypes.c_int)])(
                *shape, int(plan.backward), ctypes.byref(threads),
                ctypes.byref(smem), ctypes.byref(workspace),
                ctypes.byref(slab))
            got = (threads.value, smem.value, slab.value, workspace.value)
            want = (plan.threads, plan.smem, plan.slab, plan.workspace)
        else:
            kernels.function(name, layout_symbol,
                             [ctypes.c_int] * 3
                             + [ctypes.POINTER(ctypes.c_int)] * 3)(
                *shape, plan.tile, ctypes.byref(threads), ctypes.byref(smem),
                ctypes.byref(slab))
            got = (threads.value, smem.value, slab.value)
            want = (plan.threads, plan.smem, plan.slab)
        if got != want:
            raise RuntimeError(
                f"{name}.cu reports {layout_symbol} = {got} (threads, "
                f"bytes, table floats a sweep[, floats of workspace]) for "
                f"{plan} of {tuple(shape)}; the wrapper plans {want}")
        _layout_checked.add(key)
    return kernels.function(name, symbol, argtypes)


def factor_table(plan, num_steps, device):
    """The scratch of a call's factor table: 3 num_steps slabs."""
    return torch.empty(3 * num_steps * plan.slab, dtype=torch.float32,
                       device=device)


def wide_bytes(plan, H, W, num_steps):
    """Bytes of device memory a wide launch of (H, W) images allocates: the
    factor table, the blocks' workspace and (K8) their partial rows."""
    row = partial_floats(H, W) if plan.backward else 0
    return 4 * (3 * num_steps * plan.slab + plan.grid * (plan.workspace + row))


def launch_forward(u, alpha_base, alpha_tc, beta_base, beta_tc, *, dt, dx,
                   dy, ts, eps, res=None):
    """Launch K6, or K7 when ``res`` is a (num_steps, B, H, W) tensor to
    hold the residuals, on checked CUDA tensors, by the scheme
    ``choose_gray_scheme`` picks: csrc/fused_grayscale.cu, or
    csrc/fused_grayscale_wide.cu with a workspace allocated here.  Returns
    (out, the plan launched; None for an empty batch)."""
    B, H, W = u.shape
    out = torch.empty_like(u)
    if B == 0:
        return out, None
    S = ts.shape[0]
    plan = choose_gray_scheme(B, H, W, _sms(u.device))
    wide = isinstance(plan, GrayWidePlan)
    dtf_x, dtf_y = _dt_factors(dt, dx, dy, "strang")
    if wide:
        check_workspace("fused_grayscale_wide_forward",
                        wide_bytes(plan, H, W, S), u.device)
    table = factor_table(plan, S, u.device)
    ptrs = (u.data_ptr(), out.data_ptr(), alpha_base.data_ptr(),
            alpha_tc.data_ptr(), beta_base.data_ptr(), beta_tc.data_ptr(),
            ts.data_ptr(), None if res is None else res.data_ptr(),
            table.data_ptr())
    tail = (dtf_x, dtf_y, eps, kernels.stream_handle(u.device))
    if wide:
        ws = torch.empty(plan.grid * plan.workspace, dtype=u.dtype,
                         device=u.device)
        fn = bind("fused_grayscale_wide", "fused_grayscale_wide_forward",
                  _WIDE_ARGTYPES, "fused_grayscale_wide_layout", (H, W),
                  plan)
        with torch.cuda.device(u.device):
            code = fn(*ptrs, ws.data_ptr(), B, H, W, plan.grid, S, *tail)
    else:
        fn = bind("fused_grayscale", "fused_grayscale_diffusion", _ARGTYPES,
                  "fused_grayscale_layout", (H, W), plan)
        with torch.cuda.device(u.device):
            code = fn(*ptrs, B, H, W, plan.grid, S, *tail)
    kernels.raise_on_error(
        "fused_grayscale_diffusion" + ("_fwd" if res is None else "_res")
        + ("_wide" if wide else ""), code)
    return out, plan


torch.library.define(
    "cnn_pde_tpu_torch::fused_grayscale_fwd",
    "(Tensor u, Tensor alpha_base, Tensor alpha_tc, Tensor beta_base, "
    "Tensor beta_tc, Tensor ts, float dt, float dx, float dy, "
    "float eps) -> Tensor")


@torch.library.impl("cnn_pde_tpu_torch::fused_grayscale_fwd",
                    ("cpu", "cuda"))
def _fused_grayscale_fwd_impl(u, alpha_base, alpha_tc, beta_base, beta_tc,
                              ts, dt, dx, dy, eps):
    """K6 as a registered op, so that ``torch.export`` can trace a forward
    that reaches it: on a CUDA tensor the kernel (or, inside
    ``plain_versions()``, its plain version), on a CPU tensor the plain
    version.  Its output has u's shape, contiguous."""
    fields = (alpha_base, alpha_tc, beta_base, beta_tc)
    kw = dict(dt=dt, dx=dx, dy=dy, ts=ts, eps=eps)
    if not kernels.use_kernel(u):
        return fused_grayscale_diffusion_plain(u, *fields, **kw).contiguous()
    check_layer_args("fused_grayscale_diffusion_fwd", u, *fields, ts)
    out, plan = launch_forward(u, *fields, **kw)
    fused_grayscale_diffusion_fwd.launches += 1
    fused_grayscale_diffusion_fwd.wide_launches += isinstance(plan,
                                                             GrayWidePlan)
    return out


@torch.library.register_fake("cnn_pde_tpu_torch::fused_grayscale_fwd")
def _(u, alpha_base, alpha_tc, beta_base, beta_tc, ts, dt, dx, dy, eps):
    return torch.empty_like(u, memory_format=torch.contiguous_format)


fused_grayscale_fwd_op = \
    torch.ops.cnn_pde_tpu_torch.fused_grayscale_fwd.default


def fused_grayscale_diffusion_fwd(u, alpha_base, alpha_tc, beta_base,
                                  beta_tc, *, dt, dx, dy, ts, eps=1e-6):
    """K6 on a CUDA tensor; the plain version on a CPU tensor
    (``fused_grayscale_fwd_op``).  Forward only: the trainable layer is
    ``fused_grayscale_vjp.fused_grayscale_diffusion``
    (``GrayscaleDiffusion(fused=True)``)."""
    fields = (alpha_base, alpha_tc, beta_base, beta_tc)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (u, *fields)):
        raise NotImplementedError(
            "fused_grayscale_diffusion_fwd (K6) is the eval forward and has "
            "no gradient: use ops.fused_grayscale_vjp."
            "fused_grayscale_diffusion")
    return fused_grayscale_fwd_op(u, *fields, ts, float(dt), float(dx),
                                  float(dy), float(eps))


fused_grayscale_diffusion_fwd.launches = 0       # either scheme
fused_grayscale_diffusion_fwd.wide_launches = 0  # the wide scheme's
