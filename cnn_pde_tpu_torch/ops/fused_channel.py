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

Two schemes, chosen by shape at launch (``choose_scheme``): the first
keeps a tile of whole images, their factors and the staged fields in one
block's shared memory (C ≤ 8, H, W ≤ 64, and what fits); the wide scheme
(``csrc/fused_channel_wide.cu``) takes every other shape up to C ≤ 64 and
H, W ≤ 1,440 (K1/K3's ``MAX_N``), with each image's state in device
memory and a thread a line.

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
from .tridiag import MAX_N as TRIDIAG_MAX_N
from .tridiag import _sms, tridiag_solve_pcr

__all__ = ["fused_channel_diffusion_fwd", "fused_channel_diffusion_plain",
           "fused_channel_fwd_op", "choose_scheme", "check_limits",
           "Plan", "plan_tiles", "WidePlan", "wide_plan", "thomas_factors",
           "thomas_apply"]

# the first scheme (csrc/fused_channel.cu, fused_channel_vjp.cu)
SHARED_MAX_C = 8        # per-pixel mixing registers (csrc/channel_lines.cuh)
SHARED_MAX_N = 64       # rows a line
MAX_SMEM = 232_448      # bytes a block may use on Hopper
THREADS = 512           # threads a block (csrc/channel_lines.cuh::kThreads)
FWD_BUFFERS = 1         # image buffers a block image in csrc/fused_channel.cu
# csrc/fused_channel_vjp.cu's image buffers a block image (cotangent, state,
# residual); beside them C·C floats a worker warp for the mixing gradient
BWD_BUFFERS = 3
# the wide scheme (csrc/fused_channel_wide.cu), and so the wrappers' limits
MAX_C = 64              # channels
MAX_N = TRIDIAG_MAX_N   # rows a line: K1/K3's, 1,440
WIDE_THREADS = 512      # threads a block, at most (kMaxThreads)
WIDE_PAIRS = 8          # K5's mixing-gradient pairs a pass (kPairs)
WIDE_BLOCKS_PER_SM = 2  # blocks a plan asks for, at most, an SM
WIDE_WORKSPACE_BUDGET = 1 << 30  # bytes of workspace a plan keeps under
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
             + [ctypes.c_float] * 4 + [ctypes.c_void_p])
_WIDE_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
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
    """Raise on anything the fused kernels (K2, K4, K5) take in neither
    scheme: a shape other than u (B, C, H, W) with fields (C, H, W), mixing
    (C, C) and ts (num_steps, 3); a tensor that is not contiguous float32
    on u's device; C outside [1, MAX_C] or H, W outside [1, MAX_N]
    (``check_limits``)."""
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
    check_limits(name, C, H, W)


def check_limits(name, C, H, W):
    """Raise past the shapes the wide scheme takes, naming the limit: C in
    [1, MAX_C], H and W in [1, MAX_N]."""
    if not 1 <= C <= MAX_C:
        raise ValueError(f"{name}: C={C} outside [1, {MAX_C}] (MAX_C, the "
                         "most channels the fused kernels take)")
    for axis, n in (("H", H), ("W", W)):
        if not 1 <= n <= MAX_N:
            raise ValueError(f"{name}: {axis}={n} outside [1, {MAX_N}] "
                             "(MAX_N, the longest line the fused kernels "
                             "take)")


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


def _shared_layout(C, H, W, buffers, extra_floats):
    """The first scheme's bytes for (C, H, W) images: (image floats, bytes
    an image, fixed bytes a block, factor buffers)."""
    image = C * H * (W | 1)
    per_image = 4 * buffers * image
    base = 4 * (C * C + extra_floats)
    factors = 4 * 2 * max(image, C * W * (H | 1))
    nbuf = 2 if base + 2 * factors + per_image <= MAX_SMEM else 1
    return image, per_image, base + nbuf * factors, nbuf


def plan_tiles(B, C, H, W, sms, buffers=FWD_BUFFERS, extra_floats=0):
    """The first scheme's launch plan over B >= 1 images, where ``buffers``
    image buffers of (C, H, W | 1) floats a block image sit beside the
    mixing matrix, ``extra_floats``, the factor buffers (two floats a row of
    every line of either sweep, lines n | 1 floats apart) and the staged
    fields.  At least ``sms`` blocks where the batch allows it (one image a
    block at B <= sms), more where the images would pass the shared memory
    a block may use; whole images, as evenly as they split.  Two factor
    buffers where they fit beside one image (else one); then alpha's two
    fields staged where they fit beside the tile, then beta's.  The kernels
    take ``nbuf`` and ``staged`` from the plan; ``bind`` holds the plan's
    bytes against the C side's count.  Raises if one image does not fit
    (``choose_scheme`` sends such a shape to the wide scheme)."""
    image, per_image, fixed, nbuf = _shared_layout(C, H, W, buffers,
                                                   extra_floats)
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


def bwd_extra_floats(C, H, W):
    """K5's floats beside its image buffers in the first scheme: C·C a
    worker warp, for the mixing gradient."""
    return (THREADS - factor_threads(C, H, W)) // 32 * C * C


class WidePlan(NamedTuple):
    """A wide-scheme launch (csrc/fused_channel_wide.cu): ``grid`` blocks of
    ``threads``, each a tile of at most ``tile`` whole images, ``smem``
    bytes of shared memory and ``workspace`` floats of device memory a
    block; ``backward``: K5's (else K2/K4's)."""
    grid: int
    tile: int
    threads: int
    smem: int
    workspace: int
    backward: bool


def wide_plan(B, C, H, W, sms, backward=False):
    """The wide scheme's launch over B >= 1 images: a thread a line of the
    longer sweep (whole warps, at most WIDE_THREADS); at most
    WIDE_BLOCKS_PER_SM blocks an SM, one a tile of whole images, and no
    more than keep the workspace (and K5's partial rows) under
    WIDE_WORKSPACE_BUDGET bytes, but at least one block.  Workspace a
    block: the mixed state and the multipliers (K2/K4); x1, x2, the mixed
    cotangent and the multipliers (K5)."""
    chw = C * H * W
    threads = min(WIDE_THREADS, -(-C * max(H, W) // 32) * 32)
    smem = 4 * (C * C + (threads // 32 * WIDE_PAIRS if backward else 0))
    workspace = (4 if backward else 2) * chw
    per_block = 4 * (workspace + (4 * chw + C * C if backward else 0))
    grid = max(1, min(B, WIDE_BLOCKS_PER_SM * sms,
                      WIDE_WORKSPACE_BUDGET // per_block))
    return WidePlan(grid, -(-B // grid), threads, smem, workspace, backward)


def choose_scheme(B, C, H, W, sms, backward=False):
    """The launch of K2/K4 (or, with ``backward``, K5) over B images of
    (C, H, W): today's first-scheme ``Plan`` (``plan_tiles``, K5's with
    BWD_BUFFERS and ``bwd_extra_floats``) where that scheme takes the
    shape, else a ``WidePlan``.  The first scheme takes C ≤ SHARED_MAX_C
    and H, W ≤ SHARED_MAX_N when at least W worker threads remain beside
    its factor warps (its pixel passes give a worker a column; with fewer,
    they would do nothing) and one image with its factors fits MAX_SMEM.
    Raises ``ValueError`` past MAX_C or MAX_N (``check_limits``)."""
    check_limits("choose_scheme", C, H, W)
    if (C <= SHARED_MAX_C and H <= SHARED_MAX_N and W <= SHARED_MAX_N
            and THREADS - factor_threads(C, H, W) >= W):
        buffers, extra = ((BWD_BUFFERS, bwd_extra_floats(C, H, W))
                          if backward else (FWD_BUFFERS, 0))
        _, per_image, fixed, _ = _shared_layout(C, H, W, buffers, extra)
        if fixed + per_image <= MAX_SMEM:
            return plan_tiles(B, C, H, W, sms, buffers, extra)
    return wide_plan(B, C, H, W, sms, backward)


def check_workspace(name, nbytes, device):
    """Raise unless ``nbytes`` of workspace fit the card's free memory
    (``cudaMemGetInfo``'s free bytes and the caching allocator's unused
    ones).  Not while a CUDA graph is being captured: the graph's pool
    serves it."""
    if torch.cuda.is_current_stream_capturing():
        return
    free, _ = torch.cuda.mem_get_info(device)
    free += (torch.cuda.memory_reserved(device)
             - torch.cuda.memory_allocated(device))
    if nbytes > free:
        raise RuntimeError(f"{name}: the wide scheme needs {nbytes} bytes of "
                           f"workspace on {device}, {free} are free")


def bind(name, symbol, argtypes, layout_symbol, shape, plan):
    """The C entry point ``symbol`` of csrc/<name>.cu.  The first time a
    plan is launched for a (C, H, W) ``shape``, raise unless
    ``layout_symbol`` reports for it the launch the wrapper planned: the
    threads a block and the bytes of shared memory a block (a ``Plan``),
    and the floats of workspace a block (a ``WidePlan``)."""
    key = (name, tuple(shape), plan)
    if key not in _layout_checked:
        threads, smem = ctypes.c_int(), ctypes.c_int()
        if isinstance(plan, WidePlan):
            workspace = ctypes.c_longlong()
            kernels.function(name, layout_symbol,
                             [ctypes.c_int] * 4
                             + [ctypes.POINTER(ctypes.c_int)] * 2
                             + [ctypes.POINTER(ctypes.c_longlong)])(
                *shape, int(plan.backward), ctypes.byref(threads),
                ctypes.byref(smem), ctypes.byref(workspace))
            got = (threads.value, smem.value, workspace.value)
            want = (plan.threads, plan.smem, plan.workspace)
        else:
            kernels.function(name, layout_symbol,
                             [ctypes.c_int] * 6
                             + [ctypes.POINTER(ctypes.c_int)] * 2)(
                *shape, plan.tile, plan.nbuf, plan.staged,
                ctypes.byref(threads), ctypes.byref(smem))
            got, want = (threads.value, smem.value), (THREADS, plan.smem)
        if got != want:
            raise RuntimeError(
                f"{name}.cu reports {layout_symbol} = {got} (threads, "
                f"bytes of shared memory[, floats of workspace]) for {plan} "
                f"of {tuple(shape)}; the wrapper plans {want}")
        _layout_checked.add(key)
    return kernels.function(name, symbol, argtypes)


def launch_forward(u, alpha_base, alpha_tc, beta_base, beta_tc, mixing, *,
                   dt, dx, dy, ts, splitting, eps, cmax, res=None):
    """Launch K2, or K4 when ``res`` is a (num_steps, B, C, H, W) tensor to
    hold the residuals, on checked CUDA tensors, by the scheme
    ``choose_scheme`` picks: csrc/fused_channel.cu, or
    csrc/fused_channel_wide.cu with a workspace allocated here.  Returns
    (out, the plan launched; None for an empty batch)."""
    B, C, H, W = u.shape
    out = torch.empty_like(u)
    if B == 0:
        return out, None
    plan = choose_scheme(B, C, H, W, _sms(u.device))
    dtf_x, dtf_y = _dt_factors(dt, dx, dy, splitting)
    fields = (alpha_base, alpha_tc, beta_base, beta_tc, mixing, ts)
    tail = (ts.shape[0], int(splitting == "strang"), dtf_x, dtf_y, eps, cmax,
            kernels.stream_handle(u.device))
    res_ptr = None if res is None else res.data_ptr()
    if isinstance(plan, WidePlan):
        nbytes = 4 * plan.grid * plan.workspace
        check_workspace("fused_channel_wide_forward", nbytes, u.device)
        ws = torch.empty(plan.grid * plan.workspace, dtype=u.dtype,
                         device=u.device)
        fn = bind("fused_channel_wide", "fused_channel_wide_forward",
                  _WIDE_ARGTYPES, "fused_channel_wide_layout", (C, H, W),
                  plan)
        with torch.cuda.device(u.device):
            code = fn(u.data_ptr(), out.data_ptr(),
                      *(t.data_ptr() for t in fields), res_ptr,
                      ws.data_ptr(), B, C, H, W, plan.grid, *tail)
    else:
        fn = bind("fused_channel", "fused_channel_diffusion", _ARGTYPES,
                  "fused_channel_layout", (C, H, W), plan)
        with torch.cuda.device(u.device):
            code = fn(u.data_ptr(), out.data_ptr(),
                      *(t.data_ptr() for t in fields), res_ptr, B, C, H, W,
                      plan.grid, plan.nbuf, plan.staged, *tail)
    kernels.raise_on_error(
        "fused_channel_diffusion" + ("_fwd" if res is None else "_res")
        + ("_wide" if isinstance(plan, WidePlan) else ""), code)
    return out, plan


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
    out, plan = launch_forward(u, *fields, **kw)
    fused_channel_diffusion_fwd.launches += 1
    fused_channel_diffusion_fwd.wide_launches += isinstance(plan, WidePlan)
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


fused_channel_diffusion_fwd.launches = 0       # either scheme
fused_channel_diffusion_fwd.wide_launches = 0  # the wide scheme's
