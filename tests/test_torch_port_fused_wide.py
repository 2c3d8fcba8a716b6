"""The fused channel layers (K2, K4, K5) at the shapes past the
shared-memory scheme, on the CPU: the port's K2 entry and its trainable
layer (the plain versions here) against the JAX package's Pallas kernels in
interpret mode at 96 × 96, 64 × 64 with up to 8 channels, 28 × 100 and
C = 12; the wide K5's reduction order through its plain mirror
(``fused_channel_bwd_streamed``); the scheme choice that sends a shape to
the first scheme or the wide one, and its limits; the wide scheme's launch
check; ``MixedChannelDiffusion(size=96)`` fused against the JAX layer; the
grayscale kernels' own limits.

Tolerances: 1e-5 abs on outputs (one system, another elimination order);
1e-4 of each gradient's largest entry (sums over pixels, images, tiles
and steps in another order).
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_pde_tpu.ops import pallas_fused_channel as jfwd
from cnn_pde_tpu.ops import pallas_fused_channel_vjp as jvjp
from cnn_pde_tpu.pde import MixedChannelDiffusion as JaxMixed
from cnn_pde_tpu.pde.diffusion import _substep_times
from cnn_pde_tpu_torch.compat import state_dict_from_jax
from cnn_pde_tpu_torch.ops import fused_channel, fused_grayscale
from cnn_pde_tpu_torch.ops.fused_channel import (
    BWD_BUFFERS, FWD_BUFFERS, MAX_C, MAX_N, MAX_SMEM, SHARED_MAX_C,
    SHARED_MAX_N, THREADS, WIDE_BLOCKS_PER_SM, WIDE_THREADS,
    WIDE_WORKSPACE_BUDGET, Plan, WidePlan, bwd_extra_floats,
    check_layer_args, check_workspace, choose_scheme, factor_threads,
    fused_channel_diffusion_fwd, plan_tiles, wide_plan)
from cnn_pde_tpu_torch.ops.fused_channel_vjp import (
    _tile_bounds, bwd_plan, fused_channel_bwd_plain,
    fused_channel_bwd_streamed, fused_channel_diffusion,
    fused_channel_fwd_res_plain)
from cnn_pde_tpu_torch.pde import MixedChannelDiffusion
from cnn_pde_tpu_torch.pde.diffusion import _substep_times_np


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six test
    files at once on one host, and eight threads each oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


NAMES = ["alpha_base", "alpha_time_coeff", "beta_base", "beta_time_coeff",
         "channel_mixing"]
TOL = 1e-5
GRAD_TOL = 1e-4
EPS, CMAX = 1e-6, 10.0
SMS = 132  # an H100's


def _max_err(x, y):
    return float(np.max(np.abs(np.asarray(x, np.float64)
                               - np.asarray(y, np.float64))))


def _rel_err(x, y):
    y = np.asarray(y, np.float64)
    return float(np.max(np.abs(np.asarray(x, np.float64) - y))
                 / max(np.max(np.abs(y)), 1e-30))


def _fields(rng, C, H, W):
    """Fields whose raw values fall on both sides of both clamp bounds over
    the layer's horizon, and a mixing near the identity."""
    return {k: v.astype(np.float32) for k, v in {
        "alpha_base": rng.uniform(-0.5, CMAX + 0.5, (C, H, W)),
        "alpha_time_coeff": 5.0 * rng.standard_normal((C, H, W)),
        "beta_base": rng.uniform(-0.5, CMAX + 0.5, (C, H, W)),
        "beta_time_coeff": 5.0 * rng.standard_normal((C, H, W)),
        "channel_mixing": np.eye(C) + 0.05 * rng.standard_normal((C, C)),
    }.items()}


# (B, C, H, W), steps, splitting, and whether the port's K2 entry is held
# against the JAX eval kernel (fused_channel_diffusion_fwd) or, where the
# first scheme already ran K2 and only K5 was refused, against the JAX
# trainable kernel's forward
CASES = [((2, 3, 96, 96), 2, "lie", "fwd"),
         ((2, 8, 64, 64), 2, "lie", "fwd"),
         ((2, 3, 64, 64), 2, "strang", "vjp"),
         ((2, 4, 64, 64), 2, "lie", "vjp"),
         ((2, 3, 28, 100), 2, "strang", "fwd"),
         ((2, 12, 8, 8), 2, "lie", "fwd")]
DT, DX, DY = 0.002, 2.0, 1.5


@pytest.mark.parametrize("shape,steps,splitting,k2_ref", CASES,
                         ids=[f"{c[0]}-{c[2]}" for c in CASES])
def test_layer_kernels_match_jax_past_the_shared_scheme(shape, steps,
                                                        splitting, k2_ref):
    """The port's K2 entry (``fused_channel_diffusion_fwd``) and its
    trainable layer (``fused_channel_diffusion``: K4 forward, K5 backward)
    against JAX's fused_channel_diffusion_fwd and jax.vjp of JAX's
    fused_channel_diffusion, both Pallas kernels in interpret mode; the
    wide K5's streamed reduction (one tile of both images, and a tile
    each) against the same gradients.  The card takes each shape by the
    wide scheme for K5 and, but for (3, 64, 64) and (4, 64, 64), for
    K2/K4."""
    B, C, H, W = shape
    rng = np.random.default_rng(C * 10_000 + H * 100 + W)
    params = _fields(rng, C, H, W)
    u = rng.random(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    ts = _substep_times(DT, steps)
    ts_tuple = tuple(map(tuple, np.asarray(ts, np.float64).tolist()))
    jargs = [jnp.asarray(params[n]) for n in NAMES]

    def layer(u2, *p):
        return jvjp.fused_channel_diffusion(u2, *p, DT, DX, DY, steps,
                                            ts_tuple, splitting, EPS, CMAX,
                                            B, True)
    out_ref, vjp = jax.vjp(layer, jnp.asarray(u), *jargs)
    grads_ref = vjp(jnp.asarray(g))
    k2_ref_out = out_ref if k2_ref == "vjp" else jfwd.fused_channel_diffusion_fwd(
        jnp.asarray(u), *jargs, dt=DT, dx=DX, dy=DY, num_steps=steps, ts=ts,
        splitting=splitting, eps=EPS, cmax=CMAX, tile_b=B, interpret=True)

    kw = dict(dt=DT, dx=DX, dy=DY, splitting=splitting, eps=EPS, cmax=CMAX,
              ts=torch.tensor(_substep_times_np(DT, steps),
                              dtype=torch.float32))
    fields = [torch.from_numpy(params[n]) for n in NAMES]
    with torch.no_grad():
        k2 = fused_channel_diffusion_fwd(torch.from_numpy(u), *fields, **kw)
    assert k2.shape == shape
    assert _max_err(k2, k2_ref_out) <= TOL
    leaves = [torch.from_numpy(u).requires_grad_()] + [
        f.clone().requires_grad_() for f in fields]
    out = fused_channel_diffusion(*leaves, **kw)
    assert _max_err(out.detach(), out_ref) <= TOL
    (out * torch.from_numpy(g)).sum().backward()
    for name, leaf, ref in zip(["u"] + NAMES, leaves, grads_ref):
        assert leaf.grad.shape == ref.shape, name
        assert _rel_err(leaf.grad, ref) <= GRAD_TOL, name
    y, res = fused_channel_fwd_res_plain(torch.from_numpy(u), *fields, **kw)
    for grid in (1, B):
        streamed = fused_channel_bwd_streamed(torch.from_numpy(g), res, y,
                                              *fields, grid=grid, **kw)
        for name, got, ref in zip(["u"] + NAMES, streamed, grads_ref):
            assert _rel_err(got, ref) <= GRAD_TOL, (grid, name)
    assert isinstance(choose_scheme(B, C, H, W, SMS, backward=True),
                      WidePlan)
    assert isinstance(choose_scheme(B, C, H, W, SMS),
                      Plan if k2_ref == "vjp" else WidePlan)


def test_mixed_channel_diffusion_96_fused_matches_jax():
    """MixedChannelDiffusion(size=96) on the flagship's 8-step branch scale
    (two steps here) with ``fused=True`` (train mode: output and every
    parameter's gradient) and with ``fused_inference=True`` (eval: the K2
    entry) against the JAX layer with ``fused=True`` run by its Pallas
    kernels in interpret mode (``fused_interpret``), and the eval output
    also against JAX's fused_channel_diffusion_fwd; weights carried by
    ``compat.state_dict_from_jax``."""
    rng = np.random.default_rng(961)
    kw = dict(dt=0.002, dx=2.0, dy=2.0, num_steps=2, splitting="strang")
    params = _fields(rng, 3, 96, 96)
    u = rng.random((2, 3, 96, 96)).astype(np.float32)
    g = rng.standard_normal((2, 3, 96, 96)).astype(np.float32)
    jlayer = JaxMixed(96, 3, fused=True, **kw)
    jlayer.fused_interpret = True
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    ref, vjp = jax.vjp(lambda p: jlayer(p, {}, jnp.asarray(u))[0], jparams)
    (grads,) = vjp(jnp.asarray(g))
    k2_ref = jfwd.fused_channel_diffusion_fwd(
        jnp.asarray(u), *(jparams[n] for n in NAMES), dt=kw["dt"],
        dx=kw["dx"], dy=kw["dy"], num_steps=2,
        ts=_substep_times(kw["dt"], 2), splitting="strang", eps=EPS,
        cmax=CMAX, tile_b=2, interpret=True)
    sd = state_dict_from_jax(params, {})
    trained = MixedChannelDiffusion(96, 3, fused=True, **kw).train()
    trained.load_state_dict(sd, strict=True)
    out = trained(torch.from_numpy(u))
    assert out.shape == (2, 3, 96, 96)
    assert _max_err(out.detach(), ref) <= TOL
    (out * torch.from_numpy(g)).sum().backward()
    for name, p in trained.named_parameters():
        assert _rel_err(p.grad, grads[name]) <= GRAD_TOL, name
    served = MixedChannelDiffusion(96, 3, fused_inference=True, **kw).eval()
    served.load_state_dict(sd, strict=True)
    with torch.no_grad():
        y = served(torch.from_numpy(u))
    assert _max_err(y, ref) <= TOL
    assert _max_err(y, k2_ref) <= TOL


@pytest.mark.parametrize("splitting", ["strang", "lie"])
def test_streamed_mirror_orders_like_the_wide_k5(splitting):
    """``fused_channel_bwd_streamed`` (each tile's images one at a time,
    every adjoint added to the tile's row as it comes, the rows summed in
    K5's fixed order) against the plain backward over the whole batch, on
    ragged tiles (5 images over 2 and 3 blocks), one image a tile, and
    more tiles than the sum's eight slices (11 over 11); the plain
    backward's ``acc`` adds to the tensors it is given."""
    rng = np.random.default_rng(41 if splitting == "strang" else 42)
    C, H, W, steps = 2, 6, 7, 3
    fields = [torch.from_numpy(v) for v in _fields(rng, C, H, W).values()]
    kw = dict(dt=0.02, dx=1.0, dy=1.5, splitting=splitting, eps=EPS,
              cmax=2.0, ts=torch.tensor(_substep_times_np(0.02, steps),
                                        dtype=torch.float32))
    for batch, grids in ((5, (1, 2, 3, 5)), (11, (11,))):
        u = torch.from_numpy(rng.random((batch, C, H, W)).astype(np.float32))
        g = torch.from_numpy(rng.standard_normal((batch, C, H, W)).astype(
            np.float32))
        y, res = fused_channel_fwd_res_plain(u, *fields, **kw)
        plain = fused_channel_bwd_plain(g, res, y, *fields, **kw)
        for grid in grids:
            streamed = fused_channel_bwd_streamed(g, res, y, *fields,
                                                  grid=grid, **kw)
            for name, s, p in zip(["u"] + NAMES, streamed, plain):
                assert s.shape == p.shape
                assert _rel_err(s, p) <= GRAD_TOL, (batch, grid, name)
        acc = [torch.ones_like(f) for f in fields]
        again = fused_channel_bwd_plain(g, res, y, *fields, acc=acc, **kw)
        for a, got, p in zip(acc, again[1:], plain[1:]):
            assert got is a
            assert _max_err(got, p + 1.0) <= TOL


# the presets' fused layers and the kernels' chip cases that the first
# scheme took before the wide one existed, over a grid of batches
TODAY_SHAPES = [(3, 32, 32), (1, 28, 28), (2, 20, 33), (3, 48, 64)]
TODAY_BATCHES = (1, 7, 64, 132, 300, 512, 1000, 3072)


def test_scheme_choice_keeps_todays_plan():
    """Wherever the first scheme has its workers (at least W threads beside
    its factor warps) and an image with its factors fits a block, the
    choice is exactly ``plan_tiles`` / ``bwd_plan``: for the presets'
    shapes over a grid of batches, K2 at (3, 64, 64) and (4, 64, 64), and
    every (C ≤ 8, H, W ≤ 64) at B = 7.  Everywhere else in that range it
    is the wide scheme."""
    for shape in TODAY_SHAPES:
        for B in TODAY_BATCHES:
            assert choose_scheme(B, *shape, SMS) == plan_tiles(B, *shape,
                                                               SMS)
            assert choose_scheme(B, *shape, SMS, backward=True) == \
                bwd_plan(B, *shape, SMS)
    for shape in ((3, 64, 64), (4, 64, 64)):
        assert choose_scheme(64, *shape, SMS) == plan_tiles(64, *shape, SMS)
    shared = wide = 0
    for C in range(1, SHARED_MAX_C + 1):
        for H in range(1, SHARED_MAX_N + 1):
            for W in range(1, SHARED_MAX_N + 1):
                workers = THREADS - factor_threads(C, H, W) >= W
                for backward, planner in ((False, plan_tiles),
                                          (True, bwd_plan)):
                    try:
                        today = planner(7, C, H, W, SMS) if workers else None
                    except ValueError:
                        today = None
                    got = choose_scheme(7, C, H, W, SMS, backward=backward)
                    if today is None:
                        assert got == wide_plan(7, C, H, W, SMS, backward)
                        wide += 1
                    else:
                        assert got == today
                        shared += 1
    assert shared > 20_000 and wide > 1_000


def test_scheme_choice_goes_wide_where_the_first_scheme_refused():
    """The wide scheme for the shapes the first scheme refused: lines past
    64 rows, more than 8 channels, an image past the shared memory (K2 at
    (8, 64, 64), K5 at (3, 64, 64) and (4, 64, 64)), and too few workers
    beside the factor warps ((8, 30, 60): 480 factor threads leave 32 for
    60 columns); its plan: a thread a line of the longer sweep in whole
    warps up to WIDE_THREADS, at most WIDE_BLOCKS_PER_SM blocks an SM and
    the workspace budget, tiles that cover the batch."""
    assert plan_tiles(7, 8, 30, 60, SMS).smem <= MAX_SMEM
    assert THREADS - factor_threads(8, 30, 60) < 60
    for shape, backwards in (((3, 96, 96), (False, True)),
                             ((8, 64, 64), (False, True)),
                             ((3, 64, 64), (True,)), ((4, 64, 64), (True,)),
                             ((12, 32, 32), (False, True)),
                             ((3, 28, 100), (False, True)),
                             ((3, 224, 224), (False, True)),
                             ((8, 30, 60), (False, True)),
                             ((1, 1, MAX_N), (False, True)),
                             ((MAX_C, 8, 8), (False, True))):
        C, H, W = shape
        chw = C * H * W
        for backward in backwards:
            for B in (1, 2, 7, 64, 512, 27_648):
                plan = choose_scheme(B, *shape, SMS, backward=backward)
                assert isinstance(plan, WidePlan), (shape, backward)
                assert plan.backward == backward
                assert plan.threads % 32 == 0
                assert plan.threads == min(WIDE_THREADS,
                                           -(-C * max(H, W) // 32) * 32)
                assert plan.workspace == (4 if backward else 2) * chw
                assert plan.smem <= 48 * 1024
                assert 1 <= plan.grid <= min(B, WIDE_BLOCKS_PER_SM * SMS)
                assert plan.grid * (plan.tile - 1) < B <= plan.grid * plan.tile
                row = 4 * chw + C * C if backward else 0
                assert (plan.grid == 1 or 4 * plan.grid * (plan.workspace + row)
                        <= WIDE_WORKSPACE_BUDGET)
                bounds = _tile_bounds(B, plan.grid)
                assert max(b - a for a, b in bounds) == plan.tile


@pytest.mark.parametrize("shape,limit", [
    ((1, MAX_N + 1, 8), "MAX_N"), ((1, 8, MAX_N + 1), "MAX_N"),
    ((MAX_C + 1, 8, 8), "MAX_C"), ((0, 8, 8), "MAX_C")])
def test_past_the_wide_limits_raises_naming_the_limit(shape, limit):
    """C outside [1, MAX_C] (64) or H, W outside [1, MAX_N] (K1/K3's 1,440)
    raise a ValueError that names the limit, from the scheme choice and
    from the wrappers' argument check; MAX_N itself is taken."""
    assert MAX_N == 1440 and MAX_C == 64
    with pytest.raises(ValueError, match=limit):
        choose_scheme(2, *shape, SMS)
    C, H, W = shape
    u = torch.zeros((1, C, H, W))
    f = torch.zeros((C, H, W))
    with pytest.raises(ValueError, match=limit):
        check_layer_args("k", u, f, f, f, f, torch.eye(C), torch.zeros(2, 3),
                         "strang")
    assert isinstance(choose_scheme(2, 1, MAX_N, MAX_N, SMS), WidePlan)


@pytest.mark.parametrize("ok", [True, False])
def test_bind_checks_the_wide_launch_shape(monkeypatch, ok):
    """A wide plan launches only if csrc/fused_channel_wide.cu reports for
    it the threads a block, the bytes of shared memory a block and the
    floats of workspace a block the plan was made with, once a plan."""
    shape = (3, 96, 96)
    plan = choose_scheme(64, *shape, SMS, backward=True)
    asked = []

    def function(name, symbol, argtypes):
        if symbol != "fused_channel_wide_layout":
            return symbol

        def layout_fn(*args):
            asked.append(args[:4])
            threads, smem, workspace = args[4:]
            threads._obj.value = plan.threads
            smem._obj.value = plan.smem
            workspace._obj.value = plan.workspace + (0 if ok else 1)
            return 0
        assert argtypes[-1] is ctypes.POINTER(ctypes.c_longlong)
        return layout_fn

    monkeypatch.setattr(fused_channel.kernels, "function", function)
    monkeypatch.setattr(fused_channel, "_layout_checked", set())
    if ok:
        for _ in range(2):
            assert fused_channel.bind("fused_channel_wide", "entry", None,
                                      "fused_channel_wide_layout", shape,
                                      plan) == "entry"
        assert asked == [(*shape, 1)]
    else:
        with pytest.raises(RuntimeError, match="fused_channel_wide_layout"):
            fused_channel.bind("fused_channel_wide", "entry", None,
                               "fused_channel_wide_layout", shape, plan)
        assert not fused_channel._layout_checked


def test_workspace_check_names_the_bytes(monkeypatch):
    """The wide scheme's workspace is held against the card's free bytes
    plus the caching allocator's unused ones, with an error that names the
    bytes; inside a graph capture the graph's pool serves it unchecked."""
    cuda = fused_channel.torch.cuda
    monkeypatch.setattr(cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(cuda, "mem_get_info", lambda device: (1000, 8000))
    monkeypatch.setattr(cuda, "memory_reserved", lambda device: 500)
    monkeypatch.setattr(cuda, "memory_allocated", lambda device: 300)
    check_workspace("k", 1200, "cuda:0")
    with pytest.raises(RuntimeError, match="1201 bytes.*1200 are free"):
        check_workspace("k", 1201, "cuda:0")
    monkeypatch.setattr(cuda, "is_current_stream_capturing", lambda: True)
    check_workspace("k", 10**12, "cuda:0")


def test_grayscale_kernels_keep_their_own_limits():
    """K6-K8's first scheme holds a whole image in a block: it keeps
    H, W ≤ 64 (``SHARED_MAX_N``) and the shared memory of a block as its
    own constants; past 64 pixels the wrappers choose the grayscale wide
    scheme, up to the channel kernels' MAX_N (K1/K3's 1,440), and raise
    past it, naming it."""
    assert (fused_grayscale.SHARED_MAX_N, fused_grayscale.MAX_SMEM) == \
        (64, MAX_SMEM)
    assert fused_grayscale.MAX_N == fused_channel.MAX_N == MAX_N
    f = torch.zeros((64, 64))
    ts = torch.zeros((2, 3))
    fused_grayscale.check_layer_args("k", torch.zeros((1, 64, 64)), f, f, f,
                                     f, ts)
    assert isinstance(fused_grayscale.choose_gray_scheme(7, 64, 64, 132),
                      fused_grayscale.GrayPlan)
    f = torch.zeros((65, 64))
    fused_grayscale.check_layer_args("k", torch.zeros((1, 65, 64)), f, f, f,
                                     f, ts)
    assert isinstance(fused_grayscale.choose_gray_scheme(7, 65, 64, 132),
                      fused_grayscale.GrayWidePlan)
    f = torch.zeros((MAX_N + 1, 64))
    with pytest.raises(ValueError, match=f"H={MAX_N + 1}.*MAX_N"):
        fused_grayscale.check_layer_args(
            "k", torch.zeros((1, MAX_N + 1, 64)), f, f, f, f, ts)
    assert (FWD_BUFFERS, BWD_BUFFERS) == (1, 3)
    assert bwd_extra_floats(3, 32, 32) == (THREADS - 96) // 32 * 9
