"""The fused grayscale layer (K6, K7, K8) at images past 64 pixels a side,
on the CPU: the port's K6 entry and its trainable layer (the plain versions
here) against the JAX package's Pallas kernels in interpret mode at
(2, 96, 96), (2, 28, 100) and (2, 65, 64) on both presets' settings (mnist:
10 Strang steps at dt 1e-3; fashion_mnist: 4 at dt 0.3) with fields whose
raw values straddle eps, so that the clamp gate and the smooth3 adjoint
act; ``GrayscaleDiffusion(size=96)`` fused against the JAX layer; the wide
K8's reduction order through its plain mirror
(``fused_grayscale_bwd_tiled(per_image=True)``); the scheme choice that
keeps today's first-scheme plan for every image of at most 64 pixels a side
and goes wide past that; the limits; the wide scheme's launch check and
workspace.

Tolerances: 1e-5 abs on outputs (one system, another elimination order:
the port's twisted factorisation or PCR against the TPU kernel's PCR);
1e-4 of each gradient's largest entry (sums over pixels, images, tiles and
steps in another order).  Observed on the CPU: outputs at most 3.6e-07
from the JAX kernels and 2.4e-07 from the JAX layer; gradients at most
1.0e-06 of their largest entry from the JAX kernels (the per-image mirror
included) and 2.4e-07 from the JAX layer; the per-image mirror at most
3.0e-07 of the plain backward's largest entry.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_pde_tpu.ops import pallas_fused_adi as jfwd
from cnn_pde_tpu.ops import pallas_fused_adi_vjp as jvjp
from cnn_pde_tpu.pde import GrayscaleDiffusion as JaxGrayscale
from cnn_pde_tpu.pde.diffusion import _substep_times, _substep_times_tuple
from cnn_pde_tpu_torch.compat import state_dict_from_jax
from cnn_pde_tpu_torch.ops import fused_grayscale
from cnn_pde_tpu_torch.ops.fused_channel import (WIDE_BLOCKS_PER_SM,
                                                 WIDE_WORKSPACE_BUDGET)
from cnn_pde_tpu_torch.ops.fused_channel_vjp import _tile_bounds
from cnn_pde_tpu_torch.ops.fused_grayscale import (
    MAX_N, MAX_SMEM, SHARED_MAX_N, WIDE_MAX_THREADS, WIDE_MIN_THREADS,
    WIDE_SMEM_BUDGET, GrayWidePlan, check_layer_args, choose_gray_scheme,
    fused_grayscale_diffusion_fwd, gray_wide_plan, partial_floats,
    plan_grayscale, slab_floats, strip_lines, wide_bytes)
from cnn_pde_tpu_torch.ops.fused_grayscale_vjp import (
    fused_grayscale_bwd_plain, fused_grayscale_bwd_tiled,
    fused_grayscale_diffusion, fused_grayscale_fwd_res_plain)
from cnn_pde_tpu_torch.pde import GrayscaleDiffusion
from cnn_pde_tpu_torch.pde.diffusion import _substep_times_np


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six test
    files at once on one host, and eight threads each oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


NAMES = ["alpha_base", "alpha_time_coeff", "beta_base", "beta_time_coeff"]
# the presets' layers: (dt, num_steps, init_value)
LAYERS = {"mnist": (0.001, 10, 2.0), "fashion_mnist": (0.3, 4, 1.8)}
TOL = 1e-5
GRAD_TOL = 1e-4
EPS = 1e-6
SMS = 132  # an H100's


def _max_err(x, y):
    return float(np.max(np.abs(np.asarray(x, np.float64)
                               - np.asarray(y, np.float64))))


def _rel_err(x, y):
    y = np.asarray(y, np.float64)
    return float(np.max(np.abs(np.asarray(x, np.float64) - y))
                 / max(np.max(np.abs(y)), 1e-30))


def _fields(rng, preset, H, W):
    """Bases uniform on [-0.5, 2·init], so that raw values fall on both
    sides of eps, and time coefficients N(0, 1) over the layer's horizon,
    so that they move each coefficient by about 1 over it."""
    dt, steps, init = LAYERS[preset]
    return {k: v.astype(np.float32) for k, v in {
        "alpha_base": rng.uniform(-0.5, 2.0 * init, (H, W)),
        "alpha_time_coeff": rng.standard_normal((H, W)) / (dt * steps),
        "beta_base": rng.uniform(-0.5, 2.0 * init, (H, W)),
        "beta_time_coeff": rng.standard_normal((H, W)) / (dt * steps),
    }.items()}


def _kw(preset):
    dt, steps, _ = LAYERS[preset]
    return dict(dt=dt, dx=1.0, dy=1.0, eps=EPS,
                ts=torch.tensor(_substep_times_np(dt, steps),
                                dtype=torch.float32))


def _jax_kernels(params, u, g, preset):
    """JAX's eval kernel's output, and its trainable kernel's output and
    five gradients (jax.vjp), both Pallas kernels in interpret mode with
    one tile of the whole batch."""
    dt, steps, _ = LAYERS[preset]
    jargs = [jnp.asarray(params[n]) for n in NAMES]
    k6 = jfwd.fused_grayscale_diffusion_fwd(
        jnp.asarray(u), *jargs, dt=dt, dx=1.0, dy=1.0, num_steps=steps,
        ts=_substep_times(dt, steps), eps=EPS, tile_b=u.shape[0],
        interpret=True)
    ts_tuple = _substep_times_tuple(dt, steps)

    def layer(u2, *p):
        return jvjp.fused_grayscale_diffusion(u2, *p, dt, 1.0, 1.0, steps,
                                              ts_tuple, EPS, u.shape[0], True)
    out, vjp = jax.vjp(layer, jnp.asarray(u), *jargs)
    return np.asarray(k6), np.asarray(out), vjp(jnp.asarray(g))


# (B, H, W) and preset; (96, 96) on the mnist layer is held through the
# layer against the JAX layer below
CASES = [((2, 96, 96), "fashion_mnist"), ((2, 28, 100), "mnist"),
         ((2, 65, 64), "fashion_mnist")]


@pytest.mark.parametrize("shape,preset", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_layer_kernels_match_jax_past_64_pixels(shape, preset):
    """The port's K6 entry (``fused_grayscale_diffusion_fwd``) and its
    trainable layer (``fused_grayscale_diffusion``: K7 forward, K8
    backward) against JAX's fused_grayscale_diffusion_fwd and jax.vjp of
    JAX's fused_grayscale_diffusion in interpret mode; the wide K8's
    per-image reduction (one tile of both images, and a tile each)
    against the same gradients.  The card takes each shape by the wide
    scheme."""
    B, H, W = shape
    rng = np.random.default_rng(H * 1000 + W)
    params = _fields(rng, preset, H, W)
    u = rng.random(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    k6_ref, out_ref, grads_ref = _jax_kernels(params, u, g, preset)
    kw = _kw(preset)
    fields = [torch.from_numpy(params[n]) for n in NAMES]
    with torch.no_grad():
        k6 = fused_grayscale_diffusion_fwd(torch.from_numpy(u), *fields, **kw)
    assert k6.shape == shape
    assert _max_err(k6, k6_ref) <= TOL
    leaves = [torch.from_numpy(u).requires_grad_()] + [
        f.clone().requires_grad_() for f in fields]
    out = fused_grayscale_diffusion(*leaves, **kw)
    assert _max_err(out.detach(), out_ref) <= TOL
    (out * torch.from_numpy(g)).sum().backward()
    for name, leaf, ref in zip(["u"] + NAMES, leaves, grads_ref):
        assert leaf.grad.shape == ref.shape, name
        assert _rel_err(leaf.grad, ref) <= GRAD_TOL, name
    y, res = fused_grayscale_fwd_res_plain(torch.from_numpy(u), *fields,
                                           **kw)
    for grid in (1, B):
        tiled = fused_grayscale_bwd_tiled(torch.from_numpy(g), res, y,
                                          *fields, grid=grid, per_image=True,
                                          **kw)
        for name, got, ref in zip(["u"] + NAMES, tiled, grads_ref):
            assert _rel_err(got, ref) <= GRAD_TOL, (grid, name)
    for backward in (False, True):
        assert isinstance(choose_gray_scheme(B, H, W, SMS, backward),
                          GrayWidePlan)


def test_grayscale_diffusion_96_fused_matches_jax():
    """GrayscaleDiffusion(size=96) on the mnist layer's settings with
    ``fused=True`` (train mode: output and every field's gradient) against
    the JAX layer with ``fused=True`` run by its Pallas kernel in interpret
    mode (``fused_interpret``, ``fused_tile_b`` the batch), and with
    ``fused_inference=True`` (eval: the K6 entry) against JAX's
    fused_grayscale_diffusion_fwd; weights carried by
    ``compat.state_dict_from_jax``."""
    rng = np.random.default_rng(9696)
    dt, steps, init = LAYERS["mnist"]
    params = _fields(rng, "mnist", 96, 96)
    u = rng.random((2, 1, 96, 96)).astype(np.float32)
    g = rng.standard_normal((2, 1, 96, 96)).astype(np.float32)
    jlayer = JaxGrayscale(96, dt=dt, num_steps=steps, init_value=init,
                          fused=True, fused_tile_b=2)
    jlayer.fused_interpret = True
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    ref, vjp = jax.vjp(lambda p: jlayer(p, {}, jnp.asarray(u))[0], jparams)
    (grads,) = vjp(jnp.asarray(g))
    k6_ref = jfwd.fused_grayscale_diffusion_fwd(
        jnp.asarray(u[:, 0]), *(jparams[n] for n in NAMES), dt=dt, dx=1.0,
        dy=1.0, num_steps=steps, ts=_substep_times(dt, steps), eps=EPS,
        tile_b=2, interpret=True)
    sd = state_dict_from_jax(params, {})
    flags = dict(dt=dt, num_steps=steps, init_value=init)
    trained = GrayscaleDiffusion(96, fused=True, **flags).train()
    trained.load_state_dict(sd, strict=True)
    out = trained(torch.from_numpy(u))
    assert out.shape == (2, 1, 96, 96)
    assert _max_err(out.detach(), ref) <= TOL
    (out * torch.from_numpy(g)).sum().backward()
    for name, p in trained.named_parameters():
        assert _rel_err(p.grad, grads[name]) <= GRAD_TOL, name
    served = GrayscaleDiffusion(96, fused_inference=True, **flags).eval()
    served.load_state_dict(sd, strict=True)
    with torch.no_grad():
        y = served(torch.from_numpy(u))
    assert _max_err(y, ref) <= TOL
    assert _max_err(y[:, 0], k6_ref) <= TOL


@pytest.mark.parametrize("preset", list(LAYERS))
def test_per_image_mirror_orders_like_the_wide_k8(preset):
    """``fused_grayscale_bwd_tiled(per_image=True)`` (each tile's images
    one at a time, each adjoint's smoothed, gated gradients of one image
    added to the tile's row as they come, the rows summed in K8's fixed
    order) against the plain backward over the whole batch, on ragged
    tiles (5 images over 2 and 3
    blocks), one image a tile, and more tiles than the sum's eight slices
    (11 over 11); the plain backward's ``acc`` adds to the tensors it is
    given."""
    rng = np.random.default_rng(43 if preset == "mnist" else 44)
    H, W = 6, 9
    fields = [torch.from_numpy(v) for v in
              _fields(rng, preset, H, W).values()]
    kw = _kw(preset)
    for batch, grids in ((5, (1, 2, 3, 5)), (11, (11,))):
        u = torch.from_numpy(rng.random((batch, H, W)).astype(np.float32))
        g = torch.from_numpy(rng.standard_normal((batch, H, W)).astype(
            np.float32))
        y, res = fused_grayscale_fwd_res_plain(u, *fields, **kw)
        plain = fused_grayscale_bwd_plain(g, res, y, *fields, **kw)
        for grid in grids:
            tiled = fused_grayscale_bwd_tiled(g, res, y, *fields, grid=grid,
                                              per_image=True, **kw)
            for name, s, p in zip(["u"] + NAMES, tiled, plain):
                assert s.shape == p.shape
                assert _rel_err(s, p) <= GRAD_TOL, (batch, grid, name)
        acc = [torch.ones_like(f) for f in fields]
        again = fused_grayscale_bwd_plain(g, res, y, *fields, acc=acc, **kw)
        for a, got, p in zip(acc, again[1:], plain[1:]):
            assert got is a
            assert _max_err(got, p + 1.0) <= TOL


def test_scheme_choice_keeps_todays_plan():
    """Every (H, W) with H, W ≤ 64 keeps exactly today's first-scheme plan
    (``plan_grayscale``), K6/K7 and K8, at B in {1, 7, 128, 1024}: the
    wide scheme changes nothing there."""
    for H in range(1, SHARED_MAX_N + 1):
        for W in range(1, SHARED_MAX_N + 1):
            for backward in (False, True):
                for B in (1, 7, 128, 1024):
                    assert choose_gray_scheme(B, H, W, SMS, backward) == \
                        plan_grayscale(B, H, W, SMS, backward), (H, W, B)
    assert plan_grayscale(7, 64, 64, SMS, backward=True).smem <= MAX_SMEM


WIDE_SHAPES = [(96, 96), (28, 100), (100, 28), (65, 64), (64, 65), (1, 65),
               (224, 224), (1024, 1024), (MAX_N, MAX_N), (1, MAX_N)]


def test_scheme_choice_goes_wide_past_64_pixels():
    """Past 64 pixels on either side the choice is a ``GrayWidePlan``
    (the first scheme's planner refuses (96, 96), whose image and factor
    ring pass a block's shared memory): two threads a line of the longer
    sweep in whole warps between WIDE_MIN_THREADS and WIDE_MAX_THREADS, a
    strip of lines' factors and x-line state in shared memory within
    WIDE_SMEM_BUDGET (all 96 lines at 96 × 96, at least one line at
    1,440), two workspace images a block forward and four backward,
    the factor table's slab of the first scheme, at most
    WIDE_BLOCKS_PER_SM blocks an SM, tiles that cover the batch."""
    with pytest.raises(ValueError, match="shared memory"):
        plan_grayscale(7, 96, 96, SMS)
    assert strip_lines(96, 96, 192) == 96 and strip_lines(MAX_N, MAX_N,
                                                          512) == 6
    for H, W in WIDE_SHAPES:
        for backward in (False, True):
            for B in (1, 2, 7, 128, 1024, 9216):
                plan = choose_gray_scheme(B, H, W, SMS, backward)
                assert isinstance(plan, GrayWidePlan), (H, W, backward)
                assert plan == gray_wide_plan(B, H, W, SMS, backward)
                assert plan.backward == backward
                assert plan.threads % 32 == 0
                assert plan.threads == min(
                    WIDE_MAX_THREADS,
                    max(WIDE_MIN_THREADS, -(-2 * max(H, W) // 32) * 32))
                lines = strip_lines(H, W, plan.threads)
                assert 1 <= lines <= min(plan.threads // 2, max(H, W))
                assert plan.smem == 4 * lines * (2 * (max(H, W) | 1)
                                                 + (W | 1))
                assert plan.smem <= WIDE_SMEM_BUDGET
                assert plan.workspace == (4 if backward else 2) * H * W
                assert plan.slab == slab_floats(H, W)
                assert 1 <= plan.grid <= min(B, WIDE_BLOCKS_PER_SM * SMS)
                assert plan.grid * (plan.tile - 1) < B <= plan.grid * plan.tile
                assert max(b - a for a, b in
                           _tile_bounds(B, plan.grid)) == plan.tile


def test_wide_workspace_stays_under_its_budget():
    """At (1,440, 1,440) the blocks' workspace (and K8's partial rows) stay
    under WIDE_WORKSPACE_BUDGET at every batch; ``wide_bytes`` adds the
    factor table (3 num_steps slabs: about 0.75 GB at 10 steps)."""
    for backward in (False, True):
        for B in (1, 2, 64, 1024):
            plan = choose_gray_scheme(B, MAX_N, MAX_N, SMS, backward)
            row = partial_floats(MAX_N, MAX_N) if backward else 0
            assert 4 * plan.grid * (plan.workspace + row) <= \
                WIDE_WORKSPACE_BUDGET
            table = 4 * 3 * 10 * plan.slab
            assert 0.7e9 < table < 0.8e9
            assert wide_bytes(plan, MAX_N, MAX_N, 10) == \
                table + 4 * plan.grid * (plan.workspace + row)


@pytest.mark.parametrize("shape", [(MAX_N + 1, 8), (8, MAX_N + 1), (0, 8)])
def test_past_max_n_raises_naming_the_limit(shape):
    """H or W outside [1, MAX_N] (K1/K3's 1,440) raises a ValueError that
    names MAX_N, from the scheme choice and from the wrappers' argument
    check; MAX_N itself is taken."""
    assert MAX_N == 1440 and SHARED_MAX_N == 64
    H, W = shape
    with pytest.raises(ValueError, match="MAX_N"):
        choose_gray_scheme(2, H, W, SMS)
    f = torch.zeros(shape)
    with pytest.raises(ValueError, match="MAX_N"):
        check_layer_args("k", torch.zeros((1, H, W)), f, f, f, f,
                         torch.zeros(2, 3))
    f = torch.zeros((MAX_N, MAX_N))
    check_layer_args("k", torch.zeros((1, MAX_N, MAX_N)), f, f, f, f,
                     torch.zeros(2, 3))


@pytest.mark.parametrize("ok", [True, False])
def test_bind_checks_the_wide_launch_shape(monkeypatch, ok):
    """A wide plan launches only if csrc/fused_grayscale_wide.cu reports for
    it the threads a block, the bytes of shared memory a block, the floats a
    sweep in the factor table and the floats of workspace a block that the
    plan was made with, once a plan."""
    shape = (96, 96)
    plan = choose_gray_scheme(128, *shape, SMS, backward=True)
    asked = []

    def function(name, symbol, argtypes):
        if symbol != "fused_grayscale_wide_layout":
            return symbol

        def layout_fn(*args):
            asked.append(args[:3])
            threads, smem, workspace, slab = args[3:]
            threads._obj.value = plan.threads
            smem._obj.value = plan.smem
            workspace._obj.value = plan.workspace + (0 if ok else 1)
            slab._obj.value = plan.slab
            return 0
        assert argtypes[-2] is ctypes.POINTER(ctypes.c_longlong)
        return layout_fn

    monkeypatch.setattr(fused_grayscale.kernels, "function", function)
    monkeypatch.setattr(fused_grayscale, "_layout_checked", set())
    if ok:
        for _ in range(2):
            assert fused_grayscale.bind(
                "fused_grayscale_wide", "entry", None,
                "fused_grayscale_wide_layout", shape, plan) == "entry"
        assert asked == [(*shape, 1)]
    else:
        with pytest.raises(RuntimeError,
                           match="fused_grayscale_wide_layout"):
            fused_grayscale.bind("fused_grayscale_wide", "entry", None,
                                 "fused_grayscale_wide_layout", shape, plan)
        assert not fused_grayscale._layout_checked
