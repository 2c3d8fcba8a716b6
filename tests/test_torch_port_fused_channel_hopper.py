"""The plain mirrors of the fused channel kernels' structure (K2, K4, K5 in
csrc/fused_channel.cu and csrc/fused_channel_vjp.cu) on the CPU: K5's
reduction (per-tile partial gradients accumulated over all steps, then
summed over tiles in the kernel's fixed order) against the port's plain
backward and ``jax.vjp`` of the JAX package's trainable fused layer run by
its Pallas kernels in interpret mode; the kernels' line solve (Thomas
factors made once, then applied) on the sweep system and its transpose
against the plain version's PCR and the TPU kernel's own sweeps; PCR on the
transposed system, the plain version of each K5 adjoint, against the TPU
kernel's transposed sweep; the launch plan that spreads a batch over the
blocks, and the check that the kernels' launch shape is the plan's.

Tolerances: 1e-4 of each gradient's largest entry (sums over images, tiles
and steps taken in another order); 1e-5 abs on solves (one system, another
rounding order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_pde_tpu.ops import pallas_fused_channel_vjp as jvjp
from cnn_pde_tpu.pde.diffusion import _substep_times
from cnn_pde_tpu_torch.ops import fused_channel, fused_channel_vjp
from cnn_pde_tpu.ops import pallas_fused_channel as jfwd
from cnn_pde_tpu_torch.ops.fused_channel import (
    MAX_SMEM, THREADS, _abc_nosmooth, _sweep_nosmooth,
    plan_tiles, thomas_apply, thomas_factors)
from cnn_pde_tpu_torch.ops.fused_channel_vjp import (
    _sweepT_nosmooth, _tile_bounds, bwd_plan,
    fused_channel_bwd_plain, fused_channel_bwd_tiled,
    fused_channel_fwd_res_plain)
from cnn_pde_tpu_torch.ops.tridiag import (_transpose_system, pcr_apply,
                                           pcr_factor, tridiag_solve_plain)
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
GRAD_TOL = 1e-4
TOL = 1e-5
C, H, W, STEPS, DT, CMAX = 2, 6, 7, 3, 0.02, 2.0


def _rel_err(x, y):
    y = np.asarray(y, np.float64)
    return float(np.max(np.abs(np.asarray(x, np.float64) - y))
                 / max(np.max(np.abs(y)), 1e-30))


def _case(splitting, batch):
    """Fields whose raw values straddle both clamp bounds over the layer's
    horizon, a ragged batch and a cotangent, from a numpy seed."""
    rng = np.random.default_rng(11 if splitting == "strang" else 12)
    params = {
        "alpha_base": rng.uniform(-0.5, CMAX + 0.5, (C, H, W)),
        "alpha_time_coeff": rng.standard_normal((C, H, W)) * 5.0,
        "beta_base": rng.uniform(-0.5, CMAX + 0.5, (C, H, W)),
        "beta_time_coeff": rng.standard_normal((C, H, W)) * 5.0,
        "channel_mixing": np.eye(C) + 0.05 * rng.standard_normal((C, C)),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    u = rng.random((batch, C, H, W)).astype(np.float32)
    g = rng.standard_normal((batch, C, H, W)).astype(np.float32)
    return params, u, g


def _kw(splitting):
    return dict(dt=DT, dx=1.0, dy=1.5, splitting=splitting, eps=1e-6,
                cmax=CMAX, ts=torch.tensor(_substep_times_np(DT, STEPS),
                                           dtype=torch.float32))


@functools.lru_cache(maxsize=None)
def _jax_grads(splitting, batch):
    """The six gradients of <g, layer(u)> by jax.vjp through the JAX fused
    layer, its forward and backward Pallas kernels in interpret mode."""
    params, u, g = _case(splitting, batch)
    ts = tuple(map(tuple, np.asarray(_substep_times(DT, STEPS),
                                     np.float64).tolist()))

    def layer(u2, *p):
        return jvjp.fused_channel_diffusion(u2, *p, DT, 1.0, 1.5, STEPS, ts,
                                            splitting, 1e-6, CMAX, 4, True)

    args = [jnp.asarray(u)] + [jnp.asarray(params[n]) for n in NAMES]
    _, vjp = jax.vjp(layer, *args)
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("batch,grid", [(5, 2), (5, 3), (11, 10), (11, 11)])
@pytest.mark.parametrize("splitting", ["strang", "lie"])
def test_tiled_k5_reduction_matches_plain_and_jax(splitting, batch, grid):
    """K5's reduction mirror (tiles of 2-3, 1-2 and 1 images; ten and eleven
    tiles are more than the partial sum's eight slices) against the plain
    backward over the whole batch and jax.vjp of the JAX layer."""
    params, u, g = _case(splitting, batch)
    kw = _kw(splitting)
    fields = [torch.from_numpy(params[n]) for n in NAMES]
    out, res = fused_channel_fwd_res_plain(torch.from_numpy(u), *fields, **kw)
    gt = torch.from_numpy(g)
    tiled = fused_channel_bwd_tiled(gt, res, out, *fields, grid=grid, **kw)
    plain = fused_channel_bwd_plain(gt, res, out, *fields, **kw)
    ref = _jax_grads(splitting, batch)
    for name, t, p, r in zip(["u"] + NAMES, tiled, plain, ref):
        assert t.shape == p.shape == r.shape, name
        assert _rel_err(t, p) <= GRAD_TOL, name
        assert _rel_err(t, r) <= GRAD_TOL, name
    # both clamps are crossed: some field gradients are gated off
    assert (tiled[1] == 0).any() and (tiled[1] != 0).any()


@pytest.mark.parametrize("batch,grid", [(1, 1), (7, 3), (64, 132),
                                        (512, 132), (1024, 256)])
def test_tile_bounds_cover_the_batch_evenly(batch, grid):
    """Blocks take consecutive whole images, each image once, their counts
    differing by at most one."""
    grid = min(grid, batch)
    bounds = _tile_bounds(batch, grid)
    assert bounds[0][0] == 0 and bounds[-1][1] == batch
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    sizes = {last - first for first, last in bounds}
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("shape", [(3, 32, 32), (1, 28, 28), (2, 20, 33)])
@pytest.mark.parametrize("batch", [1, 7, 64, 512, 1024])
def test_tile_plan_fills_the_card_within_its_limits(batch, shape):
    """At least one block an SM of an H100 (132) where the batch allows it,
    and at most one where the images fit; tiles of at least one image that
    cover the batch, at most 1024 threads and 232,448 bytes of shared memory
    a block, one or two factor buffers and at most two staged fields, for
    the forward and the backward."""
    sms = 132
    assert THREADS <= 1024
    for plan in (plan_tiles(batch, *shape, sms), bwd_plan(batch, *shape, sms)):
        grid, tile = plan.grid, plan.tile
        assert grid >= min(batch, sms)
        assert tile >= 1 and grid * tile >= batch > grid * (tile - 1)
        assert plan.smem <= MAX_SMEM
        assert plan.nbuf in (1, 2) and 0 <= plan.staged <= 2
    if batch >= sms:
        assert plan_tiles(batch, *shape, sms).grid == sms


@pytest.mark.parametrize("shape,backward", [((8, 64, 64), True),
                                            ((8, 64, 64), False),
                                            ((4, 64, 64), True)])
def test_tile_plan_raises_on_a_shape_that_cannot_fit(shape, backward):
    """One image's buffers and one factor buffer beyond the shared memory a
    block may use."""
    with pytest.raises(ValueError, match="shared memory"):
        if backward:
            bwd_plan(7, *shape, 132)
        else:
            plan_tiles(7, *shape, 132)


@pytest.mark.parametrize("module,symbol,planner", [
    (fused_channel, "fused_channel_layout", plan_tiles),
    (fused_channel_vjp, "fused_channel_bwd_layout", bwd_plan)])
@pytest.mark.parametrize("ok", [True, False])
def test_bind_checks_the_kernel_launch_shape(monkeypatch, module, symbol,
                                             planner, ok):
    """The wrappers launch K2/K4 and K5 on a plan only if the C side reports
    for it the threads a block and the bytes of shared memory a block that
    the plan was made with; the check runs once a plan."""
    shape = (3, 32, 32)
    plan = planner(512, *shape, 132)
    asked = []

    def function(name, sym, argtypes):
        if sym != symbol:
            return sym

        def layout_fn(*args):
            asked.append(args[:6])
            threads, smem = args[6:]
            threads._obj.value = THREADS
            smem._obj.value = plan.smem if ok else plan.smem + 4
            return 0
        return layout_fn

    monkeypatch.setattr(fused_channel.kernels, "function", function)
    monkeypatch.setattr(fused_channel, "_layout_checked", set())
    name = module.__name__.rsplit(".", 1)[1]
    if ok:
        for _ in range(2):
            assert fused_channel.bind(name, "entry", None, symbol, shape,
                                      plan) == "entry"
        assert asked == [(*shape, plan.tile, plan.nbuf, plan.staged)]
    else:
        with pytest.raises(RuntimeError, match=symbol):
            fused_channel.bind(name, "entry", None, symbol, shape, plan)
        assert not fused_channel._layout_checked


@pytest.mark.parametrize("n", [1, 2, 20, 32, 33])
def test_transposed_pcr_matches_the_tpu_kernels_adjoint_sweep(n):
    """pcr_apply(pcr_factor(Tᵀ)) on the fused sweep's bands (a clamped field
    on both sides of eps, lines of n rows) against the JAX package's
    _sweepT_nosmooth (the TPU kernel's transposed solve), the port's, and
    the Thomas recurrence on Tᵀ."""
    rng = np.random.default_rng(300 + n)
    field = np.clip(rng.uniform(-0.5, 3.0, (2, 5, n)), 1e-6, CMAX)
    field = field.astype(np.float32)
    lines = rng.standard_normal((3, 2, 5, n)).astype(np.float32)
    dtf, eps = 0.4, 1e-6
    f, d = torch.from_numpy(field), torch.from_numpy(lines)
    bands = _transpose_system(*_abc_nosmooth(f, dtf, eps))
    lam = pcr_apply(pcr_factor(*bands), d)
    ref = jvjp._sweepT_nosmooth(jnp.asarray(lines), jnp.asarray(field), dtf,
                                eps, n)
    assert lam.shape == d.shape
    assert float(np.max(np.abs(lam.numpy() - np.asarray(ref)))) <= TOL
    assert torch.equal(lam, _sweepT_nosmooth(d, f, dtf, eps))
    assert float((lam - tridiag_solve_plain(*bands, d)).abs().max()) <= TOL


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("n", [1, 2, 20, 32, 33])
def test_kernel_line_solve_matches_pcr_and_the_tpu_kernels_sweeps(n,
                                                                  transpose):
    """thomas_apply(thomas_factors(...)), the kernels' arithmetic, on the
    fused sweep's system (or its transpose, each K5 adjoint's) against the
    plain version's PCR and the JAX package's _sweep_nosmooth /
    _sweepT_nosmooth (the TPU kernels' sweeps)."""
    rng = np.random.default_rng(500 + n + 7 * transpose)
    field = np.clip(rng.uniform(-0.5, 3.0, (2, 5, n)), 1e-6, CMAX)
    field = field.astype(np.float32)
    lines = rng.standard_normal((3, 2, 5, n)).astype(np.float32)
    dtf, eps = 0.4, 1e-6
    f, d = torch.from_numpy(field), torch.from_numpy(lines)
    x = thomas_apply(thomas_factors(f * dtf, eps, transpose), d, transpose)
    if transpose:
        plain = _sweepT_nosmooth(d, f, dtf, eps)
        ref = jvjp._sweepT_nosmooth(jnp.asarray(lines), jnp.asarray(field),
                                    dtf, eps, n)
    else:
        plain = _sweep_nosmooth(d, f, dtf, eps)
        ref = jfwd._sweep_nosmooth(jnp.asarray(lines), jnp.asarray(field),
                                   dtf, eps, n)
    assert x.shape == d.shape
    assert float((x - plain).abs().max()) <= TOL
    assert float(np.max(np.abs(x.numpy() - np.asarray(ref)))) <= TOL
