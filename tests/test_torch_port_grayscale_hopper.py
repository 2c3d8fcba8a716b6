"""The plain mirrors of the grayscale kernels' structure (K6, K7 in
csrc/fused_grayscale.cu and K8 in csrc/fused_grayscale_vjp.cu) on the CPU:
the kernels' line solve (a batch-free factor table of each smoothed,
one-sided-clamped sweep system, factored from both ends of a line toward
its middle row, then applied by two threads a line) on the system and its
transpose against the TPU kernels' own sweeps; the whole layer run on that
solve against the plain version; K8's reduction (per-tile partial field
gradients over all steps, summed over tiles in the kernel's fixed order)
against the port's plain backward and ``jax.vjp`` of the JAX package's
trainable fused layer run by its Pallas kernels in interpret mode; the
launch plan that spreads a batch over the blocks, and the check that the
kernels' launch shape is the plan's.

Tolerances: 1e-5 abs on solves and layer outputs (one system, another
rounding order); 1e-4 of each gradient's largest entry (sums over images,
tiles and steps taken in another order).  Fields straddle eps, so the
one-sided clamp acts; no raw value sits on eps itself.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_pde_tpu.ops import pallas_fused_adi_vjp as jvjp
from cnn_pde_tpu.ops.pallas_fused_adi import _sweep_rows
from cnn_pde_tpu_torch.ops import fused_grayscale
from cnn_pde_tpu_torch.ops.fused_channel import MAX_SMEM, _dt_factors
from cnn_pde_tpu_torch.ops.fused_grayscale import (
    GrayPlan, fused_grayscale_diffusion_plain, gray_factors, gray_solve,
    plan_grayscale)
from cnn_pde_tpu_torch.ops.fused_grayscale_vjp import (
    fused_grayscale_bwd_plain, fused_grayscale_bwd_tiled,
    fused_grayscale_fwd_res_plain)
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
EPS = 1e-6
TOL = 1e-5
GRAD_TOL = 1e-4
SMS = 132  # an H100's SMs


def _max_err(x, y):
    return float(np.max(np.abs(np.asarray(x, np.float64)
                               - np.asarray(y, np.float64))))


def _rel_err(x, y):
    y = np.asarray(y, np.float64)
    return float(np.max(np.abs(np.asarray(x, np.float64) - y))
                 / max(np.max(np.abs(y)), 1e-30))


def _clamped_field(rng, shape):
    """max(raw, eps) of raw values on both sides of eps (the first below,
    the last above), none on it."""
    raw = rng.uniform(-0.5, 2.0, shape)
    raw[np.abs(raw - EPS) < 1e-5] = 0.5
    raw.flat[0], raw.flat[-1] = -0.25, 1.25
    return np.maximum(raw, EPS).astype(np.float32)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 28, 33, 64])
def test_line_solve_matches_the_tpu_kernels_sweeps(n, transpose):
    """gray_solve(gray_factors(...)), the kernels' arithmetic, on the sweep
    system of a smoothed, one-sided-clamped field (or its transpose, each
    K8 adjoint's, solved from T's own pivots) against the JAX package's
    _sweep_rows(smooth=True) / _sweepT_rows (the TPU kernels' sweeps)."""
    rng = np.random.default_rng(600 + n + 7 * transpose)
    field = _clamped_field(rng, (5, n))
    lines = rng.standard_normal((3, 5, n)).astype(np.float32)
    dtf = 0.4
    x = gray_solve(gray_factors(torch.from_numpy(field), dtf, EPS),
                   torch.from_numpy(lines), transpose)
    if transpose:
        ref = jax.jit(jvjp._sweepT_rows, static_argnums=(2, 3, 4))(
            jnp.asarray(lines), jnp.asarray(field), dtf, EPS, n)
    else:
        ref = jax.jit(_sweep_rows, static_argnums=(2, 3, 4, 5, 6))(
            jnp.asarray(lines), jnp.asarray(field), dtf, 1.0, EPS, True, n)
    assert x.shape == lines.shape
    assert _max_err(x, ref) <= TOL


def _case(size, steps, dt, batch, seed):
    """Fields whose raw values at the substep times fall on both sides of
    eps, an input and a cotangent, from a numpy seed."""
    rng = np.random.default_rng(seed)
    fields = {
        "alpha_base": rng.uniform(-0.6, 1.6, (size, size)),
        "alpha_time_coeff": rng.standard_normal((size, size)) / (dt * steps),
        "beta_base": rng.uniform(-0.6, 1.6, (size, size)),
        "beta_time_coeff": rng.standard_normal((size, size)) / (dt * steps),
    }
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    u = rng.random((batch, size, size)).astype(np.float32)
    g = rng.standard_normal((batch, size, size)).astype(np.float32)
    ts = _substep_times_np(dt, steps)
    raw = fields["alpha_base"] + fields["alpha_time_coeff"] * ts[-1, 2]
    assert (raw > EPS).any() and (raw < EPS).any()
    assert np.abs(raw - EPS).min() > 1e-6
    return fields, u, g, ts


def _table_layer(u, ab, atc, bb, btc, *, dt, dx, dy, ts, eps):
    """The layer's Strang steps with every sweep solved by the kernels'
    line solve (gray_factors, gray_solve): x along W, y down the columns."""
    dtf_x, dtf_y = _dt_factors(dt, dx, dy, "strang")
    for s in range(ts.shape[0]):
        for q, (base, tc, dtf) in enumerate(((ab, atc, dtf_x),
                                             (bb, btc, dtf_y),
                                             (ab, atc, dtf_x))):
            field = (base + tc * ts[s, q]).clamp_min(eps)
            if q == 1:
                u = gray_solve(gray_factors(field.T, dtf, eps),
                               u.transpose(-1, -2)).transpose(-1, -2)
            else:
                u = gray_solve(gray_factors(field, dtf, eps), u)
    return u


@pytest.mark.parametrize("size,steps,dt", [(12, 3, 0.3), (28, 2, 0.001)])
def test_factor_table_runs_the_layer_as_the_plain_version(size, steps, dt):
    """K6's arithmetic over a whole layer (each sweep's factor table made
    from the smoothed, clamped fields at its substep time, then applied)
    against the plain version (PCR, the TPU kernel's sweep)."""
    fields, u, _, ts = _case(size, steps, dt, 3, seed=size + 1)
    kw = dict(dt=dt, dx=1.0, dy=1.0,
              ts=torch.tensor(ts, dtype=torch.float32), eps=EPS)
    f = [torch.from_numpy(fields[k]) for k in NAMES]
    out = _table_layer(torch.from_numpy(u), *f, **kw)
    ref = fused_grayscale_diffusion_plain(torch.from_numpy(u), *f, **kw)
    assert _max_err(out, ref) <= TOL


@functools.lru_cache(maxsize=None)
def _jax_grads(size, steps, dt, batch, seed):
    """The five gradients of <g, layer(u)> by jax.vjp through the JAX fused
    layer, its forward and backward Pallas kernels in interpret mode."""
    fields, u, g, ts = _case(size, steps, dt, batch, seed)
    ts_tuple = tuple(map(tuple, ts.tolist()))

    def layer(u2, *f):
        return jvjp.fused_grayscale_diffusion(u2, *f, dt, 1.0, 1.0, steps,
                                              ts_tuple, EPS, 4, True)

    args = [jnp.asarray(u)] + [jnp.asarray(fields[k]) for k in NAMES]
    _, vjp = jax.vjp(layer, *args)
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("size,batch,grid", [(12, 5, 2), (12, 5, 3),
                                             (28, 7, 3), (28, 7, 7)])
def test_tiled_k8_reduction_matches_plain_and_jax(size, batch, grid):
    """K8's reduction mirror (the batch over tiles of 2-3 images, or one,
    none of them even) against the plain backward over the whole batch and
    jax.vjp of the JAX layer (B5 in interpret mode)."""
    steps, dt = (3, 0.3) if size == 12 else (2, 0.001)
    seed = 40 + size
    fields, u, g, ts = _case(size, steps, dt, batch, seed)
    kw = dict(dt=dt, dx=1.0, dy=1.0,
              ts=torch.tensor(ts, dtype=torch.float32), eps=EPS)
    f = [torch.from_numpy(fields[k]) for k in NAMES]
    out, res = fused_grayscale_fwd_res_plain(torch.from_numpy(u), *f, **kw)
    gt = torch.from_numpy(g)
    tiled = fused_grayscale_bwd_tiled(gt, res, out, *f, grid=grid, **kw)
    plain = fused_grayscale_bwd_plain(gt, res, out, *f, **kw)
    ref = _jax_grads(size, steps, dt, batch, seed)
    for name, t, p, r in zip(["u"] + NAMES, tiled, plain, ref):
        assert t.shape == p.shape == r.shape, name
        assert _rel_err(t, p) <= GRAD_TOL, name
        assert _rel_err(t, r) <= GRAD_TOL, name
    # the clamp gate acts: some field gradients are gated off
    assert (tiled[1] == 0).any() and (tiled[1] != 0).any()


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("shape", [(28, 28), (12, 12), (1, 28), (64, 64)])
@pytest.mark.parametrize("batch", [1, 7, 128, 1024])
def test_plan_fills_the_card_within_its_limits(batch, shape, backward):
    """At least one block an SM of an H100 where the batch allows it, tiles
    of 1 to 4 whole images that cover the batch as evenly as they split,
    256 to 1024 threads a block in whole warps, at most 232,448 bytes of
    shared memory a block, for K6/K7 and K8."""
    plan = plan_grayscale(batch, *shape, SMS, backward=backward)
    assert isinstance(plan, GrayPlan)
    assert plan.grid >= min(batch, SMS)
    assert 1 <= plan.tile <= 4
    assert plan.grid * plan.tile >= batch > plan.grid * (plan.tile - 1)
    assert 256 <= plan.threads <= 1024 and plan.threads % 32 == 0
    assert plan.smem <= MAX_SMEM
    assert plan.slab % 4 == 0  # 16-byte copies of each sweep's slab


@pytest.mark.parametrize("shape,backward", [((96, 96), False),
                                            ((72, 72), True)])
def test_plan_raises_on_a_shape_that_cannot_fit(shape, backward):
    """One image's buffers beside the factor buffers (and K8's partials)
    beyond the shared memory a block may use."""
    with pytest.raises(ValueError, match="shared memory"):
        plan_grayscale(7, *shape, SMS, backward=backward)


@pytest.mark.parametrize("source,symbol,backward", [
    ("fused_grayscale", "fused_grayscale_layout", False),
    ("fused_grayscale_vjp", "fused_grayscale_bwd_layout", True)])
@pytest.mark.parametrize("ok", [True, False])
def test_bind_checks_the_kernel_launch_shape(monkeypatch, source, symbol,
                                             backward, ok):
    """The wrappers launch K6/K7 and K8 on a plan only if the C side reports
    for it the threads a block, the bytes of shared memory a block and the
    floats a sweep takes in the factor table that the plan was made with;
    the check runs once a plan."""
    shape = (28, 28)
    plan = plan_grayscale(1024, *shape, SMS, backward=backward)
    asked = []

    def function(name, sym, argtypes):
        if sym != symbol:
            return sym

        def layout_fn(*args):
            asked.append(args[:3])
            threads, smem, slab = args[3:]
            threads._obj.value = plan.threads
            smem._obj.value = plan.smem if ok else plan.smem + 4
            slab._obj.value = plan.slab
            return 0
        return layout_fn

    monkeypatch.setattr(fused_grayscale.kernels, "function", function)
    monkeypatch.setattr(fused_grayscale, "_layout_checked", set())
    if ok:
        for _ in range(2):
            assert fused_grayscale.bind(source, "entry", None, symbol, shape,
                                        plan) == "entry"
        assert asked == [(*shape, plan.tile)]
    else:
        with pytest.raises(RuntimeError, match=symbol):
            fused_grayscale.bind(source, "entry", None, symbol, shape, plan)
        assert not fused_grayscale._layout_checked
