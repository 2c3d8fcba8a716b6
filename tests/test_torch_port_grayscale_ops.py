"""The grayscale family's ops in the port against the JAX package on the CPU,
where every wrapper runs its plain version: ``smooth3``, the sweeps with
smoothing, K6's plain version against the TPU kernel B4 in interpret mode,
and K7's and K8's plain versions and the trainable fused layer against B5 in
interpret mode and against ``jax.grad`` through the XLA path.

Tolerances: 1e-6 abs on ``smooth3`` (three products and two sums in the
same order); 1e-5 abs on solves and layer outputs (Thomas against PCR, or
PCR against PCR, in float32); gradients within 1e-4 of the largest entry of
the tensor they are held against (sums over the batch and along the lines
run in another order).  The fields straddle eps, so the one-sided clamp
gate acts; no raw value sits on eps itself, where JAX's ``maximum`` splits
the gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_pde_tpu.ops import adi as jadi
from cnn_pde_tpu.ops.pallas_fused_adi import (
    fused_grayscale_diffusion_fwd as jax_b4)
from cnn_pde_tpu.ops.pallas_fused_adi_vjp import (
    fused_grayscale_diffusion as jax_b5)
from cnn_pde_tpu.ops.smoothing import smooth3 as jax_smooth3
from cnn_pde_tpu.pde import GrayscaleDiffusion as JaxGrayscale
from cnn_pde_tpu_torch.ops import smooth3, sweep_x, sweep_y
from cnn_pde_tpu_torch.ops.fused_grayscale import (
    check_layer_args, fused_grayscale_diffusion_fwd,
    fused_grayscale_diffusion_plain, plan_grayscale)
from cnn_pde_tpu_torch.ops.fused_grayscale_vjp import (
    fused_grayscale_bwd, fused_grayscale_bwd_plain,
    fused_grayscale_diffusion, fused_grayscale_fwd_res,
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


EPS = 1e-6
NAMES = ["alpha_base", "alpha_time_coeff", "beta_base", "beta_time_coeff"]


def _close_rel(port, ref, name, tol=1e-4):
    """max |port - ref| within ``tol`` of ref's largest entry."""
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, name
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max(), (name, err, np.abs(ref).max())


def _max_err(x, y):
    return float(np.max(np.abs(np.asarray(x, np.float64)
                               - np.asarray(y, np.float64))))


def _case(size, steps, dt, batch=5, seed=0, straddle=True):
    """Fields whose raw values at the substep times fall on both sides of
    eps (bases uniform on [-0.6, 1.6], time coefficients N(0, 1)/dt so that
    they move over the layer's horizon), an input and a cotangent."""
    rng = np.random.default_rng(seed)
    lo = -0.6 if straddle else 0.8
    fields = {
        "alpha_base": rng.uniform(lo, 1.6, (size, size)),
        "alpha_time_coeff": rng.standard_normal((size, size))
        / (dt * steps),
        "beta_base": rng.uniform(lo, 1.6, (size, size)),
        "beta_time_coeff": rng.standard_normal((size, size))
        / (dt * steps),
    }
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    u = rng.random((batch, size, size)).astype(np.float32)
    g = rng.standard_normal((batch, size, size)).astype(np.float32)
    ts = _substep_times_np(dt, steps)
    raw = fields["alpha_base"] + fields["alpha_time_coeff"] * ts[-1, 2]
    if straddle:
        assert (raw > EPS).any() and (raw < EPS).any()
    assert np.abs(raw - EPS).min() > 1e-6
    return fields, u, g, ts


def _tensors(fields):
    return [torch.from_numpy(fields[k]) for k in NAMES]


@pytest.mark.parametrize("dim", [-1, -2])
@pytest.mark.parametrize("shape", [(3, 12, 12), (28, 28), (2, 5, 1)])
def test_smooth3_matches_jax(shape, dim):
    field = np.random.default_rng(len(shape)).standard_normal(shape).astype(
        np.float32)
    out = smooth3(torch.from_numpy(field), dim)
    assert _max_err(out, jax_smooth3(jnp.asarray(field), axis=dim)) <= 1e-6


@pytest.mark.parametrize("shape", [(12, 12), (28, 28), (3, 12, 7)])
def test_sweeps_with_smoothing_match_jax(shape):
    """sweep_x and sweep_y with smooth=True: the forward within 1e-5 and the
    gradients in u and the field within 1e-4 of their largest entry,
    against jax.grad through ops/adi.py (the XLA path)."""
    rng = np.random.default_rng(sum(shape))
    u = rng.random((4, *shape)).astype(np.float32)
    field = (0.2 + 2.0 * rng.random(shape)).astype(np.float32)
    gw = rng.standard_normal((4, *shape)).astype(np.float32)
    for port_fn, jax_fn, dt, dh in ((sweep_x, jadi.sweep_x, 0.15, 1.0),
                                    (sweep_y, jadi.sweep_y, 0.3, 1.5)):
        def loss(v, f):
            return jnp.sum(jax_fn(v, f, dt, dh, smooth=True, eps=EPS) * gw)

        ref = jax_fn(u, field, dt, dh, smooth=True, eps=EPS)
        ref_gu, ref_gf = jax.grad(loss, argnums=(0, 1))(u, field)
        tu, tf = (torch.from_numpy(t).requires_grad_(True)
                  for t in (u, field))
        out = port_fn(tu, tf, dt, dh, eps=EPS, smooth=True)
        (out * torch.from_numpy(gw)).sum().backward()
        name = port_fn.__name__
        assert _max_err(out.detach(), ref) <= 1e-5, name
        _close_rel(tu.grad, ref_gu, f"{name} grad u")
        _close_rel(tf.grad, ref_gf, f"{name} grad field")


def test_sweep_y_smooths_along_h():
    """A β field that varies only along H changes under smoothing along H
    and not along W: the port's y-sweep, which solves down the columns in
    place, must smooth along dim -2 as JAX's transposed sweep does."""
    H, W = 12, 9
    beta = np.repeat(np.linspace(0.1, 3.0, H, dtype=np.float32)[:, None] ** 2,
                     W, axis=1)
    u = np.random.default_rng(3).random((2, H, W)).astype(np.float32)
    ref = np.asarray(jadi.sweep_y(u, beta, 0.5, 1.0, smooth=True, eps=EPS))
    unsmoothed = np.asarray(jadi.sweep_y(u, beta, 0.5, 1.0, smooth=False,
                                         eps=EPS))
    assert _max_err(ref, unsmoothed) > 1e-3
    out = sweep_y(torch.from_numpy(u), torch.from_numpy(beta), 0.5, 1.0,
                  eps=EPS, smooth=True)
    assert _max_err(out, ref) <= 1e-5


@pytest.mark.parametrize("size,steps,dt", [(12, 3, 0.3), (28, 2, 0.001)])
def test_k6_plain_matches_b4_in_interpret_mode(size, steps, dt):
    fields, u, _, ts = _case(size, steps, dt)
    ref = jax_b4(jnp.asarray(u), *(jnp.asarray(fields[k]) for k in NAMES),
                 dt=dt, dx=1.0, dy=1.0, num_steps=steps, ts=ts, eps=EPS,
                 tile_b=4, interpret=True)
    out = fused_grayscale_diffusion_fwd(
        torch.from_numpy(u), *_tensors(fields), dt=dt, dx=1.0, dy=1.0,
        ts=torch.tensor(ts, dtype=torch.float32), eps=EPS)
    assert out.shape == u.shape
    assert _max_err(out, ref) <= 1e-5


def _jax_b5_grads(fields, u, g, ts, dt, steps):
    ts_tuple = tuple(map(tuple, ts.tolist()))

    def loss(u2, *f):
        out = jax_b5(u2, *f, dt, 1.0, 1.0, steps, ts_tuple, EPS, 4, True)
        return jnp.sum(out * g), out

    (_, out), grads = jax.value_and_grad(loss, argnums=tuple(range(5)),
                                         has_aux=True)(
        jnp.asarray(u), *(jnp.asarray(fields[k]) for k in NAMES))
    return np.asarray(out), [np.asarray(x) for x in grads]


def _jax_xla_grads(fields, u, g, dt, steps):
    """jax.grad through the JAX layer's default (XLA scan) path."""
    size = u.shape[-1]
    layer = JaxGrayscale(size, dt=dt, num_steps=steps)

    def loss(p, x):
        out, _ = layer.apply(p, {}, x, None)
        return jnp.sum(out[:, 0] * g), out[:, 0]

    (_, out), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(
        {k: jnp.asarray(v) for k, v in fields.items()},
        jnp.asarray(u[:, None]))
    return np.asarray(out), [np.asarray(gx[:, 0])] + [
        np.asarray(gp[k]) for k in NAMES]


@pytest.mark.parametrize("size,steps,dt", [(12, 3, 0.3), (28, 2, 0.001)])
def test_k7_k8_plain_match_b5_in_interpret_mode(size, steps, dt):
    """K7's plain version (output and residuals) and K8's plain version
    (five gradients) against B5's own forward and backward kernels in
    interpret mode, on a ragged batch of 5 over tiles of 4."""
    fields, u, g, ts = _case(size, steps, dt, seed=size)
    ref_out, ref_grads = _jax_b5_grads(fields, u, g, ts, dt, steps)
    tts = torch.tensor(ts, dtype=torch.float32)
    kw = dict(dt=dt, dx=1.0, dy=1.0, ts=tts, eps=EPS)
    out, res = fused_grayscale_fwd_res_plain(torch.from_numpy(u),
                                             *_tensors(fields), **kw)
    assert _max_err(out, ref_out) <= 1e-5
    assert res.shape == (steps, *u.shape)
    assert torch.equal(res[0], torch.from_numpy(u))
    grads = fused_grayscale_bwd_plain(torch.from_numpy(g), res, out,
                                      *_tensors(fields), **kw)
    for name, p, r in zip(["u"] + NAMES, grads, ref_grads):
        _close_rel(p, r, f"grad {name}")


@pytest.mark.parametrize("size,steps,dt", [(12, 4, 0.3), (28, 3, 0.001)])
def test_fused_grayscale_function_matches_xla_grads(size, steps, dt):
    """The autograd Function (K7 and K8's plain versions on the CPU): its
    output within 1e-5 and its five gradients within 1e-4 of their largest
    entry against jax.grad through the JAX layer's XLA scan."""
    fields, u, g, ts = _case(size, steps, dt, seed=size + steps)
    ref_out, ref_grads = _jax_xla_grads(fields, u, g, dt, steps)
    tens = [torch.from_numpy(u).requires_grad_(True)] + [
        t.requires_grad_(True) for t in _tensors(fields)]
    launches = (fused_grayscale_fwd_res.launches,
                fused_grayscale_bwd.launches)
    out = fused_grayscale_diffusion(*tens, dt=dt, dx=1.0, dy=1.0,
                                    ts=torch.tensor(ts, dtype=torch.float32),
                                    eps=EPS)
    (out * torch.from_numpy(g)).sum().backward()
    assert _max_err(out.detach(), ref_out) <= 1e-5
    for name, t, r in zip(["u"] + NAMES, tens, ref_grads):
        _close_rel(t.grad, r, f"grad {name}")
    # CPU tensors take the plain versions: no kernel launched
    assert (fused_grayscale_fwd_res.launches,
            fused_grayscale_bwd.launches) == launches


def test_fused_backward_matches_autograd_through_k6_plain():
    """The explicit backward (smooth3 adjoint, edge thirds, one-sided gate)
    against torch autograd through K6's plain forward, on fields that
    straddle eps (clamp_min's own gradient and the strict gate agree off
    the bound)."""
    fields, u, g, ts = _case(12, 3, 0.3, seed=11)
    kw = dict(dt=0.3, dx=1.0, dy=1.0, ts=torch.tensor(ts,
                                                      dtype=torch.float32),
              eps=EPS)

    def run(fn):
        tens = [torch.from_numpy(u).requires_grad_(True)] + [
            t.requires_grad_(True) for t in _tensors(fields)]
        out = fn(*tens, **kw)
        (out * torch.from_numpy(g)).sum().backward()
        return out.detach(), [t.grad for t in tens]

    out, grads = run(fused_grayscale_diffusion)
    ref_out, ref = run(fused_grayscale_diffusion_plain)
    assert _max_err(out, ref_out) <= 1e-6
    for name, p, r in zip(["u"] + NAMES, grads, ref):
        _close_rel(p, r, f"grad {name}")


def test_k6_refuses_gradients():
    fields, u, _, ts = _case(12, 2, 0.3)
    x = torch.from_numpy(u).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="fused_grayscale_vjp"):
        fused_grayscale_diffusion_fwd(
            x, *_tensors(fields), dt=0.3, dx=1.0, dy=1.0,
            ts=torch.tensor(ts, dtype=torch.float32))


def test_layer_argument_checks_and_block_budget():
    """What the kernels take: (B, H, W) float32 contiguous input, (H, W)
    fields, (S, 3) times, H and W up to MAX_N (1,440: the first scheme up
    to 64, the wide scheme past it); and each block's threads and shared
    memory, checked against the card's limits."""
    fields, u, _, ts = _case(12, 2, 0.3)
    f = _tensors(fields)
    tts = torch.tensor(ts, dtype=torch.float32)
    check_layer_args("k", torch.from_numpy(u), *f, tts)
    for bad, match in (
            ((torch.from_numpy(u)[:, None], *f, tts), "must be \\(B, H, W\\)"),
            ((torch.from_numpy(u), f[0][:5], *f[1:], tts), "alpha_base"),
            ((torch.from_numpy(u), *f, tts[:, :2]), "ts must be"),
            ((torch.from_numpy(u).double(), *f, tts), "float32"),
            ((torch.zeros(2, 1441, 8), *(torch.zeros(1441, 8),) * 4, tts),
             "H=1441 outside \\[1, 1440\\] \\(MAX_N")):
        with pytest.raises((ValueError, TypeError), match=match):
            check_layer_args("k", *bad)
    check_layer_args("k", torch.zeros(2, 65, 65),
                     *(torch.zeros(65, 65),) * 4, tts)
    # mnist's layer at B = 1024 on an H100's 132 SMs: 256 blocks of 4
    # images, two threads a line and image of 28 rows in groups of 8 lanes
    # a line (224 threads, 256 at least); a block's bytes: factor buffers of
    # two slots (a slot 28 lines of 29 floats: four buffers for K6/K7, two
    # for K8), two image buffers of (28, 29) floats an image for K6/K7, five
    # for K8 beside its (4, 28, 28) partials and (28, 28) fold
    slot = 28 * 29
    assert plan_grayscale(1024, 28, 28, 132) == (
        256, 4, 256, 4 * (4 * 2 * slot + 4 * 2 * slot), 3 * slot)
    assert plan_grayscale(1024, 28, 28, 132, backward=True) == (
        256, 4, 256, 4 * (2 * 2 * slot + 5 * 28 * 28 + 4 * 5 * slot),
        3 * slot)
    with pytest.raises(ValueError, match="shared memory"):
        plan_grayscale(7, 72, 72, 132, backward=True)
