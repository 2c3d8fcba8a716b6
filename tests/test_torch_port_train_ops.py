"""The port's trainable ops against the JAX package on the CPU, where every
wrapper runs its plain version: the tridiagonal adjoint (K3's plain
version), the sweeps' gradients, and the trainable fused channel layer
(K4 and K5's plain versions) against the TPU kernel B3 in interpret mode.

Tolerances: 1e-5 abs on solves and activations; 1e-4 relative with an atol
of 1e-6 on gradients (the sums run in another order); B3's own test bound,
rtol 2e-4 and atol 1e-6, against the interpret-mode kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_pde_tpu.ops import adi as jadi
from cnn_pde_tpu.ops import tridiag as jtridiag
from cnn_pde_tpu.ops.pallas_fused_channel_vjp import (
    fused_channel_diffusion as jax_fused)
from cnn_pde_tpu.ops.pallas_thomas import pallas_tridiag_solve
from cnn_pde_tpu.pde import MixedChannelDiffusion as JaxMixed
from cnn_pde_tpu.pde.diffusion import _substep_times
from cnn_pde_tpu_torch.ops import sweep_x, sweep_y, tridiag_solve
from cnn_pde_tpu_torch.ops.fused_channel import fused_channel_diffusion_plain
from cnn_pde_tpu_torch.ops.fused_channel_vjp import (
    fused_channel_bwd, fused_channel_diffusion, fused_channel_fwd_res)
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


def _close(port, ref, name, rtol=1e-4, atol=1e-6):
    np.testing.assert_allclose(np.asarray(port, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol, err_msg=name)


def _system(rng, n, batch=4, lines=6):
    a = -rng.random((lines, n)).astype(np.float32) * 0.5
    c = -rng.random((lines, n)).astype(np.float32) * 0.5
    b = (1.0 + np.abs(a) + np.abs(c)
         + rng.random((lines, n))).astype(np.float32)
    d = rng.random((batch, lines, n)).astype(np.float32)
    g = rng.standard_normal((batch, lines, n)).astype(np.float32)
    return a, b, c, d, g


def _port_grads(a, b, c, d, g, dim):
    ts = [torch.from_numpy(np.ascontiguousarray(t)).requires_grad_(True)
          for t in (a, b, c, d)]
    x = tridiag_solve(*ts, dim=dim)
    x.backward(torch.from_numpy(np.ascontiguousarray(g)))
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("n", [1, 2, 3, 32])
def test_tridiag_adjoint_matches_jax(n):
    """Grads of a, b, c and d against jax.grad through the JAX solve (PCR)
    and through the TPU kernel's custom VJP in interpret mode, along the
    last axis and down the columns (dim=-2, against the transposed
    problem), with batch-free bands."""
    rng = np.random.default_rng(100 + n)
    a, b, c, d, g = _system(rng, n)

    def loss(fn):
        return lambda *abcd: jnp.sum(fn(*abcd) * g)

    ref = jax.grad(loss(jtridiag.tridiag_solve), argnums=(0, 1, 2, 3))(
        a, b, c, d)
    pallas = jax.grad(loss(lambda *t: pallas_tridiag_solve(*t, True)),
                      argnums=(0, 1, 2, 3))(*map(jnp.asarray, (a, b, c, d)))
    port = _port_grads(a, b, c, d, g, -1)
    cols = _port_grads(*(np.swapaxes(t, -1, -2) for t in (a, b, c, d, g)),
                       -2)
    for name, p, col, r, pl in zip("abcd", port, cols, ref, pallas):
        assert p.shape == np.shape(r)
        _close(p, r, f"grad {name}, N={n}")
        _close(p, pl, f"grad {name} vs interpret kernel, N={n}")
        _close(np.swapaxes(col, -1, -2), r, f"grad {name}, dim=-2, N={n}")
    assert np.all(port[0][..., 0] == 0) and np.all(port[2][..., -1] == 0)


def test_tridiag_adjoint_gradcheck_float64():
    torch.manual_seed(0)
    for dim, shape in ((-1, (2, 3, 4)), (-2, (2, 4, 3))):
        a = -0.4 * torch.rand(shape, dtype=torch.float64)
        c = -0.4 * torch.rand(shape, dtype=torch.float64)
        b = 1.0 + a.abs() + c.abs() + torch.rand(shape, dtype=torch.float64)
        d = torch.rand((3, *shape), dtype=torch.float64)
        inputs = tuple(t.requires_grad_(True) for t in (a, b, c, d))
        assert torch.autograd.gradcheck(
            lambda *t: tridiag_solve(*t, dim=dim), inputs)


@pytest.mark.parametrize("shape", [(3, 32, 32), (2, 5, 1)])
def test_sweep_grads_match_jax(shape):
    """sweep_x and sweep_y gradients in u and the field (through the
    Neumann rows and eps) against jax.grad through ops/adi.py."""
    rng = np.random.default_rng(sum(shape))
    C, H, W = shape
    u = rng.random((3, C, H, W)).astype(np.float32)
    field = (0.2 + 2.0 * rng.random(shape)).astype(np.float32)
    gw = rng.standard_normal((3, C, H, W)).astype(np.float32)
    for port_fn, jax_fn, dt, dh in ((sweep_x, jadi.sweep_x, 0.0005, 1.0),
                                    (sweep_y, jadi.sweep_y, 0.002, 2.0)):
        ref = jax.grad(lambda v, f: jnp.sum(
            jax_fn(v, f, dt, dh, smooth=False, eps=1e-6) * gw),
            argnums=(0, 1))(u, field)
        tu, tf = (torch.from_numpy(t).requires_grad_(True)
                  for t in (u, field))
        (port_fn(tu, tf, dt, dh, eps=1e-6) * torch.from_numpy(gw)).sum() \
            .backward()
        _close(tu.grad, ref[0], f"{port_fn.__name__} grad u")
        _close(tf.grad, ref[1], f"{port_fn.__name__} grad field")


def _b3_case(splitting, C=3, H=8, steps=3, dt=0.01, cmax=2.0):
    """The JAX B3 test's case: a ragged batch of 5 and fields whose raw
    values straddle both clamp bounds."""
    rng = np.random.default_rng(7 if splitting == "strang" else 8)
    params = {
        "alpha_base": rng.uniform(-0.5, cmax + 0.5, (C, H, H)),
        "alpha_time_coeff": rng.standard_normal((C, H, H)) * 0.2,
        "beta_base": rng.uniform(-0.5, cmax + 0.5, (C, H, H)),
        "beta_time_coeff": rng.standard_normal((C, H, H)) * 0.2,
        "channel_mixing": np.eye(C) + 0.01 * rng.standard_normal((C, C)),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    u = rng.random((5, C, H, H)).astype(np.float32)
    gw = rng.random((5, C, H, H)).astype(np.float32)
    kw = dict(dt=dt, dx=1.0, dy=1.0, splitting=splitting, eps=1e-6,
              cmax=cmax,
              ts=torch.tensor(_substep_times_np(dt, steps),
                              dtype=torch.float32))
    return params, u, gw, kw, steps


@pytest.mark.parametrize("splitting", ["strang", "lie"])
def test_fused_channel_diffusion_matches_interpret_kernel(splitting):
    """Output and all six gradients of the port's trainable fused layer
    (plain forward with residuals, plain backward) against B3 run in
    interpret mode with tile 4."""
    params, u, gw, kw, steps = _b3_case(splitting)
    dt, cmax = kw["dt"], kw["cmax"]
    ts = tuple(map(tuple, np.asarray(_substep_times(dt, steps),
                                     np.float64).tolist()))

    def loss(u2, *p):
        out = jax_fused(u2, *p, dt, 1.0, 1.0, steps, ts, splitting, 1e-6,
                        cmax, 4, True)
        return jnp.sum(out * gw), out

    args = [jnp.asarray(u)] + [jnp.asarray(params[n]) for n in NAMES]
    (_, ref_out), ref = jax.value_and_grad(loss, argnums=tuple(range(6)),
                                           has_aux=True)(*args)
    tens = [torch.from_numpy(u).requires_grad_(True)] + [
        torch.from_numpy(params[n]).requires_grad_(True) for n in NAMES]
    out = fused_channel_diffusion(*tens, **kw)
    (out * torch.from_numpy(gw)).sum().backward()
    _close(out.detach(), ref_out, "output", rtol=0, atol=1e-5)
    for name, t, r in zip(["u"] + NAMES, tens, ref):
        _close(t.grad, r, f"grad {name}", rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("splitting", ["strang", "lie"])
def test_fused_backward_matches_autograd_through_k2_plain(splitting):
    """The explicit backward against autograd through K2's plain forward,
    with fields away from the clamp bounds (where the strict gate and
    clamp's own gradient agree); the residuals are the step inputs, and on
    CPU tensors no kernel launches."""
    params, u, gw, kw, steps = _b3_case(splitting)
    params["alpha_base"] = 1.0 + 0.1 * params["alpha_base"]
    params["beta_base"] = 1.0 + 0.1 * params["beta_base"]
    launches = (fused_channel_fwd_res.launches, fused_channel_bwd.launches)

    def run(fn):
        tens = [torch.from_numpy(u).requires_grad_(True)] + [
            torch.from_numpy(params[n]).requires_grad_(True) for n in NAMES]
        out = fn(*tens, **kw)
        (out * torch.from_numpy(gw)).sum().backward()
        return out.detach(), [t.grad for t in tens]

    out, grads = run(fused_channel_diffusion)
    ref_out, ref = run(fused_channel_diffusion_plain)
    _close(out, ref_out, "output", rtol=0, atol=1e-6)
    for name, g, r in zip(["u"] + NAMES, grads, ref):
        _close(g, r, f"grad {name}")
    assert (fused_channel_fwd_res.launches,
            fused_channel_bwd.launches) == launches
    _, res = fused_channel_fwd_res(
        torch.from_numpy(u), *(torch.from_numpy(params[n]) for n in NAMES),
        **kw)
    assert res.shape == (steps, *u.shape)
    assert torch.equal(res[0], torch.from_numpy(u))


def test_jax_layer_fused_flag_reaches_interpret_kernel():
    """The JAX layer with fused=True (in interpret mode) and the port's
    with fused=True compute the same layer on the same parameters."""
    from cnn_pde_tpu_torch.pde import MixedChannelDiffusion

    params, u, _, kw, steps = _b3_case("strang", H=8)
    layer = JaxMixed(8, channels=3, dt=kw["dt"], num_steps=steps,
                     clamp_max=kw["cmax"], fused=True, fused_train_tile_b=4)
    layer.fused_interpret = True
    ref, _ = layer.apply({k: jnp.asarray(v) for k, v in params.items()}, {},
                         jnp.asarray(u), None)
    port = MixedChannelDiffusion(8, 3, dt=kw["dt"], num_steps=steps,
                                 clamp_max=kw["cmax"], fused=True).train()
    port.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    out = port(torch.from_numpy(u))
    _close(out.detach(), ref, "fused layer output", rtol=0, atol=1e-5)
