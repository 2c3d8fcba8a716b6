"""The port's L1 ops (cnn_pde_tpu_torch.ops) against the JAX package and the
float64 numpy oracle, on the CPU, where every wrapper runs its plain version.

Tolerance: 1e-5 max abs on states in [0, 1), the bound the JAX package holds
its own solves and layers to; Thomas, PCR and the oracle solve one system
and differ only in rounding order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_pde_tpu.ops import adi as jadi
from cnn_pde_tpu.ops import tridiag as jtridiag
from cnn_pde_tpu.ops.pallas_fused_channel import fused_channel_diffusion_fwd
from cnn_pde_tpu.ops.pallas_thomas import pallas_tridiag_solve
from cnn_pde_tpu.pde.diffusion import _substep_times
from cnn_pde_tpu_torch.ops import (fused_channel_diffusion_fwd as
                                   port_fused_fwd,
                                   fused_channel_diffusion_plain, sweep_x,
                                   sweep_y, tridiag_solve, tridiag_solve_pcr)
from cnn_pde_tpu_torch.ops.adi import _neumann_b
from cnn_pde_tpu_torch.pde import MixedChannelDiffusion
from cnn_pde_tpu_torch.pde.diffusion import _substep_times_np
from tests.golden.reference_numpy import sweep_x_np, sweep_y_np, thomas_np


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six test
    files at once on one host, and eight threads each oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TOL = 1e-5


def _max_err(x, y):
    return float(np.max(np.abs(np.asarray(x, np.float64)
                                - np.asarray(y, np.float64))))


def _system(rng, lines, n, batch):
    """A diagonally dominant system: batch-free bands (lines, n), d batched."""
    a = -rng.random((lines, n)).astype(np.float32) * 0.5
    c = -rng.random((lines, n)).astype(np.float32) * 0.5
    b = (1.0 + np.abs(a) + np.abs(c)
         + rng.random((lines, n))).astype(np.float32)
    d = rng.random((batch, lines, n)).astype(np.float32)
    return a, b, c, d


@pytest.mark.parametrize("n", [1, 2, 3, 32])
def test_thomas_plain_matches_jax_and_oracle(n):
    rng = np.random.default_rng(n)
    a, b, c, d = _system(rng, 6, n, 4)
    x = tridiag_solve(*map(torch.from_numpy, (a, b, c, d))).numpy()
    assert x.shape == d.shape
    assert _max_err(x, jax.jit(jtridiag.tridiag_solve)(a, b, c, d)) <= TOL
    oracle = thomas_np(*(np.broadcast_to(t, d.shape).reshape(-1, n)
                         .astype(np.float64) for t in (a, b, c)),
                       d.reshape(-1, n).astype(np.float64), 0.0)
    assert _max_err(x, oracle.reshape(d.shape)) <= TOL
    pallas = pallas_tridiag_solve(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(c), jnp.asarray(d), True)
    assert _max_err(x, pallas) <= TOL


@pytest.mark.parametrize("n", [2, 32])
def test_pcr_and_column_solve_match_thomas(n):
    """PCR solves the same system as Thomas; a solve down dim -2 equals the
    transposed last-axis solve (the y-sweep's in-place layout)."""
    rng = np.random.default_rng(10 + n)
    a, b, c, d = map(torch.from_numpy, _system(rng, 5, n, 3))
    x = tridiag_solve(a, b, c, d)
    assert _max_err(tridiag_solve_pcr(a, b, c, d), x) <= TOL
    cols = tridiag_solve(*(t.transpose(-1, -2).contiguous()
                           for t in (a, b, c, d)), dim=-2)
    assert _max_err(cols.transpose(-1, -2), x) <= 1e-6


def test_solve_refuses_gradients():
    """K2's wrapper is the eval forward and refuses a gradient request,
    naming the trainable path; ``tridiag_solve`` is differentiable now."""
    rng = np.random.default_rng(0)
    a, b, c, d = map(torch.from_numpy, _system(rng, 2, 4, 1))
    a.requires_grad_(True)
    tridiag_solve(a, b, c, d).sum().backward()
    assert a.grad is not None and torch.all(a.grad[..., 0] == 0)
    C, S = 2, 4
    u = torch.rand((1, C, S, S))
    fields = [torch.ones((C, S, S), requires_grad=True)] + [
        torch.zeros((C, S, S))] * 3
    kw = dict(dt=0.01, dx=1.0, dy=1.0,
              ts=torch.tensor(_substep_times_np(0.01, 1),
                              dtype=torch.float32))
    with pytest.raises(NotImplementedError, match="fused_channel_vjp"):
        port_fused_fwd(u, *fields, torch.eye(C), **kw)
    with torch.no_grad():
        port_fused_fwd(u, *fields, torch.eye(C), **kw)


@pytest.mark.parametrize("shape", [(3, 32, 32), (2, 5, 1), (1, 3, 2)])
def test_sweeps_match_jax_and_oracle(shape):
    """x- and y-sweeps on (B, C, H, W) with a batch-free (C, H, W) field,
    including the width-1 Neumann row and the 2-wide edge case."""
    rng = np.random.default_rng(sum(shape))
    C, H, W = shape
    u = rng.random((3, C, H, W)).astype(np.float32)
    field = (0.2 + 2.0 * rng.random(shape)).astype(np.float32)
    eps = 1e-6
    for port_fn, jax_fn, np_fn, dt, dh in (
            (sweep_x, jadi.sweep_x, sweep_x_np, 0.0005, 1.0),
            (sweep_y, jadi.sweep_y, sweep_y_np, 0.002, 2.0)):
        out = port_fn(torch.from_numpy(u), torch.from_numpy(field), dt, dh,
                      eps=eps).numpy()
        ref = jax.jit(lambda v, f: jax_fn(v, f, dt, dh, smooth=False,
                                          eps=eps))(u, field)
        assert _max_err(out, ref) <= TOL
        oracle = np.stack([np_fn(u[:, k].astype(np.float64),
                                 field[k].astype(np.float64), dt, dh, False,
                                 eps) for k in range(C)], 1)
        assert _max_err(out, oracle) <= TOL


def test_neumann_b_edge_rows():
    r = torch.arange(1.0, 5.0).reshape(1, 4)
    assert _neumann_b(r).tolist() == [[2.0, 5.0, 7.0, 5.0]]
    assert _neumann_b(r.T, dim=-2).T.tolist() == [[2.0, 5.0, 7.0, 5.0]]
    assert _neumann_b(torch.tensor([[3.0]])).tolist() == [[4.0]]


def test_substep_times_match_jax():
    for dt, steps in ((0.001, 5), (0.002, 8), (0.005, 4)):
        ts = torch.tensor(_substep_times_np(dt, steps), dtype=torch.float32)
        np.testing.assert_array_equal(ts.numpy(),
                                      np.asarray(_substep_times(dt, steps)))


@pytest.mark.parametrize("splitting,steps", [("strang", 5), ("lie", 4)])
def test_fused_channel_plain_matches_pallas_interpret(splitting, steps):
    """K2's plain version against the TPU kernel run in interpret mode, on a
    ragged batch (B = 5, tile 4, 16×16); it also equals the port's per-sweep
    layer, and on CPU tensors the wrapper launches nothing."""
    rng = np.random.default_rng(steps)
    C, S = 3, 16
    u = rng.random((5, C, S, S)).astype(np.float32)
    fields = [(1.0 + 0.3 * rng.standard_normal((C, S, S))).astype(np.float32),
              (rng.standard_normal((C, S, S)) * 0.1).astype(np.float32),
              (1.0 + 0.3 * rng.standard_normal((C, S, S))).astype(np.float32),
              (rng.standard_normal((C, S, S)) * 0.1).astype(np.float32)]
    mixing = (np.eye(C) + 0.01 * rng.standard_normal((C, C))).astype(
        np.float32)
    dt = 0.002
    ref = fused_channel_diffusion_fwd(
        jnp.asarray(u), *map(jnp.asarray, fields), jnp.asarray(mixing),
        dt=dt, dx=1.0, dy=1.0, num_steps=steps,
        ts=np.asarray(_substep_times(dt, steps)), splitting=splitting,
        tile_b=4, interpret=True)
    ts = torch.tensor(_substep_times_np(dt, steps), dtype=torch.float32)
    args = [torch.from_numpy(t) for t in (u, *fields, mixing)]
    kw = dict(dt=dt, dx=1.0, dy=1.0, ts=ts, splitting=splitting)
    plain = fused_channel_diffusion_plain(*args, **kw).numpy()
    assert _max_err(plain, ref) <= TOL

    before = port_fused_fwd.launches
    assert _max_err(port_fused_fwd(*args, **kw), plain) == 0.0
    assert port_fused_fwd.launches == before

    layer = MixedChannelDiffusion(S, C, dt=dt, num_steps=steps,
                                  splitting=splitting)
    with torch.no_grad():
        for p, v in zip((layer.alpha_base, layer.alpha_time_coeff,
                         layer.beta_base, layer.beta_time_coeff,
                         layer.channel_mixing), args[1:]):
            p.copy_(v)
        assert _max_err(layer(args[0]), plain) <= TOL
