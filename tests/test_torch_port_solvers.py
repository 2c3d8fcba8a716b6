"""The port's tridiagonal solver impls (``ops/tridiag.py``:
``set_default_impl`` and ``tridiag_solve(impl=)``) against the JAX
package's on the CPU: all seven names, each solve and its band gradients
along either axis of the bands against JAX's ``tridiag_solve`` under the
same ``set_default_impl``, and 'pcr2' (``tridiag_solve_pcr_fused``)
against JAX's at line lengths with an odd and an even count of levels.

JAX solves along the last axis only: a y-sweep (``dim=-2``) is held
against JAX's solve of the transposed system.  JAX's 'pallas' runs its
Pallas kernel in interpret mode, as the JAX package's own tests run it on
the CPU; its 'matinv_bf16' product (bf16 × bf16 → float32, no CPU kernel)
runs with both operands rounded to bf16 and multiplied in float32, the
same product.  The port's 'auto' and 'pallas' are K1 and K3 (their plain
versions here), JAX's 'auto' is its PCR: the same system.

Tolerances: 5e-6 of the largest entry on solves and on the a, b, c, d
gradients (the JAX tests' bar, ``test_torch_port_amp.py``); 'matinv_bf16'
4e-3 and 6e-3 (the bf16 grade's); 'pcr2' against JAX's 'pcr2' rtol 1e-5 /
atol 2e-6 (JAX's ``tests/test_tridiag.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cnn_pde_tpu.ops.pallas_thomas as jax_pallas
import cnn_pde_tpu.ops.tridiag as jax_tridiag
from cnn_pde_tpu_torch.ops import tridiag

IMPLS = ("scan", "pcr", "pcr2", "matinv", "matinv_bf16", "pallas", "auto")
BARS = {"matinv_bf16": (4e-3, 6e-3)}


def _rel(x, y):
    """max |x − y| over the largest |y|."""
    x, y = (np.asarray(t, np.float64) for t in (x, y))
    return float(np.max(np.abs(x - y)) / max(np.max(np.abs(y)), 1e-30))


@pytest.fixture
def jax_on_the_cpu(monkeypatch):
    """Both packages' global default restored after the test; JAX's Pallas
    kernel in interpret mode and its bf16 product emulated."""
    monkeypatch.setattr(jax_pallas, "_solve",
                        functools.partial(jax_pallas._solve, interpret=True))
    apply = jax_tridiag._inv_apply_einsum

    def emulated(X, d, transpose):
        if X.dtype == jnp.bfloat16:
            X = X.astype(jnp.float32)
            d = d.astype(jnp.bfloat16).astype(jnp.float32)
        return apply(X, d, transpose)

    monkeypatch.setattr(jax_tridiag, "_inv_apply_einsum", emulated)
    jax_prev = jax_tridiag.set_default_impl("auto")
    prev = tridiag.set_default_impl("auto")
    try:
        yield
    finally:
        jax_tridiag.set_default_impl(jax_prev)
        tridiag.set_default_impl(prev)


def _system(rng, rows, n, batch):
    """Batch-free, diagonally dominant bands (rows, n) and d (batch, rows,
    n), float32."""
    a = (rng.standard_normal((rows, n)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((rows, n)) * 0.3).astype(np.float32)
    b = (2.0 + np.abs(a) + np.abs(c)).astype(np.float32)
    d = rng.standard_normal((batch, rows, n)).astype(np.float32)
    return a, b, c, d


def _jax_solve_and_grads(a, b, c, d, w):
    """JAX's tridiag_solve along the last axis under its current default:
    x and the a, b, c, d gradients of Σ w·x."""
    def loss(*args):
        x = jax_tridiag.tridiag_solve(*args)
        return jnp.sum(w * x), x

    (_, x), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                       has_aux=True)(a, b, c, d)
    return np.asarray(x), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("impl", IMPLS)
def test_impl_matches_jax_on_either_axis(impl, jax_on_the_cpu):
    """``set_default_impl(impl)`` and the per-call ``impl=``: the solve and
    the gradients of all four inputs, x-sweep and y-sweep layouts (bands
    (6, 12) lines along the last axis, or along the first down the
    columns), against JAX's solve under the same default."""
    out_bar, grad_bar = BARS.get(impl, (5e-6, 5e-6))
    rng = np.random.default_rng(IMPLS.index(impl))
    a, b, c, d = _system(rng, 6, 12, 4)
    w = rng.standard_normal(d.shape).astype(np.float32)
    assert jax_tridiag.set_default_impl(impl) == "auto"
    x_ref, g_ref = _jax_solve_and_grads(a, b, c, d, w)
    for dim in (-1, -2):
        flip = (lambda t: np.ascontiguousarray(np.swapaxes(t, -1, -2))) \
            if dim == -2 else (lambda t: t)
        for per_call in (False, True):
            if not per_call:
                assert tridiag.set_default_impl(impl) in ("auto", impl)
            args = [torch.tensor(flip(t), requires_grad=True)
                    for t in (a, b, c, d)]
            x = tridiag.tridiag_solve(*args, dim=dim,
                                      impl=impl if per_call else None)
            (x * torch.from_numpy(flip(w))).sum().backward()
            assert x.dtype == torch.float32 and x.shape == args[3].shape
            assert _rel(flip(x.detach().numpy()), x_ref) <= out_bar
            for t, ref in zip(args, g_ref):
                assert _rel(flip(t.grad.numpy()), ref) <= grad_bar
            tridiag.set_default_impl("auto")


@pytest.mark.parametrize("n", [1, 2, 7, 32, 33])
def test_pcr2_matches_jax_with_batch_free_bands(n):
    """``tridiag_solve_pcr_fused`` against JAX's on batch-free bands (n,)
    and (4, n) with d (6, 4, n): 1 and 2 have one level, 7 three (a pair
    and a single), 32 five, 33 six; and against the expanded bands."""
    rng = np.random.default_rng(n)
    a, b, c, d = _system(rng, 4, n, 6)
    for bands in ((a, b, c), (a[0], b[0], c[0])):
        ref = np.asarray(jax_tridiag.tridiag_solve_pcr_fused(*bands, d))
        got = tridiag.tridiag_solve_pcr_fused(
            *(torch.from_numpy(np.ascontiguousarray(t))
              for t in (*bands, d))).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-6)
        full = tridiag.tridiag_solve_pcr_fused(
            *(torch.from_numpy(np.broadcast_to(t, d.shape).copy())
              for t in bands), torch.from_numpy(d)).numpy()
        np.testing.assert_allclose(got, full, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            got, tridiag.tridiag_solve_plain(
                *map(torch.from_numpy, (*bands, d))).numpy(),
            rtol=1e-5, atol=2e-6)
