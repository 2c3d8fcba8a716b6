"""The plain mirrors of K1's and K3's phases (csrc/thomas.cu) on the CPU:
PCR's batch-free factorisation and per-image apply, for the system and its
transpose, and K3's band sums per chunk of images with their fixed-order sum
over chunks, against the port's Thomas recurrence, the JAX package's PCR,
the TPU kernel in interpret mode and ``jax.vjp`` of the JAX solve; and the
launch plan that sizes the kernels' chunks, at line lengths up to MAX_N
(the long-line scheme's layout past 64 rows:
tests/test_torch_port_long_lines.py holds its arithmetic), and the check
that the kernel's tiling is the plan's at every N.

Line lengths N ∈ {1, 2, 3, 5, 28, 32, 33, 64} (one row a lane, two past 32),
along the last axis of bands (3, 5, N) and down the columns of (3, N, 7):
ragged against the kernels' tiles of 8 lines; 7 images in chunks of 3, and
20 in chunks of 2 (ten chunks: more than the partial sum's eight slices).

Tolerances: 1e-5 abs on solves (Thomas and PCR solve one system and differ
in rounding order); 1e-4 of the largest entry on band gradients (sums over
the batch taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_pde_tpu.ops import tridiag as jtridiag
from cnn_pde_tpu.ops.pallas_thomas import pallas_tridiag_solve
from cnn_pde_tpu_torch.ops import tridiag
from cnn_pde_tpu_torch.ops.tridiag import (
    BLOCKS_PER_SM, BUFFERS, LINES, LONG_BUFFERS, LONG_STAGE, MAX_N, SHORT_N,
    SMEM_LIMIT, STAGE, _adjoint_band_grads, _adjoint_band_partials, _plan,
    _sum_band_partials, _transpose_system, launch_layout, pcr_apply,
    pcr_factor, tridiag_solve_plain)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six test
    files at once on one host, and eight threads each oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


NS = [1, 2, 3, 5, 28, 32, 33, 64]
DIMS = [-1, -2]
BATCH, CHUNK = 7, 3
TOL = 1e-5
GRAD_TOL = 1e-4


def _system(n, dim, batch=BATCH):
    """Diagonally dominant batch-free bands of shape (3, 5, n) (dim -1) or
    (3, n, 7) (dim -2), a batched right-hand side and a cotangent."""
    rng = np.random.default_rng(1000 * n + (7 if dim == -2 else 5))
    shape = (3, 5, n) if dim == -1 else (3, n, 7)
    a = -0.5 * rng.random(shape)
    c = -0.5 * rng.random(shape)
    b = 1.0 + np.abs(a) + np.abs(c) + rng.random(shape)
    d = rng.random((batch, *shape))
    g = rng.standard_normal((batch, *shape))
    return [torch.from_numpy(t.astype(np.float32)) for t in (a, b, c, d, g)]


def _last(t, dim):
    """The JAX package solves along the last axis: ``t`` with ``dim``
    there, as numpy."""
    return np.ascontiguousarray(t.movedim(dim, -1).numpy())


def _max_err(x, y):
    return float(np.max(np.abs(np.asarray(x, np.float64)
                               - np.asarray(y, np.float64))))


def _rel_err(x, y):
    y = np.asarray(y, np.float64)
    return float(np.max(np.abs(np.asarray(x, np.float64) - y))
                 / max(np.max(np.abs(y)), 1e-30))


_jax_pcr = jax.jit(jtridiag.tridiag_solve_pcr)
_jax_pallas = jax.jit(lambda a, b, c, d: pallas_tridiag_solve(a, b, c, d,
                                                              True))
_jax_band_grads = jax.jit(
    lambda a, b, c, d, g: jax.vjp(jtridiag.tridiag_solve, a, b, c, d)[1](g))


def _check_pcr(a, b, c, d, dim, jax_bands):
    x = pcr_apply(pcr_factor(a, b, c, dim), d, dim)
    assert x.shape == d.shape
    assert _max_err(x, tridiag_solve_plain(a, b, c, d, dim)) <= TOL
    x_last = _last(x, dim)
    jd = jnp.asarray(_last(d, dim))
    assert _max_err(x_last, _jax_pcr(*jax_bands, jd)) <= TOL
    assert _max_err(x_last, _jax_pallas(*jax_bands, jd)) <= TOL


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("n", NS)
def test_pcr_phases_solve_the_system(n, dim):
    """pcr_apply(pcr_factor(...)) against the Thomas recurrence, the JAX
    PCR and the TPU kernel in interpret mode."""
    a, b, c, d, _ = _system(n, dim)
    jax_bands = [jnp.asarray(_last(t, dim)) for t in (a, b, c)]
    _check_pcr(a, b, c, d, dim, jax_bands)


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("n", NS)
def test_pcr_phases_solve_the_transposed_system(n, dim):
    """The same phases on Tᵀ (sub'[i] = c[i-1], super'[i] = a[i+1]), the
    system K3 solves, against the same three references on the JAX
    package's own transposed bands."""
    a, b, c, _, g = _system(n, dim)
    jax_bands = jtridiag._transpose_system(
        *(jnp.asarray(_last(t, dim)) for t in (a, b, c)))
    _check_pcr(*_transpose_system(a, b, c, dim), g, dim, jax_bands)


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("n", NS)
def test_chunked_band_partials_sum_to_the_band_gradients(n, dim):
    """K3's band sums per chunk of 3 of 7 images (of 2 of 20 at N = 28),
    summed over chunks in the kernel's fixed order, against the unchunked
    plain version and against jax.vjp of the JAX solve with batch-free
    bands."""
    batch, chunk = (20, 2) if n == 28 else (BATCH, CHUNK)
    a, b, c, d, g = _system(n, dim, batch)
    x = tridiag_solve_plain(a, b, c, d, dim)
    lam = pcr_apply(pcr_factor(*_transpose_system(a, b, c, dim), dim), g, dim)
    partials = _adjoint_band_partials(lam, x, dim, chunk)
    assert partials.shape == (-(-batch // chunk), 3, *a.shape)
    grads = _sum_band_partials(partials)
    plain = _adjoint_band_grads(a, b, c, x, lam, dim)
    ref = _jax_band_grads(*(jnp.asarray(_last(t, dim))
                            for t in (a, b, c, d, g)))
    for name, got, p, r in zip("abc", grads, plain, ref):
        assert got.shape == a.shape
        assert _rel_err(got, p) <= GRAD_TOL, name
        assert _rel_err(_last(got, dim), r) <= GRAD_TOL, name
    assert np.all(grads[0].movedim(dim, -1)[..., 0].numpy() == 0)
    assert np.all(grads[2].movedim(dim, -1)[..., -1].numpy() == 0)


@pytest.mark.parametrize("batch,p,n,q", [
    (64, 96, 32, 1), (512, 96, 32, 1), (64, 3, 32, 32), (512, 3, 32, 32),
    (128, 28, 28, 1), (1024, 28, 28, 1), (128, 1, 28, 28), (1024, 1, 28, 28),
    (1, 15, 5, 1), (7, 3, 64, 7), (100_000, 96, 64, 1),
    # past 64 rows: the 96 x 96 flagship's sweeps, 256 and 1024 wide
    # images, and the longest line
    (64, 288, 96, 1), (512, 288, 96, 1), (64, 3, 96, 96), (512, 3, 96, 96),
    (64, 768, 256, 1), (64, 3, 256, 256), (8, 1024, 1024, 1),
    (8, 1, 1024, 1024), (7, 3, MAX_N, 7)])
def test_launch_plan_covers_the_batch_and_fills_the_card(batch, p, n, q):
    """Chunks cover every image once, the grid of the layout's tiles has at
    least BLOCKS_PER_SM blocks an SM of an H100 (132) wherever the batch
    allows it, and both kernels' shared memory stays inside the budget at
    any N up to MAX_N."""
    sms = 132
    for arrays in (1, 2):
        lines = launch_layout(n, arrays)[0]
        tiles = -(-p // lines) if q == 1 else p * -(-q // lines)
        chunk, chunks, smem = _plan(batch, p, n, q, sms, arrays)
        assert chunk * (chunks - 1) < batch <= chunk * chunks
        assert tiles * chunks >= min(BLOCKS_PER_SM * sms, tiles * batch)
        assert chunks <= 65535 and smem <= SMEM_LIMIT
        assert smem == launch_layout(n, arrays)[3]
    assert _plan(batch, p, MAX_N, q, sms, 2)[2] <= SMEM_LIMIT


def test_layout_is_the_short_tiling_to_64_rows_and_fits_past_it():
    """Up to 64 rows both kernels keep the tiling (LINES, STAGE, BUFFERS)
    and its ring of (LINES + 1)·N floats an image; past 64 the long-line
    scheme's lines a block halve from 8 as N grows (never back up), each
    the most that fits SMEM_LIMIT, K3 (two rings, the band sums) never
    more lines than K1."""
    for n in range(1, MAX_N + 1):
        k1, k3 = launch_layout(n, 1), launch_layout(n, 2)
        if n <= SHORT_N:
            assert k1 == (LINES, STAGE, BUFFERS,
                          4 * BUFFERS * STAGE * (LINES + 1) * n)
            assert k3 == (LINES, STAGE, BUFFERS, 2 * k1[3])
            continue
        for arrays, (lines, stage, buffers, smem) in ((1, k1), (2, k3)):
            assert (stage, buffers) == (LONG_STAGE, LONG_BUFFERS)
            assert smem == tridiag._long_bytes(n, lines, arrays)
            assert smem <= SMEM_LIMIT
            assert lines == 8 or tridiag._long_bytes(
                n, 2 * lines, arrays) > SMEM_LIMIT
            if n > SHORT_N + 1:
                assert lines <= launch_layout(n - 1, arrays)[0]
        assert k3[0] <= k1[0]


def _fake_thomas_layout(monkeypatch, report):
    """Stand in for csrc/thomas.cu's thomas_layout(n, adjoint, ...) with
    ``report(n, arrays)``: a (lines, stage, buffers, bytes) tuple, or None
    for a refused N."""
    def function(name, symbol, argtypes):
        assert name == "thomas"
        if symbol != "thomas_layout":
            return symbol

        def layout_fn(n, adjoint, *ptrs):
            got = report(n, adjoint + 1)
            if got is None:
                return 1
            for p, v in zip(ptrs, got):
                p._obj.value = v
            return 0
        return layout_fn

    monkeypatch.setattr(tridiag.kernels, "function", function)
    monkeypatch.setattr(tridiag, "_layout_checked", False)


def _report(n, arrays):
    return launch_layout(n, arrays) if n <= MAX_N else None


@pytest.mark.parametrize("layout,ok", [((LINES, STAGE, BUFFERS), True),
                                       ((LINES, STAGE, BUFFERS + 1), False),
                                       ((2 * LINES, STAGE, BUFFERS), False)])
def test_bind_checks_the_kernel_tiling(monkeypatch, layout, ok):
    """The wrapper binds K1 and K3 only if csrc/thomas.cu reports the tiling
    (lines, stage, buffers) that ``_plan`` sizes launches with, here up to
    64 rows."""
    _fake_thomas_layout(monkeypatch, lambda n, arrays: (
        (*layout, launch_layout(n, arrays)[3]) if n <= SHORT_N
        else _report(n, arrays)))
    if ok:
        assert tridiag._bind("thomas_solve", None) == "thomas_solve"
        assert tridiag._layout_checked
    else:
        with pytest.raises(RuntimeError, match="tiles"):
            tridiag._bind("thomas_solve", None)
        assert not tridiag._layout_checked


@pytest.mark.parametrize("fault", ["lines at 1024", "bytes at 96",
                                   "admits MAX_N + 1", "refuses MAX_N"])
def test_bind_checks_the_tiling_at_every_line_length(monkeypatch, fault):
    """Past 64 rows too: a report that differs from ``launch_layout`` at
    one N and one kernel (lines a block, shared-memory bytes), or a kernel
    that takes MAX_N + 1 rows or refuses MAX_N, stops the bind."""
    def report(n, arrays):
        got = _report(n, arrays)
        if fault == "lines at 1024" and n == 1024 and arrays == 2:
            return (2 * got[0], *got[1:])
        if fault == "bytes at 96" and n == 96 and arrays == 1:
            return (*got[:3], got[3] + 4)
        if fault == "admits MAX_N + 1" and n == MAX_N + 1:
            return (1, LONG_STAGE, LONG_BUFFERS, SMEM_LIMIT)
        if fault == "refuses MAX_N" and n == MAX_N:
            return None
        return got
    _fake_thomas_layout(monkeypatch, report)
    with pytest.raises(RuntimeError, match="tiles"):
        tridiag._bind("thomas_adjoint", None)
    assert not tridiag._layout_checked
