"""Lines longer than 64 rows on the CPU: the port's plain solve and adjoint
against the JAX package's solvers, the partitioned scheme K1 and K3 run
past 64 rows (csrc/thomas.cu::long_lines_kernel) through its plain
mirror, the launch plan at every line length the kernels take, and the
layers at the image sizes the JAX package takes: a 96 × 96
``MixedChannelDiffusion`` and the flagship with its extractor at STL-10's
96 × 96 × 3.

Tolerances: 1e-5 abs on solves and λ (the same system by other
elimination orders); 1e-4 of the largest entry on band and parameter
gradients (sums over the batch and the pixels in another order); 1e-5 on
layer activations and 1e-4 on logits, the JAX package's bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_pde_tpu.models import CIFAR10PDENoConv as JaxModel
from cnn_pde_tpu.models.cifar10_noconv import \
    MultiScaleExtractor as JaxExtractor
from cnn_pde_tpu.nn import Ctx
from cnn_pde_tpu.ops import tridiag as jtridiag
from cnn_pde_tpu.ops.pallas_thomas import pallas_tridiag_solve
from cnn_pde_tpu.pde import MixedChannelDiffusion as JaxMixed
from cnn_pde_tpu_torch.compat import state_dict_from_jax
from cnn_pde_tpu_torch.models import build_model
from cnn_pde_tpu_torch.models.cifar10_noconv import MultiScaleExtractor
from cnn_pde_tpu_torch.ops import tridiag
from cnn_pde_tpu_torch.ops.tridiag import (
    MAX_N, SHORT_N, SMEM_LIMIT, _line_shape, _plan, _transpose_system,
    launch_layout, partition_apply, partition_factor, rows_a_lane,
    tridiag_adjoint_plain, tridiag_solve_plain)
from cnn_pde_tpu_torch.pde import MixedChannelDiffusion


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six test
    files at once on one host, and eight threads each oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TOL = 1e-5
GRAD_TOL = 1e-4
BATCH = 4


def _max_err(x, y):
    return float(np.max(np.abs(np.asarray(x, np.float64)
                               - np.asarray(y, np.float64))))


def _rel_err(x, y):
    y = np.asarray(y, np.float64)
    return float(np.max(np.abs(np.asarray(x, np.float64) - y))
                 / max(np.max(np.abs(y)), 1e-30))


def _system(n, dim, batch=BATCH):
    """Diagonally dominant batch-free bands (3, 5, n) (dim -1) or (3, n, 5)
    (dim -2: the same lines down the columns, so one JAX compile serves
    both axes), a right-hand side and a cotangent of ``batch`` images."""
    rng = np.random.default_rng(1000 * n + (7 if dim == -2 else 5))
    shape = (3, 5, n) if dim == -1 else (3, n, 5)
    a = -0.5 * rng.random(shape)
    c = -0.5 * rng.random(shape)
    b = 1.0 + np.abs(a) + np.abs(c) + rng.random(shape)
    d = rng.random((batch, *shape))
    g = rng.standard_normal((batch, *shape))
    return [torch.from_numpy(t.astype(np.float32)) for t in (a, b, c, d, g)]


def _last(t, dim):
    return np.ascontiguousarray(t.movedim(dim, -1).numpy())


@jax.jit
def _jax_solves(a, b, c, d, g):
    """The JAX PCR solve of T and of Tᵀ, the TPU kernel's solve in
    interpret mode and its custom VJP (band gradients, λ) at cotangent g."""
    x, vjp = jax.vjp(lambda *t: pallas_tridiag_solve(*t, True), a, b, c, d)
    return (jtridiag.tridiag_solve_pcr(a, b, c, d), x,
            jtridiag.tridiag_solve_pcr(*jtridiag._transpose_system(a, b, c),
                                       g), vjp(g))


@pytest.mark.parametrize("n", [65, 96, 128, 257, 1024])
def test_plain_versions_match_jax_solvers(n):
    """K1's and K3's plain versions against the JAX PCR solve and the TPU
    kernel in interpret mode (its custom VJP for λ and the band
    gradients), along the last axis and down the columns."""
    for dim in (-1, -2):
        a, b, c, d, g = _system(n, dim)
        jbands = [jnp.asarray(_last(t, dim)) for t in (a, b, c)]
        jd, jg = jnp.asarray(_last(d, dim)), jnp.asarray(_last(g, dim))
        pcr, pallas, pcr_t, (ga, gb, gc, gd) = _jax_solves(*jbands, jd, jg)
        x = tridiag_solve_plain(a, b, c, d, dim)
        assert _max_err(_last(x, dim), pcr) <= TOL
        assert _max_err(_last(x, dim), pallas) <= TOL
        lam, *grads = tridiag_adjoint_plain(a, b, c, g, x, dim)
        assert _max_err(_last(lam, dim), pcr_t) <= TOL
        assert _max_err(_last(lam, dim), gd) <= TOL
        for name, got, ref in zip("abc", grads, (ga, gb, gc)):
            assert got.shape == a.shape
            assert _rel_err(_last(got, dim), ref) <= GRAD_TOL, name


@pytest.mark.parametrize("n", [65, 96, 127, 129, 257, 961, 1024, MAX_N])
def test_partition_phases_solve_the_system_and_its_transpose(n):
    """``partition_apply(partition_factor(...))``, the arithmetic of K1's
    and K3's scheme past 64 rows, against the Thomas plain version on T
    and on Tᵀ (the system K3 solves), on both axes: ragged partitions (65,
    127, 129, 257), whole ones (96, 1024), 31 rows a lane taken as 32
    (961) and the longest line (MAX_N)."""
    for dim in (-1, -2):
        a, b, c, d, g = _system(n, dim, batch=2)
        f = partition_factor(a, b, c, dim)
        assert f["f"].shape[-2:] == (32, rows_a_lane(n))
        x = partition_apply(f, d, dim)
        assert x.shape == d.shape
        assert _max_err(x, tridiag_solve_plain(a, b, c, d, dim)) <= TOL
        t = _transpose_system(a, b, c, dim)
        lam = partition_apply(partition_factor(*t, dim), g, dim)
        assert _max_err(lam, tridiag_solve_plain(*t, g, dim)) <= TOL


def test_rows_a_lane_cover_the_line_and_avoid_a_bank_stride():
    """m·32 covers the line with fewer than 32 rows to spare (64 at 961-992,
    where 31 rows a lane, a stride of 32 words once padded, is taken as
    32), and the padded rows of a warp's 32 lanes at every step fall at
    most three to a bank."""
    for n in range(SHORT_N + 1, MAX_N + 1):
        m = rows_a_lane(n)
        assert 32 * m >= n and m >= 3 and m != 31
        assert 32 * m - n < (64 if 961 <= n <= 992 else 32)
    for m in {rows_a_lane(n) for n in range(SHORT_N + 1, MAX_N + 1)}:
        for j in range(m):
            rows = [k * m + j for k in range(32)]
            banks = np.bincount([(i + (i >> 5)) % 32 for i in rows])
            assert banks.max() <= 3, (m, j)


def test_every_line_length_has_a_launch_inside_the_budget():
    """For K1 and K3 at every N in [1, MAX_N]: lines a block a power of two
    (8 up to 64 rows), shared memory inside SMEM_LIMIT, and a plan that
    covers the batch on the flagship's x- and y-sweep tilings; MAX_N is the
    longest line that fits: MAX_N + 1 rows of K3's one-line block do
    not."""
    for n in range(1, MAX_N + 1):
        for arrays in (1, 2):
            lines, stage, buffers, smem = launch_layout(n, arrays)
            assert lines in (1, 2, 4, 8) and smem <= SMEM_LIMIT
            assert (lines, stage, buffers) == ((8, 8, 3) if n <= SHORT_N
                                               else (lines, 4, 2))
            for p, q in ((3 * n, 1), (3, n)):
                chunk, chunks, _ = _plan(7, p, n, q, 132, arrays)
                assert chunk * (chunks - 1) < 7 <= chunk * chunks
    assert tridiag._long_bytes(MAX_N + 1, 1, 2) > SMEM_LIMIT
    with pytest.raises(ValueError, match="outside"):
        launch_layout(MAX_N + 1)


def test_line_shape_admits_up_to_max_n():
    """The wrapper's shape check admits every line up to MAX_N on both
    axes and refuses MAX_N + 1 with a message that names the limit."""
    for n in (65, 1024, MAX_N, MAX_N + 1):
        for shape, dim in (((2, 3, n), -1), ((2, n, 3), -2)):
            band = torch.zeros(shape)
            d = torch.zeros((1, *shape))
            if n <= MAX_N:
                assert _line_shape("k", band, band, band, d, dim)[2] == n
            else:
                with pytest.raises(ValueError,
                                   match=rf"line length {n} outside \[1, "
                                         rf"{MAX_N}\]"):
                    _line_shape("k", band, band, band, d, dim)


def _layer_params(rng, C=3, S=96):
    return {k: v.astype(np.float32) for k, v in {
        "alpha_base": 1.0 + 0.5 * rng.standard_normal((C, S, S)),
        "beta_base": 1.0 + 0.5 * rng.standard_normal((C, S, S)),
        "alpha_time_coeff": 5.0 * rng.standard_normal((C, S, S)),
        "beta_time_coeff": 5.0 * rng.standard_normal((C, S, S)),
        "channel_mixing": np.eye(C) + 0.05 * rng.standard_normal((C, C)),
    }.items()}


def test_mixed_channel_diffusion_at_96_matches_jax():
    """MixedChannelDiffusion(size=96, num_steps=2) on the flagship's second
    branch scale: the forward and every parameter's gradient against the
    JAX layer (jax.grad), weights carried as numpy."""
    rng = np.random.default_rng(96)
    params = _layer_params(rng)
    u = rng.random((2, 3, 96, 96)).astype(np.float32)
    g = rng.standard_normal((2, 3, 96, 96)).astype(np.float32)
    kw = dict(dt=0.002, dx=2.0, dy=2.0, num_steps=2, splitting="strang")
    layer = JaxMixed(96, 3, **kw)

    def forward_and_grads(p):
        return layer(p, {}, u)[0], jax.grad(
            lambda q: jnp.sum(layer(q, {}, u)[0] * g))(p)
    ref, grads = jax.jit(forward_and_grads)(params)
    port = MixedChannelDiffusion(96, 3, **kw).train()
    port.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    out = port(torch.from_numpy(u))
    assert out.shape == (2, 3, 96, 96)
    assert _max_err(out.detach(), ref) <= TOL
    (out * torch.from_numpy(g)).sum().backward()
    for name, p in port.named_parameters():
        assert _rel_err(p.grad, grads[name]) <= GRAD_TOL, name


def test_flagship_with_a_96_extractor_matches_jax():
    """The flagship with its extractor replaced by MultiScaleExtractor(96,
    3) in both packages (the 4 × 4 adaptive pools make the head size-free),
    every parameter randomised, weights carried by
    ``compat.state_dict_from_jax``: eval logits at B = 2 within 1e-4."""
    rng = np.random.default_rng(7)
    jmodel = JaxModel()
    jmodel.extractor = JaxExtractor(96, 3)
    params, state = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    for i in (1, 2, 3):
        params["feature_extractor"][f"pde{i}"] = _layer_params(rng)
    for tree in (params, state):
        for key in ("feature_bn", "classifier"):
            tree[key] = jax.tree_util.tree_map(
                lambda x: (x + 0.1 * rng.standard_normal(x.shape)).astype(
                    x.dtype), tree[key])
    x = rng.random((2, 3, 96, 96)).astype(np.float32)
    ref, _ = jax.jit(lambda p, s, v: jmodel.apply(p, s, v, Ctx(train=False))
                     )(params, state, x)
    model = build_model("cifar10_noconv", device="cpu")
    model.feature_extractor = MultiScaleExtractor(96, 3, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    with torch.inference_mode():
        logits = model.eval()(torch.from_numpy(x)).numpy()
    assert logits.shape == (2, 10)
    assert _max_err(logits, ref) <= 1e-4
