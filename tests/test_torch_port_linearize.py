"""Linearized serving in the port (cnn_pde_tpu_torch/pde/linearize.py and
serve.linearize_pde_layers) against the JAX package's on the CPU.

The same numpy weights and inputs go through both.  Tolerances: each
layer is linear in u (rtol 1e-4, atol 1e-5, the JAX test's); a composed
matrix against JAX's within 1e-5 of its largest entry (the same basis
evolved by two float32 implementations); a linearized output against the
sequential one at rtol 1e-4, atol 1e-5 (float32 reassociation over D-term
sums, the JAX test's); bf16 storage at rtol and atol 2e-2 and int8 (W8A8)
at 2e-2 of the largest entry (the JAX tests' grades); int8 ``q`` equal to
JAX's except at exact .5 ties (both round half to even), its scale within
1e-7 relative and the int8 apply on identical ``(q, scale)`` within 1e-6
of the largest entry.  The grade selection and emotion's classifier are
in ``test_torch_port_linearize_grades.py``.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_pde_tpu.models import CIFAR10PDENoConv as JaxFlagship
from cnn_pde_tpu.nn.core import Ctx
from cnn_pde_tpu.pde import ChannelCoupledDiffusion as JaxCoupled
from cnn_pde_tpu.pde import FourierFTCSLayer as JaxFTCS
from cnn_pde_tpu.pde import GrayscaleDiffusion as JaxGray
from cnn_pde_tpu.pde import MixedChannelDiffusion as JaxMixed
from cnn_pde_tpu.pde import ResidualDiffusion as JaxResidual
from cnn_pde_tpu.pde.linearize import QuantizedMatrix as JaxQuantized
from cnn_pde_tpu.pde.linearize import _apply_mat as jax_apply_mat
from cnn_pde_tpu.pde.linearize import quantize_int8 as jax_quantize_int8
from cnn_pde_tpu.serve import cache_hoisted_operators as jax_cache_operators
from cnn_pde_tpu.serve import linearize_pde_layers as jax_linearize
from cnn_pde_tpu.serve import make_predict_fn as jax_predict_fn
from cnn_pde_tpu_torch.compat import state_dict_from_jax
from cnn_pde_tpu_torch.models import build_model
from cnn_pde_tpu_torch.pde import (ChannelCoupledDiffusion, FourierFTCSLayer,
                                   GrayscaleDiffusion, MixedChannelDiffusion,
                                   ResidualDiffusion)
from cnn_pde_tpu_torch.pde.linearize import (QuantizedMatrix, _apply_mat,
                                             capture_linearized,
                                             quantize_int8)
from cnn_pde_tpu_torch.serve import (cache_hoisted_operators,
                                     clear_linear_cache,
                                     clear_operator_cache,
                                     linearize_pde_layers, make_predict_fn)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """This file's tests on two intra-op threads, the default restored
    after.  Tier-1 runs six test processes at once on the machine's cores,
    and torch's default of one thread a core in each makes their threads
    wait on one another (a ResNet-18 step measured 18x slower in six
    processes at once than at two threads each)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


# (name, JAX layer, port layer, input shape): the JAX tests' seven layers
LAYERS = [
    ("grayscale", lambda: JaxGray(size=8, num_steps=3),
     lambda: GrayscaleDiffusion(size=8, num_steps=3), (1, 8, 8)),
    ("coupled", lambda: JaxCoupled(size=8, num_steps=3),
     lambda: ChannelCoupledDiffusion(size=8, num_steps=3), (3, 8, 8)),
    ("mixed_strang", lambda: JaxMixed(size=8, num_steps=3),
     lambda: MixedChannelDiffusion(size=8, num_steps=3), (3, 8, 8)),
    ("mixed_lie", lambda: JaxMixed(size=8, num_steps=3, splitting="lie"),
     lambda: MixedChannelDiffusion(size=8, num_steps=3, splitting="lie"),
     (3, 8, 8)),
    ("ftcs", lambda: JaxFTCS(Nx=8, Ny=8),
     lambda: FourierFTCSLayer(Nx=8, Ny=8), (1, 8, 8)),
    ("residual", lambda: JaxResidual(size=8),
     lambda: ResidualDiffusion(size=8), (3, 8, 8)),
    ("residual_implicit", lambda: JaxResidual(size=8, use_implicit=True),
     lambda: ResidualDiffusion(size=8, use_implicit=True), (3, 8, 8)),
]
PARAMS = [pytest.param(*t, id=t[0]) for t in LAYERS]


def _rel(port, ref):
    """max |port − ref| over the largest |ref|."""
    ref = np.asarray(ref, np.float64)
    port = np.asarray(torch.as_tensor(port).detach(), np.float64)
    return float(np.max(np.abs(port - ref)) / np.max(np.abs(ref)))


def _pair(make_jax, make_port, seed=0):
    """A JAX layer and the port layer with the same weights: the JAX init
    moved by seeded noise (time coefficients away from 0)."""
    rng = np.random.default_rng(seed)
    layer = make_jax()
    params, state = layer.init(jax.random.PRNGKey(seed))
    params = {k: (np.asarray(v) * (1 + 0.1 * rng.standard_normal(np.shape(v)))
                  + 0.01 * rng.standard_normal(np.shape(v))).astype(
                      np.float32) for k, v in params.items()}
    port = make_port()
    missing, unexpected = port.load_state_dict(
        {k: torch.tensor(v) for k, v in params.items()}, strict=False)
    assert not unexpected and set(missing) <= {"x", "y"}
    return layer, params, state, port.eval()


def _jax_out(layer, params, state, x):
    return np.asarray(layer.apply(params, state, jnp.asarray(x),
                                  Ctx(train=False))[0])


def _port_out(port, x):
    with torch.no_grad():
        return port(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("name,make_jax,make_port,shape", PARAMS)
def test_port_layers_are_linear_in_u(name, make_jax, make_port, shape):
    _, _, _, port = _pair(make_jax, make_port)
    rng = np.random.default_rng(1)
    u1, u2 = (rng.standard_normal((2,) + shape).astype(np.float32)
              for _ in range(2))
    a, b = 1.7, -0.6
    lhs = _port_out(port, (a * u1 + b * u2).astype(np.float32))
    rhs = a * _port_out(port, u1) + b * _port_out(port, u2)
    np.testing.assert_allclose(lhs, rhs, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name,make_jax,make_port,shape", PARAMS)
def test_linearized_layer_matches_jax_and_sequential(name, make_jax,
                                                     make_port, shape):
    layer, params, state, port = _pair(make_jax, make_port)
    x = np.random.default_rng(2).standard_normal((3,) + shape).astype(
        np.float32)
    ref = _port_out(port, x)
    np.testing.assert_allclose(ref, _jax_out(layer, params, state, x),
                               rtol=1e-4, atol=1e-5)
    assert jax_linearize(layer, params, state, jnp.asarray(x)) == 1
    assert linearize_pde_layers(port, x) == 1
    D = int(np.prod(shape))
    assert tuple(port.linear_cache.shape) == (D, D)
    assert port.linear_cache.dtype == torch.float32
    assert _rel(port.linear_cache, layer.linear_cache) <= 1e-5
    out = _port_out(port, x)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out, _jax_out(layer, params, state, x),
                               rtol=1e-4, atol=1e-5)
    assert clear_linear_cache(port) == 1 and port.linear_cache is None


def test_bf16_storage_matches_sequential_and_jax():
    layer, params, state, port = _pair(LAYERS[2][1], LAYERS[2][2])
    x = np.random.default_rng(3).standard_normal((3, 3, 8, 8)).astype(
        np.float32)
    ref = _port_out(port, x)
    assert linearize_pde_layers(port, x, dtype=torch.bfloat16) == 1
    jax_linearize(layer, params, state, jnp.asarray(x), dtype=jnp.bfloat16)
    assert port.linear_cache.dtype == torch.bfloat16
    out = _port_out(port, x)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(out, _jax_out(layer, params, state, x),
                               rtol=2e-2, atol=2e-2)


def test_int8_quantization_matches_jax():
    """q equal to JAX's on the same float32 matrix except at exact .5
    ties, the scales within 1e-7, the apply on identical (q, scale) within
    1e-6, and the layer's int8 output within 2e-2 of the sequential's."""
    _, _, _, port = _pair(LAYERS[2][1], LAYERS[2][2])
    x = np.random.default_rng(4).standard_normal((5, 3, 8, 8)).astype(
        np.float32)
    ref = _port_out(port, x)
    linearize_pde_layers(port, x)
    m = port.linear_cache.numpy()
    clear_linear_cache(port)

    ours, theirs = quantize_int8(torch.from_numpy(m)), jax_quantize_int8(m)
    assert isinstance(ours, QuantizedMatrix)
    assert ours.q.dtype == torch.int8 and ours.q.shape == m.shape
    assert ours.q.stride() == (1, m.shape[0])  # column-major
    np.testing.assert_allclose(ours.scale.numpy(), np.asarray(theirs.scale),
                               rtol=1e-7, atol=0)
    scaled = m / np.asarray(theirs.scale)[None, :]
    ties = np.abs(np.abs(scaled - np.trunc(scaled)) - 0.5) < 1e-6
    differ = ours.q.numpy() != np.asarray(theirs.q)
    assert not (differ & ~ties).any()
    # dequantized entries within half a step of the float32 matrix
    deq = ours.q.numpy().astype(np.float32) * ours.scale.numpy()[None, :]
    assert (np.abs(deq - m) <= 0.5 * ours.scale.numpy()[None, :]
            + 1e-12).all()

    same = JaxQuantized(theirs.q, theirs.scale)
    port_apply = _apply_mat(torch.from_numpy(x), QuantizedMatrix(
        torch.from_numpy(np.array(theirs.q)),
        torch.from_numpy(np.array(theirs.scale)))).numpy()
    jax_apply = np.asarray(jax_apply_mat(jnp.asarray(x), same, None))
    assert _rel(port_apply, jax_apply) <= 1e-6

    assert linearize_pde_layers(port, x, dtype="int8") == 1
    assert isinstance(port.linear_cache, QuantizedMatrix)
    out = _port_out(port, x)
    assert out.dtype == np.float32 and _rel(out, ref) <= 2e-2


def _flagship_pdes(port):
    return [getattr(port.feature_extractor, f"pde{i}") for i in (1, 2, 3)]


def _pin(port, mats):
    """Pin the flagship's three matrices as ``linearize_pde_layers`` does."""
    for layer, mat in zip(_flagship_pdes(port), mats):
        layer.linear_cache = mat


@pytest.fixture(scope="module")
def flagship():
    """The JAX flagship (time coefficients moved off 0) and the port with
    its weights, a batch of 3, the port's probs on it before linearizing,
    and its three (3072, 3072) matrices, built once (each is the identity
    basis through a layer's 17 or 26 sweeps on the CPU's plain versions)
    and shared by the tests below."""
    rng = np.random.default_rng(5)
    model = JaxFlagship()
    params, state = jax.tree_util.tree_map(
        np.asarray, jax.jit(model.init)(jax.random.PRNGKey(1)))
    for i in (1, 2, 3):
        pde = params["feature_extractor"][f"pde{i}"]
        for k in ("alpha_time_coeff", "beta_time_coeff"):
            pde[k] = (5.0 * rng.standard_normal(pde[k].shape)).astype(
                np.float32)
    port = build_model("cifar10_noconv", device="cpu")
    port.load_state_dict(state_dict_from_jax(params, state), strict=True)
    x = rng.random((3, 3, 32, 32)).astype(np.float32)
    ref = make_predict_fn(port, output="probs")(x).numpy()
    assert linearize_pde_layers(port, x) == 3
    mats = [layer.linear_cache for layer in _flagship_pdes(port)]
    assert clear_linear_cache(port) == 3
    return model, params, state, port, x, ref, mats


def test_flagship_linearized_predict_matches_jax(flagship):
    model, params, state, port, x, ref, mats = flagship
    assert jax_linearize(model, params, state, jnp.asarray(x)) == 3
    _pin(port, mats)
    try:
        jax_mats = [model.extractor.pdes[i].linear_cache for i in range(3)]
        port_mats = [getattr(port.feature_extractor, f"pde{i}").linear_cache
                     for i in (1, 2, 3)]
        for ours, theirs in zip(port_mats, jax_mats):
            assert _rel(ours, theirs) <= 1e-5
        out = make_predict_fn(port, output="probs")(x).numpy()
        jax_out = np.asarray(jax_predict_fn(model, params, state,
                                            output="probs")(x))
        np.testing.assert_allclose(out, jax_out, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    finally:
        from cnn_pde_tpu.serve import clear_linear_cache as jax_clear
        jax_clear(model)
        clear_linear_cache(port)


def test_train_mode_refusal_max_dim_gate_and_clear(flagship):
    _, _, _, port, x, _, mats = flagship
    ref = make_predict_fn(port)(x)
    _pin(port, mats)  # linearize_pde_layers' 3 layers (the fixture's)
    port.train()
    with pytest.raises(ValueError, match="linear_cache"):
        port(torch.from_numpy(x))
    port.eval()
    assert clear_linear_cache(port) == 3
    assert clear_linear_cache(port) == 0
    assert torch.equal(make_predict_fn(port)(x), ref)
    # D = 3072 > max_dim: every layer stays sequential, bit for bit
    assert linearize_pde_layers(port, x, max_dim=3071) == 0
    assert all(getattr(port.feature_extractor, f"pde{i}").linear_cache
               is None for i in (1, 2, 3))
    assert torch.equal(make_predict_fn(port)(x), ref)
    # the capture lists what it skipped
    with capture_linearized(max_dim=100) as cap, torch.no_grad():
        port(torch.from_numpy(x[:1]))
    assert not cap.items and [d for _, d in cap.skipped] == [3072] * 3


def test_linearize_composes_with_hoisted_operator_cache():
    """linearize after cache_hoisted_operators: the matrix bakes in the
    cached (float32) operators, as JAX's does."""
    layer, params, state, port = _pair(LAYERS[2][1], LAYERS[2][2])
    layer.hoisted = True
    port.hoisted = True
    x = np.random.default_rng(6).standard_normal((2, 3, 8, 8)).astype(
        np.float32)
    ref = _port_out(port, x)
    assert cache_hoisted_operators(port) == 1
    assert jax_cache_operators(layer, params, state, jnp.asarray(x)) == 1
    assert linearize_pde_layers(port, x) == 1
    assert jax_linearize(layer, params, state, jnp.asarray(x)) == 1
    assert _rel(port.linear_cache, layer.linear_cache) <= 1e-5
    np.testing.assert_allclose(_port_out(port, x), ref, rtol=1e-4,
                               atol=1e-5)
    assert clear_linear_cache(port) == 1 and clear_operator_cache(port) == 1
