"""The port's MixedChannelDiffusion and CIFAR-10 flagship against the JAX
package on the CPU, in both eval configurations: per-sweep (every sweep one
Thomas solve; K1 on the card) and ``fused_inference`` (one whole-layer call
per branch; K2 on the card).  On the CPU both run their plain versions.

Tolerances: 1e-5 max abs on layer activations (against the JAX layer and the
float64 oracle), 1e-4 on full-model logits — the bounds the JAX package holds
itself to.
"""

import jax
import numpy as np
import pytest
import torch

from cnn_pde_tpu.compat.torch_import import export_state_dict
from cnn_pde_tpu.models import CIFAR10PDENoConv as JaxModel
from cnn_pde_tpu.nn import Ctx
from cnn_pde_tpu.pde import MixedChannelDiffusion as JaxMixed
from cnn_pde_tpu_torch.compat import state_dict_from_jax
from cnn_pde_tpu_torch.models import (NOT_YET_PORTED, CIFAR10HybridPDEModel,
                                      build_model)
from cnn_pde_tpu_torch.models.cifar10_noconv import MultiScaleExtractor
from cnn_pde_tpu_torch.pde import MixedChannelDiffusion
from tests.golden.reference_numpy import mixed_forward_np


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six test
    files at once on one host, and eight threads each oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SCALES = MultiScaleExtractor.SCALES
CONFIGS = ["per_sweep", "fused_inference"]


def _max_err(x, y):
    return float(np.max(np.abs(np.asarray(x, np.float64)
                                - np.asarray(y, np.float64))))


def _layer_params(rng, C=3, S=32):
    return {
        "alpha_base": (1.0 + 0.5 * rng.standard_normal((C, S, S))),
        "beta_base": (1.0 + 0.5 * rng.standard_normal((C, S, S))),
        "alpha_time_coeff": 5.0 * rng.standard_normal((C, S, S)),
        "beta_time_coeff": 5.0 * rng.standard_normal((C, S, S)),
        "channel_mixing": np.eye(C) + 0.05 * rng.standard_normal((C, C)),
    }


@pytest.fixture(scope="module")
def layer_case():
    """Inputs, params and the JAX and oracle outputs for each flagship
    branch scale, made once for both configurations."""
    rng = np.random.default_rng(0)
    u = rng.random((2, 3, 32, 32)).astype(np.float32)
    cases = []
    for scale in SCALES:
        params = {k: v.astype(np.float32)
                  for k, v in _layer_params(rng).items()}
        layer = JaxMixed(32, 3, splitting="strang", **scale)
        ref, _ = jax.jit(lambda p, x: layer(p, {}, x))(params, u)
        oracle = mixed_forward_np(u, params, scale["dt"], scale["dx"],
                                  scale["dy"], scale["num_steps"], "strang")
        cases.append((params, np.asarray(ref), oracle))
    return u, cases


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("branch", [0, 1, 2])
def test_mixed_channel_diffusion_matches_jax(layer_case, branch, config):
    u, cases = layer_case
    params, ref, oracle = cases[branch]
    layer = MixedChannelDiffusion(
        32, 3, splitting="strang",
        fused_inference=config == "fused_inference", **SCALES[branch]).eval()
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    with torch.inference_mode():
        out = layer(torch.from_numpy(u)).numpy()
    assert _max_err(out, ref) <= 1e-5
    assert _max_err(out, oracle) <= 1e-5


def test_unported_options_raise():
    # remat is ported: the layer builds and recomputes its steps
    # in the backward with the same arithmetic
    layer = MixedChannelDiffusion(size=8, num_steps=2, remat=True)
    x = torch.rand(2, 3, 8, 8, requires_grad=True)
    layer(x).sum().backward()
    assert layer.remat and torch.isfinite(x.grad).all()
    # the hybrid (A11) is ported: every model family of the JAX package
    # builds, and none is left to port
    assert NOT_YET_PORTED == {}
    assert isinstance(build_model("cifar10_hybrid", device="cpu"),
                      CIFAR10HybridPDEModel)


@pytest.fixture(scope="module")
def flagship():
    """The JAX flagship with every parameter and BN statistic randomised
    (so a wrong key, transpose or leaf shows), and its eval logits."""
    rng = np.random.default_rng(1)
    model = JaxModel()
    params, state = jax.tree_util.tree_map(
        np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0)))
    fe = params["feature_extractor"]
    for i in (1, 2, 3):
        fe[f"pde{i}"] = {k: v.astype(np.float32)
                         for k, v in _layer_params(rng).items()}
    for tree in (params, state):
        def perturb(x):
            return (x + 0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        for key in ("feature_bn", "classifier"):
            tree[key] = jax.tree_util.tree_map(perturb, tree[key])
    x = rng.random((3, 3, 32, 32)).astype(np.float32)
    logits, _ = jax.jit(lambda p, s, v: model.apply(p, s, v, Ctx(train=False))
                        )(params, state, x)
    return params, state, x, np.asarray(logits)


def test_state_dict_from_jax_equals_export(flagship):
    params, state, _, _ = flagship
    sd = state_dict_from_jax(params, state)
    ref = export_state_dict(params, state, "cifar10_noconv")
    assert list(sd) == list(ref)
    for k, v in ref.items():
        assert sd[k].numpy().dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    model = build_model("cifar10_noconv", device="cpu")
    model.load_state_dict(sd, strict=True)
    assert set(model.state_dict()) == set(sd)


@pytest.mark.parametrize("config", CONFIGS)
def test_flagship_logits_match_jax(flagship, config):
    params, state, x, ref = flagship
    model = build_model("cifar10_noconv", device="cpu",
                        fused_inference=config == "fused_inference")
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    with torch.inference_mode():
        logits = model(torch.from_numpy(x)).numpy()
    assert logits.shape == (3, 10)
    assert _max_err(logits, ref) <= 1e-4


def test_build_model_init_is_seeded():
    """The init draws come from the explicit generator: same seed, same
    weights; the JAX model's distributions (unit PDE bases, zero time
    coefficients, zero Linear biases in the head)."""
    a = build_model("cifar10_noconv", device="cpu",
                    generator=torch.Generator().manual_seed(3)).state_dict()
    b = build_model("cifar10_noconv", device="cpu",
                    generator=torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.all(a["feature_extractor.pde2.alpha_base"] == 1.0)
    assert torch.all(a["feature_extractor.pde2.beta_time_coeff"] == 0.0)
    assert torch.all(a["classifier.network.4.bias"] == 0.0)
    w = a["classifier.network.0.weight"]
    assert abs(float(w.std()) - (2.0 / 96) ** 0.5) < 0.01


def test_build_model_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model("cifar10_noconv")
    assert build_model("cifar10_noconv", device="cpu").classifier \
        .network[0].weight.device.type == "cpu"
