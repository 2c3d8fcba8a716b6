"""The emotion family in the port against the JAX package on the CPU: the
frozen-ring FTCS evolution (``ops/stencil.py::ftcs_evolve``), the Fourier
FTCS layer and its six weights' gradients, the classifier's weights (the
reference's ``pde.x`` / ``pde.y`` grids included), eval logits, one
train-mode forward and backward and one train step, the preset, the
synthetic data and both CLIs with ``--preset emotion``.

The layer is CFL-unstable at its own init (β·dt/dy² ≈ 1.6), so values grow
about 1e6× over its 10 steps, and every bound is relative to the largest
entry.  Tolerances: a few FTCS steps 1e-5 of the largest entry; the
10-step evolution 1e-4 of it against JAX and, against the float64 oracle
``fourier_ftcs_forward_np``, rtol 5e-4 (the JAX test's own bound); the six
weights' gradients 1e-4 relative; logits, the loss and every gradient of a
train-mode step 1e-4 of their largest entry (the preset has no clip).
"""

import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_pde_tpu.compat.torch_import import export_state_dict
from cnn_pde_tpu.data.synthetic import make_synthetic as jax_make_synthetic
from cnn_pde_tpu.models import EmotionClassifier as JaxEmotion
from cnn_pde_tpu.nn import Ctx
from cnn_pde_tpu.ops.stencil import ftcs_evolve as jax_ftcs_evolve
from cnn_pde_tpu.pde import FourierFTCSLayer as JaxFTCS
from cnn_pde_tpu.train.losses import cross_entropy as jax_cross_entropy
from cnn_pde_tpu.utils.config import get_preset as jax_preset
import cnn_pde_tpu_torch.data as port_data
from cnn_pde_tpu_torch.compat import state_dict_from_jax
from cnn_pde_tpu_torch.data.synthetic import make_synthetic
from cnn_pde_tpu_torch.models import build_model
from cnn_pde_tpu_torch.ops.stencil import ftcs_evolve
from cnn_pde_tpu_torch.pde import FourierFTCSLayer
from cnn_pde_tpu_torch.presets import PRESETS, SYNTHETIC_SPECS
from cnn_pde_tpu_torch.serve_cli import main as serve_main
from cnn_pde_tpu_torch.train import cross_entropy, make_train_step
from cnn_pde_tpu_torch.train.__main__ import main as train_main
from cnn_pde_tpu_torch.train.step import make_schedule
from tests.golden.reference_numpy import fourier_ftcs_forward_np

WEIGHTS = ("alpha_w1", "alpha_w2", "alpha_w3", "beta_w1", "beta_w2",
           "beta_w3")


def _rel(port, ref):
    """max |port − ref| over the largest |ref|."""
    ref = np.asarray(ref, np.float64)
    port = np.asarray(torch.as_tensor(port).detach(), np.float64)
    return float(np.max(np.abs(port - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("shape", [(48, 48), (12, 20)])
@pytest.mark.parametrize("nt", [1, 2, 3])
def test_ftcs_evolve_steps_match_jax(shape, nt):
    """A few steps of the frozen-ring evolution at the layer's init
    coefficients (β·dt/dy² ≈ 1.6), square and not."""
    rng = np.random.default_rng(0)
    u = rng.random((2, *shape)).astype(np.float32)
    alpha = (0.5 + 0.4 * rng.random(shape)).astype(np.float32)
    beta = (1.6 + 0.4 * rng.random(shape)).astype(np.float32)
    ref = np.asarray(jax_ftcs_evolve(jnp.asarray(u), alpha, beta, nt))
    out = ftcs_evolve(*map(torch.from_numpy, (u, alpha, beta)), nt)
    assert out.shape == u.shape
    assert _rel(out, ref) <= 1e-5


def test_ftcs_ring_is_frozen():
    """The ring is the input's reflection at every step: a state whose
    interior changes while the ring does not.  One step from a constant
    field stays constant; a second evolution of the first's output is not
    the two-step evolution (the ring was re-made from the new state)."""
    u = torch.full((1, 6, 7), 0.5)
    ones = torch.ones(6, 7)
    assert torch.equal(ftcs_evolve(u, 0.2 * ones, 0.1 * ones, 3), u)
    v = torch.rand(1, 6, 7, generator=torch.Generator().manual_seed(0))
    two = ftcs_evolve(v, 0.2 * ones, 0.1 * ones, 2)
    again = ftcs_evolve(ftcs_evolve(v, 0.2 * ones, 0.1 * ones, 1),
                        0.2 * ones, 0.1 * ones, 1)
    assert not torch.allclose(two, again)


def _jax_layer_params(layer):
    params, _ = layer.init(jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in params.items()}


def test_ftcs_layer_one_step_matches_jax_and_the_oracle():
    rng = np.random.default_rng(1)
    u = rng.random((2, 1, 48, 48)).astype(np.float32)
    jax_layer = JaxFTCS(Nx=48, Ny=48, T=0.001, dt=0.001)
    params = _jax_layer_params(jax_layer)
    ref, _ = jax_layer.apply(params, {}, jnp.asarray(u), Ctx(train=False))
    layer = FourierFTCSLayer(48, 48, T=0.001, dt=0.001)
    assert layer.Nt == jax_layer.Nt == 1
    with torch.no_grad():
        out = layer(torch.from_numpy(u))
    assert _rel(out, ref) <= 1e-5
    golden = fourier_ftcs_forward_np(u, params, 48, 48, 1.0, 1.0, 0.001,
                                     0.001)
    assert _rel(out, golden) <= 1e-5


def test_ftcs_layer_evolution_matches_jax_and_the_oracle():
    """The 10-step evolution at init: 1e-4 of the largest entry against
    JAX, and the float64 oracle at the JAX test's own bound on the JAX
    test's own input (tests/test_pde_layers.py, the first draw of seed 0).
    The bound is element by element: an element that cancels to about 1
    among values of 1e7 carries float32's rounding of its neighbours, and
    on other draws the JAX layer itself misses 5e-4 there (seed 2: 2.4e-3
    on one element of 4608)."""
    rng = np.random.default_rng(0)
    u = rng.random((2, 1, 48, 48)).astype(np.float32)
    jax_layer = JaxFTCS(Nx=48, Ny=48)
    params = _jax_layer_params(jax_layer)
    ref, _ = jax_layer.apply(params, {}, jnp.asarray(u), Ctx(train=False))
    layer = FourierFTCSLayer()
    assert layer.Nt == jax_layer.Nt == 10
    with torch.no_grad():
        out = layer(torch.from_numpy(u)).numpy()
    assert np.abs(out).max() > 1e5  # the instability is there
    assert _rel(out, ref) <= 1e-4
    golden = fourier_ftcs_forward_np(u, params, 48, 48, 1.0, 1.0, 0.01,
                                     0.001)
    np.testing.assert_allclose(out, golden, rtol=5e-4, atol=1e-5)
    # the grids are the reference's torch.linspace buffers
    np.testing.assert_allclose(layer.x.numpy(), np.asarray(jax_layer.x_grid),
                               rtol=0, atol=1e-7)


def test_ftcs_layer_weight_grads_match_jax():
    """The gradients of ⟨y, r⟩ in the six weights, moved off their init,
    within 1e-4 relative."""
    rng = np.random.default_rng(3)
    u = rng.random((2, 1, 48, 48)).astype(np.float32)
    r = rng.standard_normal((2, 1, 48, 48)).astype(np.float32)
    params = {k: np.float32(v + 0.02 * rng.standard_normal())
              for k, v in _jax_layer_params(JaxFTCS()).items()}
    jax_layer = JaxFTCS()

    def loss(p):
        y, _ = jax_layer.apply(p, {}, jnp.asarray(u), Ctx(train=True))
        return jnp.sum(y * r)

    grads = jax.grad(loss)({k: jnp.asarray(v) for k, v in params.items()})
    layer = FourierFTCSLayer()
    layer.load_state_dict({**{k: torch.tensor(v) for k, v in params.items()},
                           "x": layer.x, "y": layer.y})
    (layer(torch.from_numpy(u)) * torch.from_numpy(r)).sum().backward()
    for name in WEIGHTS:
        g = float(grads[name])
        got = getattr(layer, name).grad.item()
        assert abs(got - g) <= 1e-4 * abs(g), (name, got, g)


@pytest.fixture(scope="module")
def jax_emotion():
    """The JAX emotion classifier, its six weights and every head
    parameter and BN statistic moved off their init."""
    rng = np.random.default_rng(4)
    model = JaxEmotion(dropout_rate=0.0)
    params, state = jax.tree_util.tree_map(
        np.asarray, jax.jit(model.init)(jax.random.PRNGKey(5)))
    params["diff"] = {k: np.float32(v + 0.02 * rng.standard_normal())
                      for k, v in params["diff"].items()}

    def perturb(x):
        return (x + 0.05 * rng.standard_normal(x.shape)).astype(x.dtype)
    params["head"] = jax.tree_util.tree_map(perturb, params["head"])
    state["head"] = jax.tree_util.tree_map(
        lambda v: np.abs(perturb(v)).astype(v.dtype), state["head"])
    return model, params, state


def _port(params, state, **kwargs):
    port = build_model("emotion", device="cpu", **kwargs)
    port.load_state_dict(state_dict_from_jax(params, state, "emotion"),
                         strict=True)
    return port


def test_state_dict_from_jax_adds_the_grids(jax_emotion):
    _, params, state = jax_emotion
    sd = state_dict_from_jax(params, state, "emotion")
    ref = export_state_dict(params, state, "emotion")
    assert set(sd) == set(ref) | {"pde.x", "pde.y"}
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    model = build_model("emotion", device="cpu")
    assert set(model.state_dict()) == set(sd)
    for key in ("pde.x", "pde.y"):
        assert torch.equal(sd[key], torch.linspace(0.0, 1.0, 48))


def test_emotion_logits_match_jax(jax_emotion):
    model, params, state = jax_emotion
    x = np.random.default_rng(6).random((4, 1, 48, 48)).astype(np.float32)
    ref, _ = jax.jit(lambda p, s, v: model.apply(p, s, v, Ctx(train=False))
                     )(params, state, x)
    with torch.inference_mode():
        logits = _port(params, state)(torch.from_numpy(x)).numpy()
    assert logits.shape == (4, 7)
    assert _rel(logits, ref) <= 1e-4


def _train_batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.random((8, 1, 48, 48)).astype(np.float32),
            rng.integers(0, 7, 8).astype(np.int32))


def test_emotion_train_grads_match_jax(jax_emotion):
    """The loss and every gradient of one train-mode forward and backward
    (dropout 0, no label smoothing, as the preset) against
    jax.value_and_grad, 1e-4 of each one's largest entry; the biases that
    feed a train-mode BatchNorm are zero in exact arithmetic and are held
    at 1e-4 of the largest gradient of their layer's weight instead."""
    model, params, state = jax_emotion
    x, y = _train_batch(7)

    def loss_fn(p, s):
        logits, ns = model.apply(p, s, x, Ctx(train=True,
                                              rng=jax.random.PRNGKey(0)))
        return jax_cross_entropy(logits, y, 0.0), ns

    (loss, _), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, state)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads), {},
                              "emotion")
    port = _port(params, state, dropout_rate=0.0).train()
    out = cross_entropy(port(torch.from_numpy(x)), torch.from_numpy(y), 0.0)
    out.backward()
    assert abs(out.item() - float(loss)) <= 1e-4 * abs(float(loss))
    zero = {f"classifier.{i}.bias" for i in (1, 5, 9)}
    for name, p in port.named_parameters():
        if name in zero:
            scale = ref[name.replace("bias", "weight")].abs().max().item()
            assert max(p.grad.abs().max().item(),
                       ref[name].abs().max().item()) <= 1e-4 * scale, name
        else:
            assert _rel(p.grad, ref[name].numpy()) <= 1e-4, name


def test_emotion_train_step_matches_jax(jax_emotion):
    """One make_train_step step (preset values, augmentation off, dropout
    0): its loss is the JAX loss of the batch; with no clip, each
    parameter moves by at most Adam's first step at the cosine's first
    learning rate (1e-3) plus its weight decay, up to float32 rounding."""
    model, params, state = jax_emotion
    x, y = _train_batch(8)
    ref, _ = jax.jit(lambda p, s: model.apply(
        p, s, x, Ctx(train=True, rng=jax.random.PRNGKey(0))))(params, state)
    ref_loss = float(jax_cross_entropy(ref, y, 0.0))
    port = _port(params, state, dropout_rate=0.0)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    values = dict(PRESETS["emotion"]["train"], augment=None)
    assert values["clip_norm"] is None
    step = make_train_step(port, values, 2, torch.Generator())
    assert step.schedule(0) == pytest.approx(1e-3)
    loss, _ = step(x, y)
    assert abs(loss.item() - ref_loss) <= 1e-4 * abs(ref_loss)
    lr, wd = 1e-3, values["weight_decay"]
    for name, p in port.named_parameters():
        moved = (p.detach() - before[name]).abs()
        assert bool((moved <= lr * (1 + wd * before[name].abs())
                     + 2.4e-7 * before[name].abs()).all()), name
        assert moved.max() > 0, name


def test_emotion_preset_matches_jax():
    ref = jax_preset("emotion")
    train = PRESETS["emotion"]["train"]
    for key in ("epochs", "batch_size", "lr", "weight_decay", "schedule",
                "schedule_kwargs", "label_smoothing", "clip_norm",
                "default_lr_scale"):
        assert train[key] == getattr(ref, key), key
    assert train["clip_norm"] is None and train["label_smoothing"] == 0.0
    assert train["schedule_kwargs"] == {"t_max": 70, "eta_min": 1e-6}
    aug = ref.augment
    assert (train["augment"]["hflip"], train["augment"]["rotation"]) == (
        aug.hflip, aug.rotation) == (0.5, 10.0)
    assert aug.mean is None and "mean" not in train["augment"]
    ours = make_schedule(train, steps_per_epoch=3)
    theirs = ref.make_schedule(3)
    for step in range(0, 70 * 3 + 2, 7):
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-5,
                                           abs=1e-9), step


def test_emotion_synthetic_data_matches_jax():
    assert SYNTHETIC_SPECS["emotion"] == (1, 48, 7)
    for port, ref in zip(make_synthetic("emotion", train_per_class=2,
                                        test_per_class=1),
                         jax_make_synthetic("emotion", train_per_class=2,
                                            test_per_class=1)):
        assert port.dtype == ref.dtype
        np.testing.assert_array_equal(port, ref)


def test_emotion_clis_on_the_cpu(capsys, monkeypatch):
    serve_main(["--preset", "emotion", "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["preset"] == "emotion" and summary["batch"] == 8
    assert all(0 <= p < 7 for p in summary["predictions"])
    # the CLI trains one epoch and then evaluates the test split: a small
    # synthetic set keeps that evaluation short
    monkeypatch.setattr(port_data, "synthetic_dataset", functools.partial(
        port_data.synthetic_dataset, train_per_class=5, test_per_class=1))
    train_main(["--preset", "emotion", "--synthetic", "--epochs", "1",
                "--steps", "2",
                "--device", "cpu", "--batch-size", "16", "--amp"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["preset"] == "emotion" and summary["steps"] == 2
    assert math.isfinite(summary["first_loss"])
    assert math.isfinite(summary["last_loss"])
    assert summary["amp_layers"] == 0
