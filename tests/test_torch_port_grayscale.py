"""The grayscale family (MNIST, Fashion-MNIST) in the port against the JAX
package on the CPU: GrayscaleDiffusion in its three configurations (per-sweep;
``fused_inference``, K6 on the card; ``fused``, K7 and K8 on the card), both
classifiers' weights, logits and train-mode gradients, one train step, the
presets, the synthetic data, the rotation and translation warp on JAX's own
draws, and both CLIs with ``--preset mnist``.  On the CPU every wrapper runs
its plain version.

Tolerances: 1e-5 max abs on layer activations (against the JAX layer and the
float64 oracle); 1e-4 on logits; the loss to 1e-4 relative and each
gradient within 1e-4 of its largest entry plus 1e-6 (Thomas in the port's
per-sweep path against the JAX default's PCR differ by about 1e-7, and
train-mode BatchNorm amplifies that in small entries); BatchNorm running
statistics to 1e-5; the warp to 1e-4, as the CIFAR rotation test (the JAX
warp runs at Precision.HIGH).  Inputs are checked to hold no ReLU
pre-activation within 1e-5 of 0, where that rounding would flip the kink.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_pde_tpu.compat.torch_import import export_state_dict
from cnn_pde_tpu.data import augment as jaug
from cnn_pde_tpu.data.synthetic import make_synthetic as jax_make_synthetic
from cnn_pde_tpu.models import FashionClassifier as JaxFashion
from cnn_pde_tpu.models import MNISTClassifier as JaxMNIST
from cnn_pde_tpu.nn import Ctx
from cnn_pde_tpu.pde import GrayscaleDiffusion as JaxGrayscale
from cnn_pde_tpu.train.loop import Trainer
from cnn_pde_tpu.train.losses import cross_entropy as jax_cross_entropy
from cnn_pde_tpu.utils.config import get_preset as jax_preset
from cnn_pde_tpu_torch.compat import state_dict_from_jax
from cnn_pde_tpu_torch.data import augment as paug
from cnn_pde_tpu_torch.data.synthetic import make_synthetic
from cnn_pde_tpu_torch.models import NOT_YET_PORTED, build_model
from cnn_pde_tpu_torch.pde import GrayscaleDiffusion
from cnn_pde_tpu_torch.presets import NORMALIZATION, PRESETS
from cnn_pde_tpu_torch.serve_cli import main as serve_main
from cnn_pde_tpu_torch.train import (build_optimizer, cross_entropy,
                                     make_train_step)
from cnn_pde_tpu_torch.train.__main__ import main as train_main
from tests.golden.reference_numpy import grayscale_forward_np


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six test
    files at once on one host, and eight threads each oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


PRESET_NAMES = ["mnist", "fashion_mnist"]
JAX_MODELS = {"mnist": JaxMNIST, "fashion_mnist": JaxFashion}
# the layer of each preset: (dt, num_steps, init_value)
LAYERS = {"mnist": (0.001, 10, 2.0), "fashion_mnist": (0.3, 4, 1.8)}
# biases that feed a train-mode BatchNorm: zero gradient in exact arithmetic
ZERO_IN_EXACT_ARITHMETIC = {"fashion_mnist": {"fc1.bias", "fc2.bias"},
                            "mnist": set()}
NAMES = ["alpha_base", "alpha_time_coeff", "beta_base", "beta_time_coeff"]


def _max_err(x, y):
    return float(np.max(np.abs(np.asarray(x, np.float64)
                               - np.asarray(y, np.float64))))


def _close_rel(port, ref, name):
    ref = torch.from_numpy(np.array(ref, np.float64))
    err = (torch.as_tensor(port).detach().double() - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item() + 1e-6, (name, err)


def _fields(rng, init, size=28):
    """Trained-looking fields around the preset's init: bases init ± 0.5,
    time coefficients N(0, 1) scaled so that they move the coefficient by
    about 1 over the layer's horizon."""
    return {
        "alpha_base": init + 0.5 * rng.standard_normal((size, size)),
        "alpha_time_coeff": rng.standard_normal((size, size)),
        "beta_base": init + 0.5 * rng.standard_normal((size, size)),
        "beta_time_coeff": rng.standard_normal((size, size)),
    }


@pytest.fixture(scope="module")
def layer_cases():
    rng = np.random.default_rng(30)
    u = rng.random((3, 1, 28, 28)).astype(np.float32)
    cases = {}
    for preset, (dt, steps, init) in LAYERS.items():
        params = {k: (v / (dt * steps) if "time" in k else v).astype(
            np.float32) for k, v in _fields(rng, init).items()}
        layer = JaxGrayscale(28, dt=dt, num_steps=steps, init_value=init)
        ref, _ = jax.jit(lambda p, x: layer(p, {}, x))(params, u)
        oracle = grayscale_forward_np(u, params, dt, 1.0, 1.0, steps)
        cases[preset] = (params, np.asarray(ref), oracle)
    return u, cases


def _port_layer(preset, **flags):
    dt, steps, init = LAYERS[preset]
    return GrayscaleDiffusion(28, dt=dt, num_steps=steps, init_value=init,
                              **flags)


@pytest.mark.parametrize("config", ["per_sweep", "fused_inference", "fused"])
@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_grayscale_layer_matches_jax(layer_cases, preset, config):
    u, cases = layer_cases
    params, ref, oracle = cases[preset]
    layer = _port_layer(preset, **({config: True}
                                   if config != "per_sweep" else {})).eval()
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    with torch.inference_mode():
        out = layer(torch.from_numpy(u)).numpy()
    assert out.shape == u.shape
    assert _max_err(out, ref) <= 1e-5
    assert _max_err(out, oracle) <= 1e-5


def test_jax_layer_fused_flag_reaches_interpret_kernel(layer_cases):
    """The JAX layer with fused=True in interpret mode (B5) and the port's
    layer with fused=True compute the same layer."""
    u, cases = layer_cases
    params, _, _ = cases["fashion_mnist"]
    dt, steps, init = LAYERS["fashion_mnist"]
    layer = JaxGrayscale(28, dt=dt, num_steps=steps, init_value=init,
                         fused=True, fused_tile_b=4)
    layer.fused_interpret = True
    ref, _ = layer.apply({k: jnp.asarray(v) for k, v in params.items()}, {},
                         jnp.asarray(u), None)
    port = _port_layer("fashion_mnist", fused=True).train()
    port.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    out = port(torch.from_numpy(u))
    assert _max_err(out.detach(), ref) <= 1e-5


@pytest.mark.parametrize("config", ["per_sweep", "fused"])
@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_grayscale_layer_grads_match_jax(layer_cases, preset, config):
    """Gradients in u and the four fields against jax.grad through the JAX
    layer's XLA scan, within 1e-4 of each tensor's largest entry."""
    u, cases = layer_cases
    params = cases[preset][0]
    dt, steps, init = LAYERS[preset]
    g = np.random.default_rng(31).standard_normal(u.shape).astype(np.float32)
    layer = JaxGrayscale(28, dt=dt, num_steps=steps, init_value=init)
    gp, gu = jax.jit(jax.grad(lambda p, x: jnp.sum(layer(p, {}, x)[0] * g),
                              argnums=(0, 1)))(params, u)
    port = _port_layer(preset, fused=config == "fused").train()
    port.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    x = torch.from_numpy(u).requires_grad_(True)
    (port(x) * torch.from_numpy(g)).sum().backward()
    _close_rel(x.grad, gu, "grad u")
    for name in NAMES:
        _close_rel(getattr(port, name).grad, gp[name], f"grad {name}")


def test_fused_inference_takes_precedence_over_fused_in_eval(monkeypatch):
    """With both flags, eval runs the forward-only layer (K6's wrapper) and
    training the trainable one (K7 and K8's), as the JAX layer does."""
    from cnn_pde_tpu_torch.pde import diffusion

    calls = []
    for name in ("fused_grayscale_diffusion_fwd",
                 "fused_grayscale_diffusion"):
        monkeypatch.setattr(diffusion, name, lambda x, *a, _n=name, **k: (
            calls.append(_n), x)[1])
    layer = GrayscaleDiffusion(12, num_steps=2, fused_inference=True,
                               fused=True)
    x = torch.rand((2, 1, 12, 12))
    layer.eval()(x)
    layer.train()(x)
    assert calls == ["fused_grayscale_diffusion_fwd",
                     "fused_grayscale_diffusion"]


def test_stability_info_matches_jax(layer_cases):
    params = layer_cases[1]["mnist"][0]
    dt, steps, init = LAYERS["mnist"]
    ref = JaxGrayscale(28, dt=dt, num_steps=steps,
                       init_value=init).stability_info(
        {k: jnp.asarray(v) for k, v in params.items()})
    port = _port_layer("mnist")
    port.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    info = port.stability_info()
    assert set(info) == set(ref)
    for key, value in ref.items():
        assert info[key] == pytest.approx(value, rel=1e-6), key


def test_unported_grayscale_options_raise():
    # remat is ported: the layer builds and recomputes its steps
    # in the backward with the same arithmetic
    layer = GrayscaleDiffusion(size=8, num_steps=2, remat=True)
    x = torch.rand(2, 1, 8, 8, requires_grad=True)
    layer(x).sum().backward()
    assert layer.remat and torch.isfinite(x.grad).all()
    # the hybrid (A11) is ported: it builds, and no family is left
    assert NOT_YET_PORTED == {}
    assert not build_model("cifar10_hybrid", device="cpu").training


@pytest.fixture(scope="module")
def jax_models():
    """Each preset's JAX classifier with its PDE fields and every head
    parameter and BN statistic randomised, so that a wrong key, transpose
    or leaf shows."""
    rng = np.random.default_rng(32)
    out = {}
    for preset, cls in JAX_MODELS.items():
        model = cls(dropout_rate=0.0)
        params, state = jax.tree_util.tree_map(
            np.asarray, jax.jit(model.init)(jax.random.PRNGKey(7)))
        dt, steps, init = LAYERS[preset]
        params["diff"] = {k: (v / (dt * steps) if "time" in k else v)
                          .astype(np.float32)
                          for k, v in _fields(rng, init).items()}

        def perturb(x):
            return (x + 0.05 * rng.standard_normal(x.shape)).astype(x.dtype)
        params["head"] = jax.tree_util.tree_map(perturb, params["head"])
        state["head"] = jax.tree_util.tree_map(
            lambda v: np.abs(perturb(v)).astype(v.dtype), state["head"])
        out[preset] = (model, params, state)
    return out


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_state_dict_from_jax_equals_export(jax_models, preset):
    _, params, state = jax_models[preset]
    sd = state_dict_from_jax(params, state, preset)
    ref = export_state_dict(params, state, preset)
    assert list(sd) == list(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    model = build_model(preset, device="cpu")
    model.load_state_dict(sd, strict=True)
    assert set(model.state_dict()) == set(sd)


@pytest.mark.parametrize("config", ["per_sweep", "fused_inference"])
@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_classifier_logits_match_jax(jax_models, preset, config):
    model, params, state = jax_models[preset]
    x = np.random.default_rng(33).random((4, 1, 28, 28)).astype(np.float32)
    ref, _ = jax.jit(lambda p, s, v: model.apply(p, s, v, Ctx(train=False))
                     )(params, state, x)
    port = build_model(preset, device="cpu",
                       fused_inference=config == "fused_inference")
    port.load_state_dict(state_dict_from_jax(params, state, preset),
                         strict=True)
    with torch.inference_mode():
        logits = port(torch.from_numpy(x)).numpy()
    assert logits.shape == (4, 10)
    assert _max_err(logits, ref) <= 1e-4


def _relu_inputs_clear_of_zero(model, x):
    """Smallest |input| of any ReLU in one train-mode forward."""
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: seen.append(inp[0].abs().min().item()))
        for m in model.modules() if isinstance(m, torch.nn.ReLU)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return min(seen)


@pytest.mark.parametrize("config", ["per_sweep", "fused"])
@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_train_grads_match_jax(jax_models, preset, config):
    """The loss, every parameter's gradient and the new BN statistics of one
    train-mode forward and backward (dropout 0) against jax.value_and_grad
    of the JAX model under Ctx(train=True)."""
    model, params, state = jax_models[preset]
    rng = np.random.default_rng(34)
    x = rng.random((8, 1, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)

    def loss_fn(p, s):
        logits, ns = model.apply(p, s, x, Ctx(train=True,
                                              rng=jax.random.PRNGKey(0)))
        return jax_cross_entropy(logits, y, 0.1), ns

    (loss, new_state), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, state)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads),
                              jax.tree_util.tree_map(np.asarray, new_state),
                              preset)
    port = build_model(preset, device="cpu", dropout_rate=0.0,
                       fused=config == "fused").train()
    port.load_state_dict(state_dict_from_jax(params, state, preset),
                         strict=True)
    assert _relu_inputs_clear_of_zero(port, torch.from_numpy(x)) > 1e-5
    port.load_state_dict(state_dict_from_jax(params, state, preset),
                         strict=True)
    out = cross_entropy(port(torch.from_numpy(x)), torch.from_numpy(y), 0.1)
    out.backward()
    assert abs(out.item() - float(loss)) <= 1e-4 * abs(float(loss))
    for name, p in port.named_parameters():
        if name in ZERO_IN_EXACT_ARITHMETIC[preset]:
            assert max(p.grad.abs().max().item(),
                       ref[name].abs().max().item()) <= 1e-4, name
        else:
            _close_rel(p.grad, ref[name], f"grad {name}")
    for name, buf in port.named_buffers():
        if "running" in name:
            assert _max_err(buf, ref[name]) <= 1e-5, name


def test_train_step_matches_jax_trainer(jax_models):
    """One make_train_step step on mnist (augmentation off, dropout 0)
    against the JAX Trainer's: the loss, and every parameter after the
    clip and AdamW where its clipped gradient is above Adam's eps scale."""
    model, params, state = jax_models["mnist"]
    rng = np.random.default_rng(35)
    x = rng.random((8, 1, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    preset = jax_preset("mnist")
    trainer = Trainer(model, preset.make_train_config(),
                      preset.make_schedule(3), augment_fn=None)
    ts = trainer.init_state(jax.random.PRNGKey(0), None,
                            initial=(params, state))
    new_params, _, _, ref_loss, _ = trainer._make_train_step(ts.params)(
        ts.params, ts.model_state, ts.opt_state, 0, x, y,
        jax.random.PRNGKey(0))
    post = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, new_params),
                               state, "mnist")

    def loss_fn(p):
        logits, _ = model.apply(p, state, x, Ctx(train=True,
                                                 rng=jax.random.PRNGKey(0)))
        return jax_cross_entropy(logits, y, 0.1)

    grads = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(loss_fn))(params)), state, "mnist")
    norm = math.sqrt(sum(float(np.sum(np.square(g.numpy(),
                                                dtype=np.float64)))
                         for g in grads.values()))
    clip = 1.0 / norm if norm > 1.0 else 1.0
    port = build_model("mnist", device="cpu", dropout_rate=0.0)
    port.load_state_dict(state_dict_from_jax(params, state, "mnist"),
                         strict=True)
    step = make_train_step(port, dict(PRESETS["mnist"]["train"],
                                      augment=None), 3, torch.Generator())
    loss, acc = step(x, y)
    assert abs(loss.item() - float(ref_loss)) <= 1e-4 * abs(float(ref_loss))
    assert 0.0 <= acc.item() <= 1.0
    for name, p in port.named_parameters():
        moved = np.abs(grads[name].numpy() * clip) > 1e-6
        np.testing.assert_allclose(p.detach().numpy()[moved],
                                   post[name].numpy()[moved], rtol=0,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_preset_training_values_match_jax(preset):
    ref = jax_preset(preset)
    train = PRESETS[preset]["train"]
    for key in ("epochs", "batch_size", "lr", "weight_decay", "schedule",
                "schedule_kwargs", "label_smoothing", "clip_norm",
                "default_lr_scale"):
        assert train[key] == getattr(ref, key), key
    assert tuple(train["param_groups"]) == tuple(ref.param_groups) == ()
    for key in ("rotation", "translate", "hflip", "crop_padding",
                "brightness", "erasing_p", "mean", "std"):
        value = train["augment"].get(key, getattr(paug.AugmentSpec, key))
        assert value == getattr(ref.augment, key), key
    if preset == "fashion_mnist":
        assert NORMALIZATION[preset] == ((0.2860,), (0.3530,))


def test_build_optimizer_without_groups_gives_one_default_group():
    model = build_model("mnist", device="cpu")
    opt = build_optimizer(model, default_weight_decay=1e-4,
                          default_lr_scale=1.0)
    assert len(opt.param_groups) == 1
    group = opt.param_groups[0]
    assert group["name"] == "default" and group["lr_scale"] == 1.0
    assert group["weight_decay"] == 1e-4
    assert len(group["params"]) == len(list(model.parameters()))


@pytest.mark.parametrize("name", PRESET_NAMES)
def test_synthetic_data_matches_jax(name):
    for port, ref in zip(make_synthetic(name, train_per_class=2,
                                        test_per_class=1),
                         jax_make_synthetic(name, train_per_class=2,
                                            test_per_class=1)):
        assert port.dtype == ref.dtype
        np.testing.assert_array_equal(port, ref)
    images = make_synthetic(name, train_per_class=1, test_per_class=1)[0]
    assert images.shape == (10, 1, 28, 28)


def _jax_warp_draws(key, batch, H, W, spec):
    """The flip, angle and shift JAX's augment draws from ``key`` for
    ``spec``, by the split/fold_in chain of ``build_augment_fn``."""
    d = {"flip": [], "angle": [], "tx": [], "ty": []}
    for rng in jax.random.split(key, batch):
        ks = jax.random.split(rng, 6)
        if spec.hflip:
            d["flip"].append(jax.random.bernoulli(ks[1], spec.hflip))
        if spec.rotation:
            d["angle"].append(jax.random.uniform(
                ks[2], (), minval=-spec.rotation, maxval=spec.rotation))
        if spec.translate:
            d["tx"].append(jax.random.uniform(
                ks[3], (), minval=-spec.translate,
                maxval=spec.translate) * W)
            d["ty"].append(jax.random.uniform(
                jax.random.fold_in(ks[3], 1), (), minval=-spec.translate,
                maxval=spec.translate) * H)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items() if v}


@pytest.mark.parametrize("case", ["mnist", "fashion_mnist", "translate"])
def test_augment_warp_matches_jax_on_its_draws(case):
    """The composed rotation∘translation warp (mnist), with hflip and
    normalisation around it (fashion_mnist), and the translation-only warp,
    each against JAX's pipeline on JAX's own draws."""
    if case == "translate":
        jspec = jaug.AugmentSpec(translate=0.1)
        pspec = paug.AugmentSpec(translate=0.1)
    else:
        jspec = jax_preset(case).augment
        pspec = paug.AugmentSpec(**PRESETS[case]["train"]["augment"])
    images = make_synthetic("mnist", train_per_class=1,
                            test_per_class=1)[0][:10]
    key = jax.random.PRNGKey(6)
    draws = _jax_warp_draws(key, images.shape[0], 28, 28, jspec)
    assert float(draws["tx"].abs().max()) > 0.5  # a shift of pixels
    if "flip" in draws:
        assert draws["flip"].any() and not draws["flip"].all()
    ref = jaug.build_augment_fn(jspec)(key, jnp.asarray(images))
    port = paug.apply(pspec, torch.from_numpy(images), draws)
    assert port.shape == images.shape
    assert _max_err(port, ref) <= 1e-4


def test_augment_draws_shift_in_pixels():
    spec = paug.AugmentSpec(rotation=5.0, translate=0.05)
    d = paug.draw(spec, (64, 1, 28, 28), torch.Generator().manual_seed(0),
                  "cpu")
    assert set(d) == {"angle", "tx", "ty"}
    for k in ("tx", "ty"):
        assert float(d[k].abs().max()) <= 0.05 * 28
        assert float(d[k].abs().max()) > 0.5
    x = torch.rand((64, 1, 28, 28))
    assert torch.equal(paug.augment(spec, x, torch.Generator().manual_seed(1)),
                       paug.augment(spec, x, torch.Generator().manual_seed(1)))


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_build_model_runs_on_the_card_unless_asked_for_the_cpu(preset):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(preset)
    assert build_model(preset, device="cpu").fc1.weight.device.type == "cpu"


def test_serve_cli_mnist_on_the_cpu(capsys):
    serve_main(["--preset", "mnist", "--device", "cpu", "--batch-size", "3"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["preset"] == "mnist" and summary["batch"] == 3
    assert len(summary["predictions"]) == 3
    if not torch.cuda.is_available():  # without --device cpu it refuses
        with pytest.raises(SystemExit, match="--device cpu"):
            serve_main(["--preset", "mnist", "--batch-size", "1"])


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_train_cli_on_the_cpu(preset, capsys):
    train_main(["--preset", preset, "--synthetic", "--epochs", "1",
                "--steps", "2",
                "--batch-size", "16", "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["preset"] == preset and summary["steps"] == 2
    assert summary["device"] == "cpu"
    assert math.isfinite(summary["first_loss"])
    assert math.isfinite(summary["last_loss"])
