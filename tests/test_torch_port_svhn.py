"""The SVHN family in the port against the JAX package on the CPU:
ChannelCoupledDiffusion per-sweep (K1 and K3 on the card; the plain Thomas
recurrence here), the classifier's weights, eval logits and train-mode
gradients, one train step, the per-batch OneCycle schedule, the preset, the
synthetic data and the train CLI with ``--preset svhn``.

Tolerances: 1e-5 max abs on layer activations and 2e-5 of max(1, largest
entry) on the layer's gradients; 1e-4 on logits; the loss to 1e-4 relative
and each gradient within 1e-4 of its largest entry plus 1e-6; the schedule
to 1e-5 relative or 1e-6 of max_lr (the JAX one computes in float32, the
port in float64 as torch's OneCycleLR does).  Inputs hold no ReLU
pre-activation within 1e-5 of 0, where that rounding would flip the kink.
"""

import json
import math

import jax
import numpy as np
import pytest
import torch

from cnn_pde_tpu.compat.torch_import import export_state_dict
from cnn_pde_tpu.data.synthetic import make_synthetic as jax_make_synthetic
from cnn_pde_tpu.models import SVHNClassifier as JaxSVHN
from cnn_pde_tpu.nn import Ctx
from cnn_pde_tpu.pde import ChannelCoupledDiffusion as JaxCoupled
from cnn_pde_tpu.train.losses import cross_entropy as jax_cross_entropy
from cnn_pde_tpu.train.schedules import onecycle as jax_onecycle
from cnn_pde_tpu.utils.config import get_preset as jax_preset
from cnn_pde_tpu_torch.compat import state_dict_from_jax
from cnn_pde_tpu_torch.data.synthetic import make_synthetic
from cnn_pde_tpu_torch.models import build_model
from cnn_pde_tpu_torch.pde import ChannelCoupledDiffusion
from cnn_pde_tpu_torch.presets import NORMALIZATION, PRESETS
from cnn_pde_tpu_torch.train import cross_entropy, make_train_step
from cnn_pde_tpu_torch.train.__main__ import main as train_main
from cnn_pde_tpu_torch.train.schedules import onecycle
from cnn_pde_tpu_torch.train.step import make_schedule


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six test
    files at once on one host, and eight threads each oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _max_err(x, y):
    return float(np.max(np.abs(np.asarray(x, np.float64)
                               - np.asarray(y, np.float64))))


def _close_rel(port, ref, name):
    ref = torch.from_numpy(np.array(ref, np.float64))
    err = (torch.as_tensor(port).detach().double() - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item() + 1e-6, (name, err)


def _fields(rng, C, size):
    """Fields that move: bases 0.1 + 0.05·N(0, 1), time coefficients
    N(0, 1) (so that α changes by about 1 over the 10-step horizon of
    dt 0.01), coupling I + 0.1·N(0, 1), skip weight 0.3."""
    return {
        "alpha_base": 0.1 + 0.05 * rng.standard_normal((C, size, size)),
        "beta_base": 0.1 + 0.05 * rng.standard_normal((C, size, size)),
        "alpha_time_coeff": rng.standard_normal((C, size, size)),
        "beta_time_coeff": rng.standard_normal((C, size, size)),
        "channel_coupling": np.eye(C) + 0.1 * rng.standard_normal((C, C)),
        "skip_weight": np.asarray(0.3),
    }


@pytest.mark.parametrize("size,steps", [(32, 10), (12, 4)])
def test_channel_coupled_per_sweep_matches_jax(size, steps):
    """Output and the gradients of Σy² in each field against the JAX layer,
    at SVHN's (3, 32, 32) and 10 steps and at a small shape; the fields
    straddle eps, so the clamp is exercised."""
    rng = np.random.default_rng(40)
    params = {k: v.astype(np.float32)
              for k, v in _fields(rng, 3, size).items()}
    params["alpha_base"][0, :2] = -0.2  # below eps: clamped
    u = rng.random((2, 3, size, size)).astype(np.float32)
    layer = JaxCoupled(size=size, channels=3, dt=0.01, num_steps=steps)

    def loss(p):
        y, _ = layer.apply(p, {}, u, Ctx(train=True))
        return (y ** 2).sum(), y

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    port = ChannelCoupledDiffusion(size, 3, dt=0.01, num_steps=steps)
    port.load_state_dict({k: torch.tensor(v) for k, v in params.items()})
    out = port(torch.from_numpy(u))
    (out ** 2).sum().backward()
    assert _max_err(out.detach(), ref) <= 1e-5
    for name, p in port.named_parameters():
        g = np.asarray(grads[name])
        scale = max(1.0, float(np.max(np.abs(g))))
        assert _max_err(p.grad, g) / scale <= 2e-5, name


def test_channel_coupled_init_matches_jax_distributions():
    """The init: bases 0.1, coupling 0.01·I, skip 0.9, time coefficients
    N(0, 1e-3²) (drawn from the generator, not JAX's key)."""
    layer = ChannelCoupledDiffusion()
    layer.reset_parameters(torch.Generator().manual_seed(0))
    params, _ = JaxCoupled().init(jax.random.PRNGKey(0))
    for name, p in layer.named_parameters():
        assert p.shape == np.shape(params[name]), name
        if "time" in name:
            assert 0.5e-3 < float(p.detach().std()) < 1.5e-3
        else:
            np.testing.assert_array_equal(p.detach().numpy(),
                                          np.asarray(params[name]))


@pytest.fixture(scope="module")
def jax_svhn():
    """The JAX SVHN classifier with its PDE fields and every head
    parameter and BN statistic randomised."""
    rng = np.random.default_rng(41)
    model = JaxSVHN(dropout_rate=0.0)
    params, state = jax.tree_util.tree_map(
        np.asarray, jax.jit(model.init)(jax.random.PRNGKey(3)))
    params["diff"] = {k: v.astype(np.float32)
                      for k, v in _fields(rng, 3, 32).items()}

    def perturb(x):
        return (x + 0.05 * rng.standard_normal(x.shape)).astype(x.dtype)
    params["head"] = jax.tree_util.tree_map(perturb, params["head"])
    state["head"] = jax.tree_util.tree_map(
        lambda v: np.abs(perturb(v)).astype(v.dtype), state["head"])
    return model, params, state


def test_state_dict_from_jax_equals_export(jax_svhn):
    _, params, state = jax_svhn
    sd = state_dict_from_jax(params, state, "svhn")
    ref = export_state_dict(params, state, "svhn")
    assert list(sd) == list(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    model = build_model("svhn", device="cpu")
    model.load_state_dict(sd, strict=True)
    assert set(model.state_dict()) == set(sd)


@pytest.mark.parametrize("hoisted", [False, True])
def test_svhn_logits_match_jax(jax_svhn, hoisted):
    """Eval logits of the port (per-sweep, and the float32 hoisted grade)
    loaded from ``export_state_dict`` with ``strict=True``."""
    model, params, state = jax_svhn
    x = np.random.default_rng(42).random((4, 3, 32, 32)).astype(np.float32)
    ref, _ = jax.jit(lambda p, s, v: model.apply(p, s, v, Ctx(train=False))
                     )(params, state, x)
    port = build_model("svhn", device="cpu")
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in export_state_dict(
                              params, state, "svhn").items()}, strict=True)
    port.diff.hoisted = hoisted
    with torch.inference_mode():
        logits = port(torch.from_numpy(x)).numpy()
    assert logits.shape == (4, 10)
    assert _max_err(logits, ref) <= 1e-4


def _relu_inputs_clear_of_zero(model, x):
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


def test_svhn_train_grads_match_jax(jax_svhn):
    """The loss, every gradient and the new BN statistics of one
    train-mode forward and backward (dropout 0, no label smoothing, as the
    preset) against jax.value_and_grad of the JAX model."""
    model, params, state = jax_svhn
    rng = np.random.default_rng(43)
    x = rng.random((8, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)

    def loss_fn(p, s):
        logits, ns = model.apply(p, s, x, Ctx(train=True,
                                              rng=jax.random.PRNGKey(0)))
        return jax_cross_entropy(logits, y, 0.0), ns

    (loss, new_state), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, state)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads),
                              jax.tree_util.tree_map(np.asarray, new_state),
                              "svhn")
    port = build_model("svhn", device="cpu", dropout_rate=0.0).train()
    port.load_state_dict(state_dict_from_jax(params, state, "svhn"),
                         strict=True)
    assert _relu_inputs_clear_of_zero(port, torch.from_numpy(x)) > 1e-5
    port.load_state_dict(state_dict_from_jax(params, state, "svhn"),
                         strict=True)
    out = cross_entropy(port(torch.from_numpy(x)), torch.from_numpy(y), 0.0)
    out.backward()
    assert abs(out.item() - float(loss)) <= 1e-4 * abs(float(loss))
    # fc1-fc4 biases feed a train-mode BatchNorm: zero in exact arithmetic
    zero = {f"fc{i}.bias" for i in (1, 2, 3, 4)}
    for name, p in port.named_parameters():
        if name in zero:
            assert max(p.grad.abs().max().item(),
                       ref[name].abs().max().item()) <= 1e-4, name
        else:
            _close_rel(p.grad, ref[name], f"grad {name}")
    for name, buf in port.named_buffers():
        if "running" in name:
            assert _max_err(buf, ref[name]) <= 1e-5, name


def test_svhn_train_step_loss_matches_jax(jax_svhn):
    """One make_train_step step (preset values, augmentation off, dropout
    0): its loss is the JAX loss of the same batch, and no parameter moves
    by more than Adam's first step allows at the preset's first OneCycle
    learning rate (lr = 4e-4): lr·(1 + wd·|p|), up to float32 rounding."""
    model, params, state = jax_svhn
    rng = np.random.default_rng(44)
    x = rng.random((8, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    ref, _ = jax.jit(lambda p, s: model.apply(
        p, s, x, Ctx(train=True, rng=jax.random.PRNGKey(0))))(params, state)
    ref_loss = float(jax_cross_entropy(ref, y, 0.0))
    port = build_model("svhn", device="cpu", dropout_rate=0.0)
    port.load_state_dict(state_dict_from_jax(params, state, "svhn"),
                         strict=True)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    values = dict(PRESETS["svhn"]["train"], augment=None)
    step = make_train_step(port, values, 10, torch.Generator())
    assert step.schedule(0) == pytest.approx(1e-2 / 25)
    loss, _ = step(x, y)
    assert abs(loss.item() - ref_loss) <= 1e-4 * abs(ref_loss)
    lr, wd = 1e-2 / 25, values["weight_decay"]
    for name, p in port.named_parameters():
        moved = (p.detach() - before[name]).abs()
        # plus one float32 rounding of the new value
        assert bool((moved <= lr * (1 + wd * before[name].abs())
                     + 2.4e-7 * before[name].abs()).all()), name
        assert moved.max() > 0, name


@pytest.mark.parametrize("total,pct", [(7, 0.3), (30, 0.3), (150, 0.1),
                                        (1, 0.3)])
def test_onecycle_matches_jax(total, pct):
    ref = jax_onecycle(1e-2, total, pct_start=pct)
    ours = onecycle(1e-2, total, pct_start=pct)
    for step in range(total + 3):
        assert ours(step) == pytest.approx(float(ref(step)), rel=1e-5,
                                           abs=1e-8), step


def test_svhn_schedule_is_per_batch_onecycle():
    """The preset's schedule: OneCycle at max_lr 1e-2 over epochs × steps
    per epoch, as the JAX preset makes it."""
    ours = make_schedule(PRESETS["svhn"]["train"], steps_per_epoch=4)
    ref = jax_preset("svhn").make_schedule(4)
    for step in range(0, 15 * 4 + 2, 3):
        assert ours(step) == pytest.approx(float(ref(step)), rel=1e-5,
                                           abs=1e-8), step


def test_svhn_preset_matches_jax():
    ref = jax_preset("svhn")
    train = PRESETS["svhn"]["train"]
    for key in ("epochs", "batch_size", "lr", "weight_decay", "schedule",
                "schedule_kwargs", "label_smoothing", "clip_norm",
                "default_lr_scale"):
        assert train[key] == getattr(ref, key), key
    assert train["batch_size"] == 256 and train["label_smoothing"] == 0.0
    assert tuple(train["param_groups"]) == tuple(ref.param_groups) == ()
    assert tuple(train["augment"]["mean"]) == tuple(ref.augment.mean)
    assert tuple(train["augment"]["std"]) == tuple(ref.augment.std)
    assert not (ref.augment.hflip or ref.augment.rotation
                or ref.augment.crop_padding or ref.augment.brightness)
    assert NORMALIZATION["svhn"] == ((0.4377, 0.4438, 0.4728),
                                     (0.1980, 0.2010, 0.1970))


def test_svhn_synthetic_data_matches_jax():
    for port, ref in zip(make_synthetic("svhn", train_per_class=2,
                                        test_per_class=1),
                         jax_make_synthetic("svhn", train_per_class=2,
                                            test_per_class=1)):
        assert port.dtype == ref.dtype
        np.testing.assert_array_equal(port, ref)
    assert make_synthetic("svhn", train_per_class=1,
                          test_per_class=1)[0].shape == (10, 3, 32, 32)


def test_train_cli_svhn_on_the_cpu(capsys):
    train_main(["--preset", "svhn", "--synthetic", "--epochs", "1",
                "--steps", "2",
                "--device", "cpu", "--batch-size", "16"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["preset"] == "svhn" and summary["steps"] == 2
    assert summary["device"] == "cpu" and summary["batch_size"] == 16
    assert math.isfinite(summary["first_loss"])
    assert math.isfinite(summary["last_loss"])
    assert summary["amp_layers"] == 0 and summary["gemm_route"] is None
