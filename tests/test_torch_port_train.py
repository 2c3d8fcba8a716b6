"""The port's training path against the JAX package on the CPU: the loss, the
grouped optimizer and its schedule, the CIFAR augmentation on JAX's own
draws, the synthetic data, the train step (one step from the same weights,
and a 3-step SGD trajectory), and the train CLI.

Tolerances: 1e-6 on the loss, on optimizer trajectories and on the
augmentation ops that only move, scale or clip pixels; 1e-4 on the whole
augmentation pipeline (the JAX warp runs at Precision.HIGH, about 2e-5 from
float64); 1e-4 relative to a tensor's largest entry, plus 1e-6, on the train
step's gradients and parameters (as in ``test_torch_port_train_model.py``).
"""

import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cnn_pde_tpu.data import augment as jaug
from cnn_pde_tpu.data.synthetic import make_synthetic as jax_make_synthetic
from cnn_pde_tpu.models import CIFAR10PDENoConv as JaxModel
from cnn_pde_tpu.nn import Ctx
from cnn_pde_tpu.train.loop import Trainer
from cnn_pde_tpu.train.losses import cross_entropy as jax_cross_entropy
from cnn_pde_tpu.train.optim import _group_labels, build_optimizer as jax_opt
from cnn_pde_tpu.utils.config import get_preset as jax_preset
from cnn_pde_tpu_torch.compat import _torch_key, state_dict_from_jax
from cnn_pde_tpu_torch.data import augment as paug
from cnn_pde_tpu_torch.data.synthetic import make_synthetic
from cnn_pde_tpu_torch.models import build_model
from cnn_pde_tpu_torch.presets import PRESETS
from cnn_pde_tpu_torch.train import (ParamGroup, build_optimizer,
                                     clip_by_global_norm_, cross_entropy,
                                     make_train_step)
from cnn_pde_tpu_torch.train.__main__ import main as train_main
from cnn_pde_tpu_torch.train.optim import group_labels, set_learning_rates
from cnn_pde_tpu_torch.train.step import make_schedule

from tests.test_torch_port_train_model import ZERO_IN_EXACT_ARITHMETIC


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six test
    files at once on one host, and eight threads each oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = PRESETS["cifar10_noconv"]["train"]
SPEC = paug.AugmentSpec(**TRAIN["augment"])


def _flat_names(tree):
    """JAX pytree leaves by the port's state_dict name."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {_torch_key(".".join(str(getattr(k, "key", k)) for k in path),
                       is_state=False): leaf for path, leaf in leaves}


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = (3.0 * rng.standard_normal((16, 10))).astype(np.float32)
    labels = rng.integers(0, 10, 16).astype(np.int32)
    for smoothing in (0.0, 0.1):
        ref = float(jax_cross_entropy(logits, labels, smoothing))
        port = cross_entropy(torch.from_numpy(logits),
                             torch.from_numpy(labels), smoothing).item()
        assert abs(port - ref) <= 1e-6


def test_preset_training_values_match_jax():
    ref = jax_preset("cifar10_noconv")
    for key in ("epochs", "batch_size", "lr", "weight_decay", "schedule",
                "label_smoothing", "clip_norm", "default_lr_scale"):
        assert TRAIN[key] == getattr(ref, key), key
    assert [ParamGroup(*g) for g in TRAIN["param_groups"]] == [
        ParamGroup(tuple(g.match_substrings), g.lr_scale, g.weight_decay)
        for g in ref.param_groups]
    for key, value in TRAIN["augment"].items():
        assert tuple(np.atleast_1d(getattr(ref.augment, key))) == \
            tuple(np.atleast_1d(value)), key


def test_synthetic_data_matches_jax():
    for port, ref in zip(make_synthetic("cifar10", train_per_class=2,
                                        test_per_class=1),
                         jax_make_synthetic("cifar10", train_per_class=2,
                                            test_per_class=1)):
        assert port.dtype == ref.dtype
        np.testing.assert_array_equal(port, ref)


@pytest.fixture(scope="module")
def jax_flagship():
    model = JaxModel(dropout_rate=0.0)
    params, state = jax.tree_util.tree_map(
        np.asarray, jax.jit(model.init)(jax.random.PRNGKey(5)))
    return model, params, state


def test_group_labels_match_jax(jax_flagship):
    _, params, _ = jax_flagship
    groups = [ParamGroup(*g) for g in TRAIN["param_groups"]]
    ref = _flat_names(_group_labels(params, groups))
    port = build_model("cifar10_noconv", device="cpu")
    assert group_labels(port, groups) == ref
    assert sorted(set(ref.values())) == ["0", "default"]


def test_optimizer_matches_jax_over_five_updates(jax_flagship):
    """The same gradients (large enough that the clip acts) through the
    port's clip, schedule and grouped AdamW and through JAX
    build_optimizer, with 2 steps an epoch so the cosine moves."""
    _, params, state = jax_flagship
    groups = [ParamGroup(*g) for g in TRAIN["param_groups"]]
    schedule = make_schedule(TRAIN, steps_per_epoch=2)
    jax_schedule = jax_preset("cifar10_noconv").make_schedule(2)
    opt = jax_opt(params, jax_schedule, groups=jax_preset(
        "cifar10_noconv").param_groups, default_weight_decay=1e-4,
        default_lr_scale=0.5, clip_norm=1.0)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = opt.init(jparams)
    port = build_model("cifar10_noconv", device="cpu")
    port.load_state_dict(state_dict_from_jax(params, state), strict=True)
    popt = build_optimizer(port, groups=groups, default_weight_decay=1e-4,
                           default_lr_scale=0.5)
    rng = np.random.default_rng(9)

    @jax.jit
    def update(grads, opt_state, jparams):
        updates, opt_state = opt.update(grads, opt_state, jparams)
        return optax.apply_updates(jparams, updates), opt_state

    for step in range(5):
        grads = jax.tree_util.tree_map(
            lambda p: (0.05 * rng.standard_normal(p.shape)).astype(
                np.float32), params)
        jparams, opt_state = update(grads, opt_state, jparams)
        sd = state_dict_from_jax(grads, state)
        for name, p in port.named_parameters():
            p.grad = sd[name].clone()
        norm = clip_by_global_norm_(list(port.parameters()), 1.0)
        assert norm.item() > 1.0
        set_learning_rates(popt, schedule(step))
        popt.step()
    assert schedule(4) < schedule(0)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              state)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=0,
                                   atol=1e-6, err_msg=name)


def _jax_draws(key, batch, H, W):
    """The draws JAX's CIFAR augment takes from ``key``, re-derived by the
    split/fold_in chain of ``build_augment_fn``'s ``augment_one``."""
    names = ("crop_oy", "crop_ox", "flip", "angle", "brightness", "contrast",
             "saturation", "hue", "erase", "erase_area", "erase_log_ratio",
             "erase_oy", "erase_ox")
    d = {k: [] for k in names}
    for rng in jax.random.split(key, batch):
        ks = jax.random.split(rng, 6)
        ky, kx = jax.random.split(ks[0])
        d["crop_oy"].append(jax.random.randint(ky, (), 0, 9))
        d["crop_ox"].append(jax.random.randint(kx, (), 0, 9))
        d["flip"].append(jax.random.bernoulli(ks[1], 0.5))
        d["angle"].append(jax.random.uniform(ks[2], (), minval=-10.0,
                                             maxval=10.0))
        kj = jax.random.split(ks[4], 4)
        for k, key_j, lo, hi in (("brightness", kj[0], 0.8, 1.2),
                                 ("contrast", kj[1], 0.8, 1.2),
                                 ("saturation", kj[2], 0.8, 1.2),
                                 ("hue", kj[3], -0.1, 0.1)):
            d[k].append(jax.random.uniform(key_j, (), minval=lo, maxval=hi))
        ke = jax.random.split(ks[5], 5)
        d["erase"].append(jax.random.bernoulli(ke[0], 0.1))
        d["erase_area"].append(jax.random.uniform(ke[1], (), minval=0.02,
                                                  maxval=0.33))
        d["erase_log_ratio"].append(jax.random.uniform(
            ke[2], (), minval=math.log(0.3), maxval=math.log(3.3)))
        d["erase_oy"].append(jax.random.randint(ke[3], (), 0, H))
        d["erase_ox"].append(jax.random.randint(ke[4], (), 0, W))
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


@pytest.fixture(scope="module")
def augment_case():
    images = make_synthetic("cifar10", train_per_class=2,
                            test_per_class=1)[0][:12]
    key = jax.random.PRNGKey(4)
    draws = _jax_draws(key, images.shape[0], 32, 32)
    # the case exercises every branch: some images flipped and erased
    assert draws["flip"].any() and not draws["flip"].all()
    assert draws["erase"].any()
    return images, key, draws


def test_augment_pipeline_matches_jax_on_its_draws(augment_case):
    images, key, draws = augment_case
    ref = jaug.build_augment_fn(jax_preset("cifar10_noconv").augment)(
        key, jnp.asarray(images))
    port = paug.apply(SPEC, torch.from_numpy(images), draws)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)


def test_augment_ops_match_jax(augment_case):
    """Crop-pad, flip, jitter and erasing one by one, each image with the
    key JAX's pipeline hands that op, at 1e-6."""
    images, key, d = augment_case
    x = torch.from_numpy(images)
    keys = [jax.random.split(k, 6) for k in jax.random.split(
        key, images.shape[0])]

    def jax_op(fn, slot):
        return np.stack([np.asarray(fn(ks[slot], jnp.asarray(img)))
                         for ks, img in zip(keys, images)])

    cases = [
        (paug.apply_crop_pad(x, d["crop_oy"], d["crop_ox"], 4),
         jax_op(lambda k, im: jaug._random_crop_pad(k, im, 4), 0)),
        (paug.apply_hflip(x, d["flip"]),
         jax_op(lambda k, im: jaug._hflip(k, im, 0.5), 1)),
        (paug.apply_color_jitter(x, d["brightness"], d["contrast"],
                                 d["saturation"], d["hue"]),
         jax_op(lambda k, im: jaug._color_jitter(k, im, 0.2, 0.2, 0.2, 0.1),
                4)),
        (paug.apply_erasing(x, torch.ones_like(d["erase"]), d["erase_area"],
                            d["erase_log_ratio"], d["erase_oy"],
                            d["erase_ox"]),
         jax_op(lambda k, im: jaug._random_erasing(k, im, p=1.0), 5)),
    ]
    for port, ref in cases:
        np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-6)
    rot = paug.apply_rotation(x, d["angle"])
    np.testing.assert_allclose(
        rot.numpy(), jax_op(lambda k, im: jaug._rotate(k, im, 10.0), 2),
        rtol=0, atol=1e-4)


def test_augment_draws_from_the_generator():
    x = torch.rand((6, 3, 32, 32))
    a = paug.augment(SPEC, x, torch.Generator().manual_seed(1))
    b = paug.augment(SPEC, x, torch.Generator().manual_seed(1))
    c = paug.augment(SPEC, x, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == x.shape and torch.isfinite(a).all()


def _close_tensor(port, ref, name):
    ref = torch.as_tensor(np.asarray(ref)).double()
    err = (port.detach().double() - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item() + 1e-6, (name, err)


@pytest.fixture(scope="module")
def step_case(jax_flagship):
    """A batch of 8 random images whose pooled features hold no near tie
    (top-2 gap of every max-pool window above 1e-4, see
    test_torch_port_train_model.py), JAX's grads and new BN state on them,
    and JAX's Trainer step (augmentation off, dropout 0)."""
    model, params, state = jax_flagship
    rng = np.random.default_rng(26)
    x = rng.random((8, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    port = build_model("cifar10_noconv", device="cpu", dropout_rate=0.0)
    port.load_state_dict(state_dict_from_jax(params, state), strict=True)
    with torch.no_grad():
        pooled = port.train().feature_bn(port.feature_extractor(
            torch.from_numpy(x))).unfold(2, 8, 8).unfold(3, 8, 8)
        top2 = pooled.reshape(*pooled.shape[:4], 64).topk(2, dim=-1).values
        assert float((top2[..., 0] - top2[..., 1]).min()) > 1e-4

    def loss_fn(p, s):
        logits, ns = model.apply(p, s, x, Ctx(train=True,
                                              rng=jax.random.PRNGKey(0)))
        return jax_cross_entropy(logits, y, 0.1), ns

    (loss, new_state), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, state)
    preset = jax_preset("cifar10_noconv")
    trainer = Trainer(model, preset.make_train_config(), preset.make_schedule(
        3), augment_fn=None)
    ts = trainer.init_state(jax.random.PRNGKey(0), None,
                            initial=(params, state))
    step = trainer._make_train_step(ts.params)
    new_params, _, _, step_loss, _ = step(ts.params, ts.model_state,
                                          ts.opt_state, 0, x, y,
                                          jax.random.PRNGKey(0))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (x, y, float(loss), float(step_loss),
            state_dict_from_jax(as_np(grads), as_np(new_state)),
            state_dict_from_jax(as_np(new_params), as_np(new_state)))


def test_train_step_matches_jax_trainer(jax_flagship, step_case):
    _, params, state = jax_flagship
    x, y, loss_ref, step_loss_ref, grads, post = step_case
    assert abs(loss_ref - step_loss_ref) <= 1e-6
    values = dict(TRAIN, augment=None)
    model = build_model("cifar10_noconv", device="cpu", dropout_rate=0.0)
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    step = make_train_step(model, values, 3, torch.Generator())
    loss, acc = step(x, y)
    assert abs(loss.item() - loss_ref) <= 1e-4 * abs(loss_ref)
    assert 0.0 <= acc.item() <= 1.0
    norm = math.sqrt(sum(float(np.sum(np.square(grads[n].numpy(),
                                                 dtype=np.float64)))
                         for n, _ in model.named_parameters()))
    clip = 1.0 / norm if norm > 1.0 else 1.0
    for name, p in model.named_parameters():
        g = grads[name].numpy()
        if name in ZERO_IN_EXACT_ARITHMETIC:
            continue
        _close_tensor(p.grad, g * clip, f"grad {name}")
        # Adam's first step is ±lr·sign(g) for the clipped g that reaches
        # it; where that g is near Adam's eps, rounding noise in g moves the
        # step, so only the entries with |g| > 1e-6 are compared
        moved = np.abs(g * clip) > 1e-6
        np.testing.assert_allclose(p.detach().numpy()[moved],
                                   post[name].numpy()[moved], rtol=0,
                                   atol=1e-6, err_msg=name)
    for name, buf in model.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), post[name].numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)


def test_sgd_trajectory_matches_jax(jax_flagship, step_case):
    """Three steps of clip + SGD(lr 0.05) from the same weights and batch:
    every parameter and BN statistic along a short trajectory."""
    model, params, state = jax_flagship
    x, y = step_case[:2]
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.sgd(0.05))

    @jax.jit
    def jax_step(p, s, o):
        def loss_fn(p_, s_):
            logits, ns = model.apply(p_, s_, x, Ctx(
                train=True, rng=jax.random.PRNGKey(0)))
            return jax_cross_entropy(logits, y, 0.1), ns
        (_, ns), g = jax.value_and_grad(loss_fn, has_aux=True)(p, s)
        updates, o = opt.update(g, o, p)
        return optax.apply_updates(p, updates), ns, o

    p, s = params, state
    o = opt.init(p)
    for _ in range(3):
        p, s, o = jax_step(p, s, o)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, p),
                              jax.tree_util.tree_map(np.asarray, s))

    port = build_model("cifar10_noconv", device="cpu", dropout_rate=0.0)
    port.load_state_dict(state_dict_from_jax(params, state), strict=True)
    sgd = torch.optim.SGD([{"params": list(port.parameters()),
                            "lr_scale": 1.0}], lr=0.0)
    values = dict(TRAIN, augment=None, schedule="constant", lr=0.05)
    step = make_train_step(port, values, 3, torch.Generator(), optimizer=sgd)
    for _ in range(3):
        step(x, y)
    for name, t in port.state_dict().items():
        if "num_batches" not in name:
            _close_tensor(t, ref[name].numpy(), name)


def test_train_cli_prints_its_summary_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "cnn_pde_tpu_torch.train", "--preset",
         "cifar10_noconv", "--synthetic", "--epochs", "1", "--steps", "2",
         "--batch-size",
         "8", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["preset"] == "cifar10_noconv" and summary["steps"] == 2
    assert math.isfinite(summary["first_loss"])
    assert math.isfinite(summary["last_loss"])
    assert summary["images_per_s"] > 0


def test_train_cli_refuses_cpu_without_device_flag():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    with pytest.raises(SystemExit) as exit_info:
        train_main(["--preset", "cifar10_noconv", "--synthetic", "--steps",
                    "1"])
    assert exit_info.value.code not in (0, None)
    assert "--device cpu" in str(exit_info.value.code)
