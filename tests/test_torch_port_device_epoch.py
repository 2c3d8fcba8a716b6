"""The device epoch (``TrainConfig.device_epoch``, ``train/graph.py``),
the optimizer, ``remat`` and ``utils/debug.py`` on the CPU.  On
a CPU model the device epoch runs the bodies it captures on the card
eagerly, so it is held against the host loop bit for bit; the CUDA graph
itself is held against the eager run on the card by ``chip_smoke.py``.

Tolerances: the device epoch against the host loop, bit for bit (weights,
BatchNorm statistics, optimizer state, each epoch's loss, accuracy and
test accuracy), also with gradient accumulation, per-epoch or fused
chunks and a resume across a chunk boundary; against the JAX
``Trainer(device_epoch=True)`` on the mnist preset: each epoch's loss
1e-4 relative, the test accuracies equal; the on-device eval's
predictions equal the host eval's.  The optimizer against optax after
five updates: 1e-6, with float32 or bf16 moments.  ``remat`` against no
remat: bit for bit; against the JAX ``remat=True`` layer: outputs 1e-5,
gradients 1e-4 of their largest entry.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cnn_pde_tpu.data.pipeline import ArrayDataset as JaxArrayDataset
from cnn_pde_tpu.models import MNISTClassifier as JaxMNIST
from cnn_pde_tpu.pde import GrayscaleDiffusion as JaxGrayscale
from cnn_pde_tpu.pde import MixedChannelDiffusion as JaxMixed
from cnn_pde_tpu.train.loop import Trainer as JaxTrainer
from cnn_pde_tpu.train.optim import ParamGroup as JaxParamGroup
from cnn_pde_tpu.train.optim import build_optimizer as jax_build_optimizer
from cnn_pde_tpu.utils.config import get_preset as jax_preset
import cnn_pde_tpu_torch.data as port_data
from cnn_pde_tpu_torch.compat import state_dict_from_jax
from cnn_pde_tpu_torch.data import ArrayDataset, make_synthetic
from cnn_pde_tpu_torch.models import build_model
from cnn_pde_tpu_torch.pde import GrayscaleDiffusion, MixedChannelDiffusion
from cnn_pde_tpu_torch.presets import PRESETS
from cnn_pde_tpu_torch.train import (TrainConfig, Trainer, TrainState,
                                     make_train_step)
from cnn_pde_tpu_torch.train.__main__ import main as train_main
from cnn_pde_tpu_torch.train.checkpoint import restore_state
from cnn_pde_tpu_torch.train.optim import (OptaxAdamW, ParamGroup,
                                           build_optimizer,
                                           set_learning_rates)
from cnn_pde_tpu_torch.utils import nan_guard, step_timer


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six test
    files at once on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fashion_data(train_per_class=8, test_per_class=2):
    norm = PRESETS["fashion_mnist"]["train"]["augment"]
    return ArrayDataset(*make_synthetic(
        "fashion_mnist", train_per_class=train_per_class,
        test_per_class=test_per_class), mean=norm["mean"], std=norm["std"])


def _fashion_trainer(device_epoch, **overrides):
    """The fashion_mnist preset (augmentation, dropout, BatchNorm) at batch
    16 from a seeded init: 5 steps an epoch on 80 images unless capped."""
    values = PRESETS["fashion_mnist"]["train"]
    model = build_model("fashion_mnist", device="cpu",
                        generator=torch.Generator().manual_seed(0))
    kw = dict(epochs=2, batch_size=16, eval_batch_size=16, log_every=10**9)
    kw.update(overrides)
    trainer = Trainer(model, TrainConfig.from_preset(
        values, device_epoch=device_epoch, **kw), values)
    return trainer, trainer.init_state(5)


def _same_state(a, b):
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    for x, y in zip(a.optimizer.state_dict()["state"].values(),
                    b.optimizer.state_dict()["state"].values()):
        assert all(torch.equal(torch.as_tensor(x[k]), torch.as_tensor(y[k]))
                   for k in x)
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _records(history):
    return [(r["loss"], r["acc"], r.get("test_acc")) for r in history]


@pytest.mark.parametrize("multi_epoch_dispatch", [True, False])
def test_device_epoch_equals_the_host_loop(multi_epoch_dispatch):
    """Two epochs, an eval after the second, 3 steps an epoch
    (max_steps_per_epoch) and grad_accum=2 (an update spans the epochs'
    boundary): the same weights, statistics, optimizer state, generator
    and history as the host loop, with one chunk of two epochs (fused) or
    one an epoch."""
    kw = dict(eval_every=2, max_steps_per_epoch=3, grad_accum=2,
              multi_epoch_dispatch=multi_epoch_dispatch)
    data = _fashion_data()
    host, hs = _fashion_trainer(False, **kw)
    ref = host.fit(hs, data, verbose=False)
    dev, ds = _fashion_trainer(True, **kw)
    got = dev.fit(ds, data, verbose=False)
    _same_state(ds, hs)
    assert hs.step == 6 and ds.train_step.updates == 3
    assert _records(got["history"]) == _records(ref["history"])
    assert got["history"][1]["test_acc"] is not None
    assert [r["chunk"] for r in got["history"]] == (
        [2, 2] if multi_epoch_dispatch else [1, 1])
    assert got["best_acc"] == ref["best_acc"]


def test_device_epoch_resumes_across_a_chunk_boundary(tmp_path, capsys):
    """Four epochs in chunks of two (eval every 2), stopped after the
    first chunk by a preemption request with a 'last' checkpoint, then
    restored into a new Trainer and run to the end: bit for bit the
    uninterrupted device-epoch run, which is bit for bit the host loop."""
    kw = dict(epochs=4, eval_every=2, max_steps_per_epoch=2)
    data = _fashion_data()
    whole, ws = _fashion_trainer(True, **kw)
    ref = whole.fit(ws, data, verbose=False)
    host, hs = _fashion_trainer(False, **kw)
    host.fit(hs, data, verbose=False)
    _same_state(ws, hs)

    class Stop:
        requested = False

    def request(model, epoch):
        Stop.requested = True

    ckpt = str(tmp_path / "ckpt")
    first, fs = _fashion_trainer(True, **kw)
    part = first.fit(fs, data, verbose=True, checkpoint_dir=ckpt,
                     param_stats_fn=request, preemption=Stop)
    capsys.readouterr()
    assert part["preempted"] and len(part["history"]) == 2 and fs.step == 4
    second, ss = _fashion_trainer(True, **kw)
    restore_state(ss, ckpt, "last")
    rest = second.fit(ss, data, verbose=False)
    assert len(rest["history"]) == 2
    _same_state(ss, ws)
    assert _records(part["history"] + rest["history"]) == \
        _records(ref["history"])


def test_device_epoch_matches_the_jax_device_epoch():
    """Two epochs of the mnist preset (batch 32, no augmentation, dropout
    0) from the same weights in both packages' device epochs: each
    epoch's mean loss within 1e-4 relative and every test accuracy
    equal."""
    rng = np.random.default_rng(1)
    model = JaxMNIST(dropout_rate=0.0)
    params, state = jax.tree_util.tree_map(
        np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0)))
    for key in ("alpha_base", "beta_base"):
        params["diff"][key] = (params["diff"][key] + 0.2 * rng.standard_normal(
            params["diff"][key].shape)).astype(np.float32)
    port = build_model("mnist", device="cpu", dropout_rate=0.0)
    port.load_state_dict(state_dict_from_jax(params, state, "mnist"),
                         strict=True)
    arrays = make_synthetic("mnist", train_per_class=8, test_per_class=3)
    ref = jax_preset("mnist")
    jax_trainer = JaxTrainer(model, ref.make_train_config(
        epochs=2, batch_size=32, log_every=10**9, device_epoch=True),
        ref.make_schedule(2), augment_fn=None)
    ts = jax_trainer.init_state(jax.random.PRNGKey(0), None,
                                initial=(params, state))
    theirs = jax_trainer.fit(ts, JaxArrayDataset(*arrays), verbose=False)
    values = dict(PRESETS["mnist"]["train"], augment=None)
    trainer = Trainer(port, TrainConfig.from_preset(
        values, epochs=2, batch_size=32, device_epoch=True), values)
    ours = trainer.fit(trainer.init_state(2), ArrayDataset(*arrays),
                       verbose=False)
    assert len(ours["history"]) == len(theirs["history"]) == 2
    for a, b in zip(ours["history"], theirs["history"]):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
        assert a["test_acc"] == b["test_acc"]
        assert a["chunk"] == b["chunk"] == 1


def test_on_device_eval_equals_the_host_eval():
    """30 test images at an eval batch of 16: the padded split's
    predictions, padding sliced off, equal the host eval's on the same
    weights; a second eval replays the same runner."""
    data = _fashion_data(test_per_class=3)
    dev, ds = _fashion_trainer(True, max_steps_per_epoch=1)
    dev.train_epoch(ds, data, 0, verbose=False)
    host, _ = _fashion_trainer(False)
    ref = host.evaluate(ds, data)
    for _ in range(2):
        got = dev.evaluate(ds, data)
        assert got["predictions"].shape == (30,)
        np.testing.assert_array_equal(got["predictions"], ref["predictions"])
        np.testing.assert_array_equal(got["labels"], ref["labels"])
        assert got["acc"] == ref["acc"]
    assert not ds.model.training


def test_on_device_eval_follows_the_states_model():
    """One Trainer's on-device eval of two states whose models differ:
    each gets the host eval's predictions of its own model (the graph of
    the first model's forward is not replayed for the second)."""
    data = _fashion_data(test_per_class=3)
    dev, ds = _fashion_trainer(True)
    host, hs = _fashion_trainer(False)
    other = build_model("fashion_mnist", device="cpu",
                        generator=torch.Generator().manual_seed(7))
    for state in (ds, TrainState(other, ds.optimizer, ds.train_step,
                                 ds.generator), ds):
        got = dev.evaluate(state, data)
        ref = host.evaluate(TrainState(state.model, hs.optimizer,
                                       hs.train_step, hs.generator), data)
        np.testing.assert_array_equal(got["predictions"], ref["predictions"])
    first = dev.evaluate(ds, data)["predictions"]
    assert not np.array_equal(first, host.evaluate(
        TrainState(other, hs.optimizer, hs.train_step, hs.generator),
        data)["predictions"])


@pytest.mark.parametrize("moments,resumed", [
    ("float32", True), ("bfloat16", True), ("bfloat16", False),
    ("float32", False)])
def test_capturable_optimizer_matches_optax(moments, resumed):
    """OptaxAdamW (the learning rates and the update count as tensors on
    the parameters' device), float32 or bf16 moments, two groups: five
    updates on the same gradients as optax's adamw (build_optimizer of the
    JAX package) within 1e-6, also when a new optimizer restores the
    first's checkpoint after two updates and makes the rest; a checkpoint
    restores into its tensors in place with the moments' dtype kept
    (torch's Optimizer.load_state_dict cast bf16 moments to float32)."""
    rng = np.random.default_rng(8)
    init = {"alpha_base": rng.random((6, 6)).astype(np.float32),
            "w": rng.random((5, 4)).astype(np.float32)}
    groups = (ParamGroup(("alpha",), 1.0, 1e-6),)
    lrs = [1e-2, 8e-3, 6e-3, 4e-3, 2e-3]
    md, jmd = {"float32": (None, None),
               "bfloat16": (torch.bfloat16, jnp.bfloat16)}[moments]
    model = torch.nn.Module()
    for k, v in init.items():
        model.register_parameter(k, torch.nn.Parameter(
            torch.from_numpy(v.copy())))

    def new_optimizer():
        return build_optimizer(model, groups=groups,
                               default_weight_decay=1e-4,
                               default_lr_scale=0.5, moment_dtype=md)

    opt = new_optimizer()
    assert isinstance(opt, OptaxAdamW)
    jopt = jax_build_optimizer(
        init, lambda s: jnp.asarray(lrs)[s],
        groups=(JaxParamGroup(("alpha",), 1.0, 1e-6),),
        default_weight_decay=1e-4, default_lr_scale=0.5, clip_norm=None,
        moment_dtype=jmd)
    params, state = init, jopt.init(init)
    for i in range(5):
        if resumed and i == 2:
            saved = opt.state_dict()
            opt = new_optimizer()
            opt.load_state_dict(saved)
        grads = jax.tree_util.tree_map(
            lambda x: (0.01 * np.cos(np.asarray(x) + i)).astype(
                np.float32), params)
        updates, state = jopt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(np.asarray(grads[name]))
        set_learning_rates(opt, lrs[i])
        opt.step()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), params[name],
                                   rtol=0, atol=1e-6, err_msg=name)
    lr_tensors = [g["lr"] for g in opt.param_groups]
    saved = opt.state_dict()
    exp_avg = opt.state[model.alpha_base]["exp_avg"]
    opt.load_state_dict(saved)
    assert all(g["lr"] is t for g, t in zip(opt.param_groups, lr_tensors))
    assert float(opt.param_groups[0]["step"]) == 5.0
    assert opt.state[model.alpha_base]["exp_avg"] is exp_avg
    assert exp_avg.dtype == (md or torch.float32)


def test_capturable_train_step_reads_its_schedule_on_the_device():
    """A train step over the preset's optimizer (OptaxAdamW) on the CPU:
    its learning rates come from the schedule's table at the device's
    update count (grad_accum=2: one update every two steps), within 1e-6
    of the weights of the same step over torch's AdamW, whose learning
    rates the host sets each update."""
    values = dict(PRESETS["mnist"]["train"], augment=None)
    rng = np.random.default_rng(3)
    images = rng.random((4, 8, 1, 28, 28)).astype(np.float32)
    labels = rng.integers(0, 10, (4, 8))
    runs = []
    for on_device in (False, True):
        model = build_model("mnist", device="cpu", dropout_rate=0.0,
                            generator=torch.Generator().manual_seed(2))
        opt = build_optimizer(model)
        if not on_device:
            opt = torch.optim.AdamW(
                [{"params": g["params"], "lr_scale": g["lr_scale"],
                  "weight_decay": g["weight_decay"]}
                 for g in opt.param_groups], lr=0.0)
        step = make_train_step(model, values, 1, torch.Generator(),
                               optimizer=opt, grad_accum=2,
                               schedule=lambda u: 1e-3 / (1 + u))
        for x, y in zip(images, labels):
            step(x, y)
        runs.append((model, step))
    (plain, plain_step), (model, step) = runs
    assert plain_step.lr_table is None
    assert step.updates == 2 and int(step.update_t) == 2
    np.testing.assert_array_equal(step.lr_table[0, :2].numpy(),
                                  np.float32([1e-3, 5e-4]))
    for (name, p), q in zip(model.named_parameters(), plain.parameters()):
        assert float((p - q).detach().abs().max()) <= 1e-6, name


LAYER_CASES = {
    "mixed": (JaxMixed, MixedChannelDiffusion, dict(size=12, channels=3,
                                                    num_steps=3, dt=0.05)),
    "grayscale": (JaxGrayscale, GrayscaleDiffusion, dict(size=12,
                                                         num_steps=3,
                                                         dt=0.05)),
}


@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("layer", sorted(LAYER_CASES))
def test_remat_matches_no_remat_and_jax(layer, hoisted):
    jax_cls, cls, kw = LAYER_CASES[layer]
    rng = np.random.default_rng(5)
    C = kw.get("channels", 1)
    shape = (C, 12, 12) if layer == "mixed" else (12, 12)
    params = {"alpha_base": 1.0 + 0.5 * rng.random(shape),
              "beta_base": 1.0 + 0.5 * rng.random(shape),
              "alpha_time_coeff": rng.standard_normal(shape),
              "beta_time_coeff": rng.standard_normal(shape)}
    if layer == "mixed":
        params["channel_mixing"] = np.eye(C) + 0.05 * rng.standard_normal(
            (C, C))
    params = {k: v.astype(np.float32) for k, v in params.items()}
    u = rng.random((2, C, 12, 12)).astype(np.float32)
    g = rng.standard_normal(u.shape).astype(np.float32)

    def port(remat):
        m = cls(remat=remat, hoisted=hoisted, **kw)
        m.load_state_dict({k: torch.from_numpy(v) for k, v in
                           params.items()})
        x = torch.from_numpy(u).requires_grad_(True)
        out = m(x)
        out.backward(torch.from_numpy(g))
        return out.detach(), x.grad, {n: p.grad for n, p in
                                      m.named_parameters()}

    out, gx, gp = port(True)
    ref_out, ref_gx, ref_gp = port(False)
    assert torch.equal(out, ref_out) and torch.equal(gx, ref_gx)
    assert all(torch.equal(gp[n], ref_gp[n]) for n in gp)

    jax_layer = jax_cls(remat=True, hoisted=hoisted, **kw)

    def f(p, x):
        y, _ = jax_layer(p, {}, x)
        return jnp.sum(y * g), y

    (_, y), (jgp, jgx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, u)
    assert float(np.max(np.abs(out.numpy() - np.asarray(y)))) <= 1e-5
    for name, got, want in [("x", gx, jgx)] + [
            (n, gp[n], jgp[n]) for n in params]:
        want = np.asarray(want, np.float64)
        err = float(np.max(np.abs(got.numpy() - want)))
        assert err <= 1e-4 * np.max(np.abs(want)), name


def test_nan_guard_names_the_step():
    values = dict(PRESETS["mnist"]["train"], augment=None)
    model = build_model("mnist", device="cpu", dropout_rate=0.0)
    step = nan_guard(make_train_step(model, values, 1, torch.Generator()),
                     first_step=7)
    x = np.random.default_rng(0).random((4, 1, 28, 28)).astype(np.float32)
    timer = step_timer()
    with timer.measure():
        step(x, np.arange(4))
    assert len(timer.times) == 1 and timer.mean_ms >= 0.0
    x[1, 0, 3, 3] = np.nan
    with pytest.raises(FloatingPointError, match="at step 8"):
        step(x, np.arange(4))


@pytest.fixture
def nan_at_step_2(monkeypatch):
    """The CLI's synthetic mnist set (100 images) with one training image
    NaN: the one the epoch's permutation puts in step 2 at batch 8."""
    def dataset(name, **kw):
        ds = port_data.ArrayDataset(*make_synthetic(
            name, train_per_class=10, test_per_class=1))
        perm = np.random.default_rng(0).permutation(100)
        ds.train_images[perm[2 * 8 + 3]] = np.nan
        ds.source = "synthetic"
        return ds
    monkeypatch.setattr(port_data, "synthetic_dataset", dataset)


@pytest.mark.parametrize("device_epoch", [False, True])
def test_train_cli_debug_nans_names_the_step(device_epoch, nan_at_step_2,
                                             capsys):
    args = ["--preset", "mnist", "--synthetic", "--epochs", "1", "--steps",
            "5", "--batch-size", "8", "--device", "cpu", "--quiet",
            "--no-preemption-handler"] + (["--device-epoch"]
                                          if device_epoch else [])
    train_main(args)  # without --debug-nans the run ends, its loss NaN
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["steps"] == 5 and np.isnan(summary["last_loss"])
    with pytest.raises(FloatingPointError, match="loss nan at step 2"):
        train_main(args + ["--debug-nans"])


def test_train_cli_device_epoch_equals_the_host_loop(capsys):
    """The train CLI with --device-epoch --device cpu: the host loop's
    losses, steps and accuracy, with a resume across epochs."""
    args = ["--preset", "fashion_mnist", "--synthetic", "--epochs", "2",
            "--steps", "2", "--batch-size", "16", "--grad-accum", "2",
            "--device", "cpu", "--quiet", "--no-preemption-handler"]
    runs = []
    for extra in ([], ["--device-epoch"]):
        train_main(args + extra)
        runs.append(json.loads(
            capsys.readouterr().out.strip().splitlines()[-1]))
    host, dev = runs
    assert dev["device_epoch"] and not host["device_epoch"]
    for key in ("first_loss", "last_loss", "best_acc", "steps", "epochs"):
        assert dev[key] == host[key], key
