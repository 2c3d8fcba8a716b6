"""The port's training engine (``train/loop.py``, ``train/checkpoint.py``,
``train/sinks.py``, ``train/metrics.py``, ``data/pipeline.py``) on the
CPU, against the JAX package where it has a counterpart; the train CLI's
epochs, checkpoints and resume are in test_torch_port_trainer_cli.py.

Tolerances: ``Trainer.fit`` against the JAX ``Trainer.fit`` from the same
weights (mnist preset, no augmentation, dropout 0): each epoch's mean loss
1e-4 relative, the test accuracies equal; ``grad_accum=2`` at B against
one step at 2B, every parameter within 1e-5; a run stopped by SIGTERM and
resumed from its checkpoint against an uninterrupted one: bit for bit;
the BN refresh against the JAX refreshed statistics: 1e-5 of max(1,
largest entry).
"""

import json
import os
import signal
import socket
import time
import warnings

import jax
import numpy as np
import pytest
import torch

from cnn_pde_tpu.data.pipeline import ArrayDataset as JaxArrayDataset
from cnn_pde_tpu.data.pipeline import balance_classes as jax_balance
from cnn_pde_tpu.models import FashionClassifier as JaxFashion
from cnn_pde_tpu.models import MNISTClassifier as JaxMNIST
from cnn_pde_tpu.train import metrics as jax_metrics
from cnn_pde_tpu.train.loop import Trainer as JaxTrainer
from cnn_pde_tpu.utils.config import get_preset as jax_preset
from cnn_pde_tpu_torch.compat import state_dict_from_jax
from cnn_pde_tpu_torch.data import ArrayDataset, balance_classes
from cnn_pde_tpu_torch.data import make_synthetic, synthetic_dataset
from cnn_pde_tpu_torch.models import build_model
from cnn_pde_tpu_torch.presets import PRESETS
from cnn_pde_tpu_torch.train import (GracefulPreemption, TrainConfig,
                                     Trainer, make_train_step)
from cnn_pde_tpu_torch.train import metrics, sinks
from cnn_pde_tpu_torch.train.checkpoint import (load_checkpoint,
                                                restore_state,
                                                save_checkpoint,
                                                save_checkpoint_async,
                                                wait_for_checkpoints)
from cnn_pde_tpu_torch.train.schedules import constant


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six test
    files at once on one host, and eight threads each oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _own_jax_batcher():
    """The JAX package's batcher built into a library of this process's
    own under the checkout's ``build/native/``, from the same source with
    the same flags; the JAX binding's state restored after.  The JAX
    binding builds into one fixed file beside its source
    (``libbatcher.so.tmp``, then renamed): test processes that build it
    at once race on that file, and the one whose rename loses marks the
    library unavailable for the rest of its life."""
    from cnn_pde_tpu.native import binding as jax_binding

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(repo, "build", "native",
                        f"libbatcher-jax-{os.getpid()}.so")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_binding, "_SO", path)
        mp.setattr(jax_binding, "_lib", None)
        mp.setattr(jax_binding, "_build_failed", False)
        yield
    for f in (path, path + ".tmp"):
        if os.path.exists(f):
            os.remove(f)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _datasets(name, train_per_class=8, test_per_class=3):
    """The same synthetic split as the port's and the JAX package's
    ArrayDataset, normalised as the preset's."""
    arrays = make_synthetic(name, train_per_class=train_per_class,
                            test_per_class=test_per_class)
    norm = PRESETS[name]["train"]["augment"]
    kw = ({"mean": norm["mean"], "std": norm["std"]} if "mean" in norm
          else {})
    return ArrayDataset(*arrays, **kw), JaxArrayDataset(*arrays, **kw)


def test_array_dataset_matches_jax():
    ours, theirs = _datasets("fashion_mnist")
    for (a, b), (c, d) in zip(ours.train_batches(16, seed=3),
                              theirs.train_batches(16, seed=3)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    for (a, b), (c, d) in zip(ours.eval_batches(7), theirs.eval_batches(7)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    for split in ("train", "test"):
        for a, b in zip(ours.eval_arrays(split), theirs.eval_arrays(split)):
            np.testing.assert_array_equal(a, b)
    assert ours.steps_for_batch(16) == theirs.steps_for_batch(16) == 5
    labels = np.array([0, 1, 1, 2, 2, 2, 0])
    images = np.arange(7.0)
    for a, b in zip(balance_classes(images, labels),
                    jax_balance(images, labels)):
        np.testing.assert_array_equal(a, b)
    # the native batcher (ported): the JAX native shuffle, each batch of
    # 16 (the remainder dropped)
    native = list(ours.train_batches(16, seed=3, native=True))
    assert len(native) == 5
    for images, labels in native:
        assert images.shape == (16,) + ours.train_images.shape[1:]
        assert images.dtype == np.float32 and labels.dtype == np.int32


def test_synthetic_dataset_is_the_jax_fixture():
    ds = synthetic_dataset("cifar10")
    assert ds.train_images.shape == (200, 3, 32, 32)
    assert ds.test_images.shape == (50, 3, 32, 32)
    assert tuple(ds.mean) == pytest.approx(PRESETS["cifar10_noconv"][
        "train"]["augment"]["mean"])


def _mnist_pair(rng):
    """The JAX mnist classifier (dropout 0) with its fields moved off
    their init, and the port's with the same weights."""
    model = JaxMNIST(dropout_rate=0.0)
    params, state = _np(jax.jit(model.init)(jax.random.PRNGKey(0)))
    for key in ("alpha_base", "beta_base"):
        params["diff"][key] = (params["diff"][key] + 0.2 * rng.standard_normal(
            params["diff"][key].shape)).astype(np.float32)
    port = build_model("mnist", device="cpu", dropout_rate=0.0)
    port.load_state_dict(state_dict_from_jax(params, state, "mnist"),
                         strict=True)
    return model, params, state, port


def test_fit_matches_jax_trainer():
    """Three epochs of the mnist preset (batch 32, no augmentation, dropout
    0) from the same weights: each epoch's mean loss within 1e-4 relative
    and every test accuracy equal."""
    model, params, state, port = _mnist_pair(np.random.default_rng(1))
    ours_ds, theirs_ds = _datasets("mnist")
    ref = jax_preset("mnist")
    jax_trainer = JaxTrainer(model, ref.make_train_config(
        epochs=3, batch_size=32, log_every=10**9), ref.make_schedule(
            theirs_ds.steps_for_batch(32)), augment_fn=None)
    ts = jax_trainer.init_state(jax.random.PRNGKey(0), None,
                                initial=(params, state))
    theirs = jax_trainer.fit(ts, theirs_ds, verbose=False)
    values = dict(PRESETS["mnist"]["train"], augment=None)
    trainer = Trainer(port, TrainConfig.from_preset(
        values, epochs=3, batch_size=32), values)
    state_ = trainer.init_state(ours_ds.steps_for_batch(32))
    ours = trainer.fit(state_, ours_ds, verbose=False)
    assert len(ours["history"]) == len(theirs["history"]) == 3
    for a, b in zip(ours["history"], theirs["history"]):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
        assert a["test_acc"] == b["test_acc"]
    assert ours["best_acc"] == theirs["best_acc"]
    assert state_.step == ts.step == 3 * ours_ds.steps_for_batch(32)


class _Linear(torch.nn.Module):
    """Flatten → Linear(784, 10): no dropout and no BatchNorm, the only
    things that would tell micro-batches from one batch."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(784, 10)

    def forward(self, x):
        return self.fc(x.reshape(x.shape[0], -1))


def test_grad_accum_matches_big_batch():
    """Four micro-batches of 16 with grad_accum=2 against two batches of
    32: the same two updates (the mean of the micro-gradients, clipped,
    then AdamW; the schedule counted in updates), every parameter within
    1e-5."""
    rng = np.random.default_rng(2)
    images = rng.random((32, 1, 28, 28)).astype(np.float32)
    labels = rng.integers(0, 10, 32).astype(np.int64)
    values = dict(PRESETS["mnist"]["train"], augment=None)

    def run(batch, accum, n):
        torch.manual_seed(0)
        model = _Linear()
        counts = []
        step = make_train_step(model, values, 1, torch.Generator(),
                               schedule=lambda u: counts.append(u) or 1e-2,
                               grad_accum=accum)
        for i in range(n):
            lo = (i * batch) % 32
            step(images[lo:lo + batch], labels[lo:lo + batch])
        return model, counts

    big, big_counts = run(32, 1, 2)
    accum, accum_counts = run(16, 2, 4)
    assert big_counts == accum_counts == [0, 1]
    for a, b in zip(accum.parameters(), big.parameters()):
        assert float((a - b).abs().max()) <= 1e-5


def _fashion_trainer(epochs=3):
    """The fashion_mnist preset (augmentation, dropout 0.15, BatchNorm) at
    batch 16, 3 steps an epoch, from a seeded init."""
    values = PRESETS["fashion_mnist"]["train"]
    model = build_model("fashion_mnist", device="cpu",
                        generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, TrainConfig.from_preset(
        values, epochs=epochs, batch_size=16, max_steps_per_epoch=3,
        grad_accum=2), values)
    return trainer, trainer.init_state(3)


def test_kill_and_resume_equals_an_uninterrupted_run(tmp_path, capsys):
    """SIGTERM during epoch 1 (caught by GracefulPreemption) stops fit
    after it with a 'last' checkpoint; a new process's state restored from
    it and fit to the end ends on the uninterrupted run's weights, BatchNorm
    statistics and optimizer state, bit for bit (augmentation and dropout
    draws, gradient accumulation and the schedule included)."""
    ds = synthetic_dataset("fashion_mnist", train_per_class=8,
                           test_per_class=2)
    trainer, state = _fashion_trainer()
    whole = trainer.fit(state, ds, verbose=False)
    reference = {k: v.clone() for k, v in state.model.state_dict().items()}
    reference_opt = state.optimizer.state_dict()

    ckpt = str(tmp_path / "ckpt")
    trainer, state = _fashion_trainer()

    def kill(model, epoch):
        if epoch == 0:
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(0.05)  # the signal lands between bytecodes

    with GracefulPreemption(verbose=False) as preemption:
        first = trainer.fit(state, ds, verbose=True, checkpoint_dir=ckpt,
                            param_stats_fn=kill, preemption=preemption)
    capsys.readouterr()
    assert first["preempted"] and len(first["history"]) == 1
    assert load_checkpoint(ckpt, "last")["step"] == 3

    trainer, state = _fashion_trainer()
    restore_state(state, ckpt, "last")
    second = trainer.fit(state, ds, verbose=False, checkpoint_dir=ckpt)
    assert not second["preempted"] and len(second["history"]) == 2
    assert [r["loss"] for r in first["history"] + second["history"]] == [
        r["loss"] for r in whole["history"]]
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, reference[k]), k
    for a, b in zip(state.optimizer.state_dict()["state"].values(),
                    reference_opt["state"].values()):
        assert all(torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))
                   for k in a)


def test_early_stopping_counts_evals():
    """With nothing to learn (lr 0), an eval every 2 epochs and a patience
    of 2, fit stops after three evals (the first sets the best): 6 of 20
    epochs, as the JAX Trainer does."""
    model, params, state, port = _mnist_pair(np.random.default_rng(3))
    ours_ds, theirs_ds = _datasets("mnist")
    ref = jax_preset("mnist")
    jax_trainer = JaxTrainer(model, ref.make_train_config(
        epochs=20, batch_size=32, eval_every=2, early_stop_patience=2,
        max_steps_per_epoch=1, log_every=10**9), constant(0.0),
        augment_fn=None)
    theirs = jax_trainer.fit(jax_trainer.init_state(
        jax.random.PRNGKey(0), None, initial=(params, state)), theirs_ds,
        verbose=False)
    values = dict(PRESETS["mnist"]["train"], augment=None)
    trainer = Trainer(port, TrainConfig.from_preset(
        values, epochs=20, batch_size=32, eval_every=2, early_stop_patience=2,
        max_steps_per_epoch=1), values, schedule=constant(0.0))
    ours = trainer.fit(trainer.init_state(1), ours_ds, verbose=False)
    assert len(ours["history"]) == len(theirs["history"]) == 6
    assert [("test_acc" in r) for r in ours["history"]] == [False, True] * 3
    assert ours["best_acc"] == theirs["best_acc"] > 0


def test_bn_refresh_matches_jax():
    """refresh_bn_stats on the fashion_mnist classifier from the same
    (stale) weights and statistics: 5 passes of 16 shuffled normalised
    train images, dropout off; every running statistic within 1e-5 of
    max(1, largest entry) of the JAX refreshed state, the parameters
    untouched."""
    rng = np.random.default_rng(4)
    model = JaxFashion()
    params, state = _np(jax.jit(model.init)(jax.random.PRNGKey(0)))
    state = jax.tree_util.tree_map(
        lambda v: (v + 0.5 * np.abs(rng.standard_normal(v.shape))).astype(
            v.dtype), state)
    ours_ds, theirs_ds = _datasets("fashion_mnist")
    ref = jax_preset("fashion_mnist")
    jax_trainer = JaxTrainer(model, ref.make_train_config(batch_size=16),
                             ref.make_schedule(1))
    ts = jax_trainer.init_state(jax.random.PRNGKey(0), None,
                                initial=(params, state))
    jax_trainer.refresh_bn_stats(ts, theirs_ds, batches=5, seed=3)
    expected = state_dict_from_jax(params, _np(ts.model_state),
                                   "fashion_mnist")
    port = build_model("fashion_mnist", device="cpu")
    port.load_state_dict(state_dict_from_jax(params, state, "fashion_mnist"),
                         strict=True)
    before = {n: p.clone() for n, p in port.named_parameters()}
    values = PRESETS["fashion_mnist"]["train"]
    trainer = Trainer(port, TrainConfig.from_preset(values, batch_size=16),
                      values)
    st = trainer.init_state()
    trainer.refresh_bn_stats(st, ours_ds, batches=5, seed=3)
    for name, buf in port.named_buffers():
        if "running" in name:
            ref_buf = expected[name].numpy()
            err = float(np.max(np.abs(buf.numpy() - ref_buf)))
            assert err <= 1e-5 * max(1.0, float(np.max(np.abs(ref_buf)))), \
                name
    assert not port.training
    for n, p in port.named_parameters():
        assert torch.equal(p, before[n]), n
    with pytest.raises(TypeError, match="eval_arrays"):
        trainer.refresh_bn_stats(st, 3)


def test_checkpoints_round_trip(tmp_path):
    """save/load/restore: the model, optimizer, step, train-step counters
    and generator come back; the write is atomic (no temporary file left);
    an async save lands after wait_for_checkpoints and holds the state of
    when it was called; the orbax backend is refused."""
    ds = synthetic_dataset("fashion_mnist", train_per_class=8,
                           test_per_class=1)
    trainer, state = _fashion_trainer(epochs=1)
    trainer.train_epoch(state, ds, 0, verbose=False)
    path = save_checkpoint(str(tmp_path), state, tag="last",
                           extra={"best_acc": 12.5})
    assert sorted(os.listdir(tmp_path)) == ["last.ckpt"]
    snapshot = {k: v.clone() for k, v in state.model.state_dict().items()}
    save_checkpoint_async(str(tmp_path), state, tag="async")
    for p in state.model.parameters():
        p.data.add_(1.0)  # the live weights move on; the save must not
    assert wait_for_checkpoints() == 1
    async_payload = load_checkpoint(str(tmp_path), "async")
    for k, v in snapshot.items():
        assert torch.equal(async_payload["model"][k], v), k
    payload = load_checkpoint(str(tmp_path), "last")
    assert payload["step"] == 3 and payload["extra"] == {"best_acc": 12.5}
    trainer2, state2 = _fashion_trainer(epochs=1)
    restore_state(state2, str(tmp_path), "last")
    assert state2.step == 3
    assert state2.train_step.state_dict()["updates"] == 1
    for k, v in state2.model.state_dict().items():
        assert torch.equal(v, snapshot[k]), k
    assert torch.equal(state2.generator.get_state(),
                       payload["generator"])
    assert path.endswith("last.ckpt")
    with pytest.raises(NotImplementedError, match="orbax"):
        save_checkpoint(str(tmp_path), state, backend="orbax")


def test_unported_trainer_options_raise():
    model = build_model("mnist", device="cpu")
    values = PRESETS["mnist"]["train"]
    # the device epoch is ported; with it the native loader is
    # ignored with the JAX Trainer's warning
    assert Trainer(model, TrainConfig(device_epoch=True),
                   values).config.device_epoch
    with pytest.warns(UserWarning, match="native_loader is ignored"):
        Trainer(model, TrainConfig(device_epoch=True, native_loader=True),
                values)
    # the native loader (ported) feeds the host loop without a warning
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert Trainer(model, TrainConfig(native_loader=True),
                       values).config.native_loader
    # the mesh is ported (tests/test_torch_port_data_parallel.py), and so
    # are tensor and spatial parallelism (test_torch_port_tensor_parallel,
    # test_torch_port_spatial): in a process group (here a world of one)
    # Trainer takes tp= and image_spec=, outside one they raise
    import torch.distributed as dist

    from cnn_pde_tpu_torch.parallel import initialize, make_mesh

    assert Trainer(model, TrainConfig(), values,
                   mesh=make_mesh(device="cpu")).mesh
    for kw in ({"tp": True}, {"image_spec": ("data", None, "spatial", None)}):
        with pytest.raises(ValueError, match="process group"):
            Trainer(model, TrainConfig(), values, **kw)
        with pytest.raises(ValueError, match="process group"):
            Trainer(model, TrainConfig(), values,
                    mesh=make_mesh(device="cpu"), **kw)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize(f"127.0.0.1:{port}", num_processes=1, process_id=0,
               backend="gloo")
    try:
        mesh = make_mesh(device="cpu")
        trainer = Trainer(model, TrainConfig(batch_size=16), values,
                          mesh=mesh, tp=True,
                          image_spec=("data", None, "spatial", None))
        assert trainer.tp and trainer.image_spec == ("data", None,
                                                     "spatial", None)
        state = trainer.init_state()
        assert state.model.tp_layout.mesh is mesh
        with pytest.raises(ValueError, match="image_spec"):
            Trainer(model, TrainConfig(), values, mesh=mesh,
                    image_spec=(None, "data"))
    finally:
        dist.destroy_process_group()


def test_graceful_preemption_latches_and_restores():
    prev = signal.getsignal(signal.SIGTERM)
    with GracefulPreemption(verbose=False) as gp:
        assert not gp.requested
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):  # delivery happens between bytecodes
            if gp.requested:
                break
            time.sleep(0.01)
        assert gp.requested
    assert signal.getsignal(signal.SIGTERM) is prev


def test_sinks_write_records(tmp_path):
    records = [{"epoch": 1, "loss": np.float32(0.5), "acc": 50.0,
                "time": 1.0, "chunk": 1, "skip": object()},
               {"epoch": 2, "loss": torch.tensor(0.25), "acc": 75.0,
                "test_acc": 70.0, "time": 1.0, "chunk": 1}]
    with sinks.sink_from_path(tmp_path / "m.jsonl") as jsonl, \
            sinks.sink_from_path(tmp_path / "m.csv") as csv_sink:
        for rec in records:
            sinks.MultiSink(jsonl, csv_sink).log(rec)
    lines = [json.loads(s) for s in
             (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["loss"] for r in lines] == [0.5, 0.25]
    assert "skip" not in lines[0] and "wall_time" in lines[0]
    rows = (tmp_path / "m.csv").read_text().splitlines()
    assert rows[0].startswith("epoch,loss,acc,test_acc,time,chunk")
    assert len(rows) == 3
    with pytest.raises(ValueError, match="extension"):
        sinks.sink_from_path(tmp_path / "m.txt")


def test_metrics_match_jax():
    rng = np.random.default_rng(5)
    labels, preds = rng.integers(0, 4, 50), rng.integers(0, 4, 50)
    np.testing.assert_array_equal(metrics.confusion_matrix(labels, preds, 4),
                                  jax_metrics.confusion_matrix(labels,
                                                               preds, 4))
    np.testing.assert_allclose(metrics.per_class_accuracy(labels, preds, 4),
                               jax_metrics.per_class_accuracy(labels, preds,
                                                              4))
    assert metrics.classification_report(labels, preds, 4) == \
        jax_metrics.classification_report(labels, preds, 4)
    assert "macro avg" in metrics.format_report(
        metrics.classification_report(labels, preds, 4))
