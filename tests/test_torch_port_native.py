"""The port's native batcher (``cnn_pde_tpu_torch/native/``) against the JAX
package's ``NativeBatcher`` on the CPU: the same batches bit for bit for
the same seed, each epoch covered once, ``ArrayDataset(native=True)`` and
``Trainer(native_loader=True)`` on it, its build under the checkout's
``build/native/`` (never next to a source), and a raise, not a fallback,
when it cannot be built."""

import os

import numpy as np
import pytest
import torch

from cnn_pde_tpu.data.pipeline import ArrayDataset as JaxArrayDataset
from cnn_pde_tpu.native import NativeBatcher as JaxNativeBatcher
from cnn_pde_tpu_torch.data import ArrayDataset, make_synthetic
from cnn_pde_tpu_torch.models import build_model
from cnn_pde_tpu_torch.native import NativeBatcher, binding
from cnn_pde_tpu_torch.presets import PRESETS
from cnn_pde_tpu_torch.train import TrainConfig, Trainer


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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _own_jax_batcher():
    """The JAX package's batcher built into a library of this process's
    own under the checkout's ``build/native/``, from the same source with
    the same flags; the JAX binding's state restored after.  The JAX
    binding builds into one fixed file beside its source
    (``libbatcher.so.tmp``, then renamed): test processes that build it
    at once race on that file, and the one whose rename loses marks the
    library unavailable for the rest of its life."""
    from cnn_pde_tpu.native import binding as jax_binding

    path = os.path.join(REPO, "build", "native",
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


def _arrays(n=101, shape=(1, 6, 5), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n,) + shape).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


@pytest.mark.parametrize("batch,seed", [(8, 0), (16, 3), (7, 41), (101, 2)])
def test_batches_equal_jax_bit_for_bit(batch, seed):
    images, labels = _arrays()
    ours = list(NativeBatcher(images, labels, batch, seed=seed))
    theirs = list(JaxNativeBatcher(images, labels, batch, seed=seed))
    assert len(ours) == len(theirs) == 101 // batch
    for (a, b), (c, d) in zip(ours, theirs):
        assert a.dtype == np.float32 and b.dtype == np.int32
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_each_epoch_covers_the_split_once():
    n, batch = 96, 12
    images = np.arange(n, dtype=np.float32).reshape(n, 1, 1, 1)
    labels = np.arange(n, dtype=np.int32)
    orders = []
    for seed in (0, 1):
        seen = np.concatenate([lab for _, lab in
                               NativeBatcher(images, labels, batch, seed)])
        assert sorted(seen.tolist()) == list(range(n))  # no duplicate
        for imgs, lab in NativeBatcher(images, labels, batch, seed):
            np.testing.assert_array_equal(imgs[:, 0, 0, 0], lab)
        orders.append(seen)
    assert not np.array_equal(orders[0], orders[1])  # a new shuffle a seed
    # the remainder is dropped
    assert len(list(NativeBatcher(images, labels, 40))) == 2


def test_array_dataset_native_matches_jax():
    arrays = make_synthetic("mnist", train_per_class=8, test_per_class=2)
    ours, theirs = ArrayDataset(*arrays), JaxArrayDataset(*arrays)
    pairs = list(zip(ours.train_batches(16, seed=5, native=True),
                     theirs.train_batches(16, seed=5, native=True)))
    assert len(pairs) == 5
    for (a, b), (c, d) in pairs:
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    # not the numpy path's permutation
    first = next(ours.train_batches(16, seed=5))[1]
    assert not np.array_equal(first, pairs[0][0][1])


def test_trainer_native_loader_feeds_the_host_loop():
    """An epoch with ``native_loader=True`` ends on the weights of the same
    train step fed the native batcher's batches by hand."""
    ds = ArrayDataset(*make_synthetic("mnist", train_per_class=5,
                                      test_per_class=1))
    values = PRESETS["mnist"]["train"]
    runs = []
    for native in (True, False):
        model = build_model("mnist", device="cpu",
                            generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, TrainConfig(batch_size=16, seed=2,
                                             native_loader=native,
                                             log_every=10**9), values)
        state = trainer.init_state(3)
        if native:
            rec = trainer.train_epoch(state, ds, 1, verbose=False)
        else:
            losses = [float(state.train_step(x, y)[0]) for x, y in
                      NativeBatcher(ds.train_images, ds.train_labels, 16,
                                    seed=3)]
            rec = {"loss": float(np.mean(losses, dtype=np.float64))}
        runs.append((rec["loss"], model.state_dict()))
    assert runs[0][0] == pytest.approx(runs[1][0], abs=1e-7)
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


def test_build_lands_under_build_native_only():
    jax_native = os.path.join(REPO, "cnn_pde_tpu", "native")
    before = sorted(os.listdir(jax_native))
    so = binding.build()
    assert so.parent == binding.BUILD_DIR
    assert str(so).startswith(os.path.join(REPO, "build", "native") + os.sep)
    assert so.exists() and binding.native_available()
    assert sorted(os.listdir(jax_native)) == before
    assert not any(f.endswith(".so") for f in os.listdir(
        os.path.dirname(binding.SRC)))


def test_a_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(binding, "COMPILER", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(binding, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(binding, "_lib", None)
    images, labels = _arrays()
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        NativeBatcher(images, labels, 8)
    ds = ArrayDataset(images, labels, images, labels)
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        next(ds.train_batches(8, native=True))
    assert not binding.native_available()
    # a compiler that fails raises with its output
    bad = tmp_path / "bad-cxx"
    bad.write_text("#!/bin/sh\necho 'cannot compile' >&2\nexit 1\n")
    bad.chmod(0o755)
    monkeypatch.setattr(binding, "COMPILER", str(bad))
    with pytest.raises(RuntimeError, match="cannot compile"):
        NativeBatcher(images, labels, 8)
    assert not list((tmp_path / "native").glob("*.so"))
