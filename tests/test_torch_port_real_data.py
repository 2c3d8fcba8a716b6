"""The port's real-data loaders (``cnn_pde_tpu_torch/data/real.py``)
against ``cnn_pde_tpu.data.real.load_dataset`` on the CPU: fixtures that
the tests write in each on-disk format (MNIST idx, Fashion-MNIST idx.gz,
the CIFAR-10 pickles, SVHN's .mat files, the emotion image folders with
and without a validation split, the Tiny-ImageNet tree with a corrupt
file), ``balance=True``, the synthetic fallback and the missing-data
refusal; then the train CLI with ``--data-dir`` on a CIFAR-10 fixture.

Tolerance: none.  The arrays, the normalisation and ``source`` equal the
JAX package's bit for bit (the same numpy reads of the same files).
"""

import gzip
import json
import pickle
import struct

import numpy as np
import pytest
import torch

from cnn_pde_tpu.data import write_synthetic_tiny_imagenet
from cnn_pde_tpu.data.real import NORMALIZATION as JAX_NORMALIZATION
from cnn_pde_tpu.data.real import load_dataset as jax_load_dataset
from cnn_pde_tpu_torch.data import NORMALIZATION, load_dataset
from cnn_pde_tpu_torch.presets import NORMALIZATION as PRESET_NORMALIZATION
from cnn_pde_tpu_torch.train.__main__ import main as train_main


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six test
    files at once on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write_idx(root, subdir, gz, n_train=12, n_test=5):
    raw = root / subdir / "raw"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(1)
    opener, suffix = (gzip.open, ".gz") if gz else (open, "")

    def write(name, header, arr):
        with opener(raw / (name + suffix), "wb") as f:
            f.write(struct.pack(">" + "I" * len(header), *header))
            f.write(arr.tobytes())

    for split, n in (("train", n_train), ("t10k", n_test)):
        images = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
        write(f"{split}-images-idx3-ubyte", (2051, n, 28, 28), images)
        write(f"{split}-labels-idx1-ubyte", (2049, n),
              rng.integers(0, 10, n).astype(np.uint8))


def _write_cifar10(root, per_batch=3, n_test=4):
    base = root / "cifar-10-batches-py"
    base.mkdir(parents=True)
    rng = np.random.default_rng(2)
    for name, n in [(f"data_batch_{i}", per_batch) for i in range(1, 6)] \
            + [("test_batch", n_test)]:
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072),
                                               dtype=np.uint8),
                         b"labels": [int(v) for v in
                                     rng.integers(0, 10, n)]}, f)


def _write_svhn(root, n_train=6, n_test=4):
    from scipy.io import savemat

    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(3)
    for split, n in (("train", n_train), ("test", n_test)):
        # labels 1..10, 10 standing for the digit 0
        savemat(root / f"{split}_32x32.mat",
                {"X": rng.integers(0, 256, (32, 32, 3, n), dtype=np.uint8),
                 "y": rng.integers(1, 11, (n, 1)).astype(np.uint8)})


def _write_emotion(root, validation=True):
    """Unbalanced classes (angry 4, happy 2, sad 3 training images), some
    not 48 x 48 (resized on load) and one RGB (converted)."""
    from PIL import Image

    rng = np.random.default_rng(4)
    splits = {"train": {"angry": 4, "happy": 2, "sad": 3}}
    if validation:
        splits["validation"] = {"angry": 1, "sad": 2}
    for split, classes in splits.items():
        for cname, n in classes.items():
            cdir = root / "images" / split / cname
            cdir.mkdir(parents=True)
            for j in range(n):
                if j == 1:
                    img = Image.fromarray(rng.integers(
                        0, 256, (50, 46, 3), dtype=np.uint8), mode="RGB")
                else:
                    img = Image.fromarray(rng.integers(
                        0, 256, (48, 48), dtype=np.uint8), mode="L")
                img.save(cdir / f"{j}.png")
            (cdir / "notes.txt").write_text("not an image")


def _write_tiny(root):
    base = write_synthetic_tiny_imagenet(str(root), num_classes=3,
                                         train_per_class=2, val_total=4)
    # a corrupt file takes the reference's seeded stand-in
    (root / "tiny-imagenet-200" / "train" / "n00000001" / "images"
     / "n00000001_1.JPEG").write_bytes(b"not a jpeg")
    return base


CASES = {
    "mnist": lambda root: _write_idx(root, "MNIST", gz=False),
    "fashion_mnist": lambda root: _write_idx(root, "FashionMNIST", gz=True),
    "cifar10": _write_cifar10,
    "svhn": _write_svhn,
    "emotion": _write_emotion,
    "emotion_no_validation": lambda root: _write_emotion(root, False),
    "tiny_imagenet": _write_tiny,
}


def _assert_same(ours, theirs):
    for key in ("train_images", "train_labels", "test_images",
                "test_labels"):
        a, b = getattr(ours, key), getattr(theirs, key)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    for key in ("mean", "std"):
        a, b = getattr(ours, key), getattr(theirs, key)
        assert (a is None) == (b is None), key
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=key)
    assert ours.source == theirs.source
    assert ours.num_classes == theirs.num_classes


def test_normalization_is_the_jax_tables():
    assert NORMALIZATION == JAX_NORMALIZATION
    assert PRESET_NORMALIZATION is NORMALIZATION


@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_matches_jax(case, tmp_path):
    name = case.split("_no_")[0]
    CASES[case](tmp_path)
    ours = load_dataset(name, str(tmp_path), synthetic_ok=False)
    theirs = jax_load_dataset(name, str(tmp_path), synthetic_ok=False)
    assert ours.source == "real"
    assert ours.train_images.shape[0] > 0 and ours.test_images.shape[0] > 0
    _assert_same(ours, theirs)
    if name == "svhn":
        assert ours.train_labels.max() <= 9
    if case == "emotion":
        balanced = load_dataset(name, str(tmp_path), balance=True)
        _assert_same(balanced, jax_load_dataset(name, str(tmp_path),
                                                balance=True))
        assert np.bincount(balanced.train_labels).tolist() == [2, 0, 0, 2,
                                                               2]


@pytest.mark.parametrize("name", sorted(NORMALIZATION))
def test_synthetic_fallback_matches_jax(name, tmp_path):
    kw = dict(synthetic_train_per_class=2, synthetic_test_per_class=1)
    ours = load_dataset(name, str(tmp_path), **kw)
    assert ours.source == "synthetic"
    _assert_same(ours, jax_load_dataset(name, str(tmp_path), **kw))
    with pytest.raises(FileNotFoundError, match=name):
        load_dataset(name, str(tmp_path), synthetic_ok=False)


def test_train_cli_reads_data_dir(tmp_path, capsys):
    """The train CLI without --synthetic reads the CIFAR-10 pickles under
    --data-dir (20 training images: 2 steps of 8), and falls back to the
    synthetic set where the directory holds none."""
    _write_cifar10(tmp_path / "data", per_batch=4)
    common = ["--preset", "cifar10_noconv", "--epochs", "1", "--batch-size",
              "8", "--device", "cpu", "--no-preemption-handler"]
    train_main(common + ["--data-dir", str(tmp_path / "data")])
    out = capsys.readouterr().out
    assert "Dataset: cifar10 (real), train (20, 3, 32, 32)" in out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["data"] == "real" and summary["steps"] == 2
    assert np.isfinite(summary["last_loss"])
    train_main(common + ["--data-dir", str(tmp_path / "none"), "--steps",
                         "1", "--quiet"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["data"] == "synthetic" and summary["steps"] == 1
