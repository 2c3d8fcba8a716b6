"""The port's dataset acquisition (``cnn_pde_tpu_torch/data/fetch.py``) and
on-disk Tiny-ImageNet writer (``data/synthetic.py::
write_synthetic_tiny_imagenet``) against the JAX package's on the CPU.

``fetch`` downloads from a loopback ``http.server`` on 127.0.0.1 that
serves format-exact fixture archives (as ``tests/test_fetch_loopback.py``
does for the JAX module), through the unpatched urllib and tar/zip code,
into the layouts the port's ``load_dataset`` reads, which must give the
JAX loader's arrays.  No test downloads anything from outside.
"""

import gzip
import http.server
import io
import os
import pickle
import socket
import struct
import tarfile
import threading
import zipfile
from functools import partial

import numpy as np
import pytest
import torch

from cnn_pde_tpu.data import fetch as JF
from cnn_pde_tpu.data.real import load_dataset as jax_load_dataset
from cnn_pde_tpu.data.synthetic import \
    write_synthetic_tiny_imagenet as jax_write_tiny
from cnn_pde_tpu_torch.data import fetch as F
from cnn_pde_tpu_torch.data import load_dataset, write_synthetic_tiny_imagenet
from cnn_pde_tpu_torch.models import build_model
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


def _idx_images(arr):
    return struct.pack(">IIII", 2051, *arr.shape) + arr.tobytes()


def _idx_labels(arr):
    return struct.pack(">II", 2049, arr.shape[0]) + arr.tobytes()


def _build_webroot(tmp_path):
    """Format-exact fixture archives, named as each LAYOUTS url's basename."""
    web = tmp_path / "web"
    web.mkdir()
    g = np.random.default_rng(0)
    xs = (g.random((10, 28, 28)) * 255).astype(np.uint8)
    ys = g.integers(0, 10, 10).astype(np.uint8)
    for name, payload in [
            ("train-images-idx3-ubyte.gz", _idx_images(xs)),
            ("train-labels-idx1-ubyte.gz", _idx_labels(ys)),
            ("t10k-images-idx3-ubyte.gz", _idx_images(xs[:4])),
            ("t10k-labels-idx1-ubyte.gz", _idx_labels(ys[:4]))]:
        (web / name).write_bytes(gzip.compress(payload))
    with tarfile.open(web / "cifar-10-python.tar.gz", "w:gz") as tf:
        for name, n, seed in ([(f"data_batch_{i}", 4, i) for i in range(1, 6)]
                              + [("test_batch", 6, 99)]):
            gg = np.random.default_rng(seed)
            blob = pickle.dumps({
                b"data": (gg.random((n, 3072)) * 255).astype(np.uint8),
                b"labels": [int(v) for v in gg.integers(0, 10, n)]})
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    from scipy.io import savemat

    for split, n, seed in (("train", 8, 0), ("test", 5, 1)):
        gg = np.random.default_rng(seed)
        savemat(web / f"{split}_32x32.mat", {
            "X": (gg.random((32, 32, 3, n)) * 255).astype(np.uint8),
            "y": gg.integers(1, 11, (n, 1)).astype(np.uint8)})
    stage = tmp_path / "stage"
    write_synthetic_tiny_imagenet(str(stage), num_classes=3,
                                  train_per_class=2, val_total=3)
    with zipfile.ZipFile(web / "tiny-imagenet-200.zip", "w") as zf:
        for p in sorted((stage / "tiny-imagenet-200").rglob("*")):
            if p.is_file():
                zf.write(p, p.relative_to(stage))
    return web


@pytest.fixture
def loopback(tmp_path, monkeypatch):
    """The fixture webroot on 127.0.0.1:<ephemeral>, every LAYOUTS url of
    the port's module rewritten to it; the download and extraction code
    stay unpatched."""
    web = _build_webroot(tmp_path)

    class _QuietHandler(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *args):
            pass

    srv = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), partial(_QuietHandler, directory=str(web)))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    layouts = {
        name: (layout,
               [(f"http://127.0.0.1:{port}/{url.rsplit('/', 1)[1]}", rel)
                for url, rel in urls],
               kind)
        for name, (layout, urls, kind) in F.LAYOUTS.items()}
    monkeypatch.setattr(F, "LAYOUTS", layouts)
    yield tmp_path / "data"
    srv.shutdown()


@pytest.mark.parametrize("name,train_shape", [
    ("mnist", (10, 1, 28, 28)),
    ("cifar10", (20, 3, 32, 32)),
    ("svhn", (8, 3, 32, 32)),
    ("tiny_imagenet", (6, 3, 64, 64)),
])
def test_fetch_loopback_lands_a_loadable_layout(loopback, name, train_shape):
    """The download (and the tar or zip extraction) lands the layout the
    port's ``load_dataset`` reads, the JAX loader's arrays."""
    assert F.fetch(name, str(loopback)) == "downloaded"
    ds = load_dataset(name, str(loopback))
    assert ds.source == "real"
    assert ds.train_images.shape == train_shape
    ref = jax_load_dataset(name, str(loopback))
    for a, b in ((ds.train_images, ref.train_images),
                 (ds.train_labels, ref.train_labels),
                 (ds.test_images, ref.test_images),
                 (ds.test_labels, ref.test_labels)):
        np.testing.assert_array_equal(a, b)
    # a second fetch sees the on-disk marker
    assert F.fetch(name, str(loopback)) == "present"


def test_fetched_mnist_trains(loopback):
    assert F.fetch("mnist", str(loopback)) == "downloaded"
    ds = load_dataset("mnist", str(loopback))
    model = build_model("mnist", device="cpu",
                        generator=torch.Generator().manual_seed(0))
    values = PRESETS["mnist"]["train"]
    trainer = Trainer(model, TrainConfig(batch_size=4, epochs=1), values)
    out = trainer.fit(trainer.init_state(2), ds, verbose=False)
    assert np.isfinite(out["history"][-1]["loss"])


def test_fetch_unavailable_prints_the_layout(tmp_path, monkeypatch, capsys):
    # emotion has no direct URL
    assert F.fetch("emotion", str(tmp_path)) == "unavailable"
    assert "images/{train,validation}" in capsys.readouterr().out
    # a server that refuses (a closed local port): the layout, exit clean
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    layout, urls, kind = F.LAYOUTS["svhn"]
    monkeypatch.setitem(F.LAYOUTS, "svhn", (layout, [
        (f"http://127.0.0.1:{port}/train_32x32.mat", "train_32x32.mat")],
        kind))
    assert F.fetch("svhn", str(tmp_path), timeout=5) == "unavailable"
    out = capsys.readouterr().out
    assert "download failed" in out and "--synthetic" in out


def test_layout_flag_prints_the_jax_layouts(capsys):
    assert F.LAYOUTS == JF.LAYOUTS
    assert F.main(["--layout"]) == 0
    ours = capsys.readouterr().out
    assert JF.main(["--layout"]) == 0
    assert ours == capsys.readouterr().out
    assert "tiny-imagenet-200/" in ours
    assert F.main(["--layout", "mnist", "--data-dir", "/x"]) == 0
    assert capsys.readouterr().out.startswith("mnist:\n  /x/MNIST/raw/")
    with pytest.raises(SystemExit):
        F.main(["no_such_dataset"])


def test_write_synthetic_tiny_imagenet_matches_jax(tmp_path):
    """The same files, names, annotation lines and pixels as JAX's."""
    ours = write_synthetic_tiny_imagenet(str(tmp_path / "a"), num_classes=4,
                                         train_per_class=3, val_total=6)
    theirs = jax_write_tiny(str(tmp_path / "b"), num_classes=4,
                            train_per_class=3, val_total=6)
    assert os.path.basename(ours) == "tiny-imagenet-200"

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(ours) == files(theirs)
    assert len(files(ours)) == 4 * 3 + 6 + 1
    for rel in files(ours):
        with open(os.path.join(ours, rel), "rb") as a, \
                open(os.path.join(theirs, rel), "rb") as b:
            assert a.read() == b.read(), rel
    lines = open(os.path.join(ours, "val",
                              "val_annotations.txt")).read().splitlines()
    assert lines[5] == "val_5.JPEG\tn00000001\t0\t0\t64\t64"
    ds = load_dataset("tiny_imagenet", str(tmp_path / "a"))
    assert ds.train_images.shape == (12, 3, 64, 64)
    assert ds.test_images.shape == (6, 3, 64, 64)
