"""Real-dataset loaders — the port's copy of ``cnn_pde_tpu/data/real.py``
(numpy only; ``scipy.io.loadmat`` and ``PIL.Image`` imported inside the
readers that need them), with the same synthetic fallback when the files
are absent.

Layouts under ``data_dir`` (torchvision's):
  MNIST / FashionMNIST   <ds>/raw/{train,t10k}-{images,labels}-idx*-ubyte[.gz]
  CIFAR-10               cifar-10-batches-py/{data_batch_1..5, test_batch}
  SVHN                   {train,test}_32x32.mat
  Emotion (FER)          images/{train,validation}/<class>/*.{png,jpg}
  Tiny-ImageNet          tiny-imagenet-200/{train/<cls>/images/*.JPEG,
                                            val/{images,val_annotations.txt}}

Images come back as float32 NCHW in [0, 1] and labels as int32: the same
arrays as the JAX package's loaders for the same files.  ``data/fetch.py``
downloads them into these layouts.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as np

from .pipeline import ArrayDataset, balance_classes
from .synthetic import make_synthetic

__all__ = ["load_dataset", "NORMALIZATION"]

# torchvision normalisation constants (mean, std) of the reference scripts;
# the MNIST and emotion scripts apply none (ToTensor only)
NORMALIZATION = {
    "mnist": (None, None),
    "fashion_mnist": ((0.2860,), (0.3530,)),
    "svhn": ((0.4377, 0.4438, 0.4728), (0.1980, 0.2010, 0.1970)),
    "cifar10": ((0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)),
    "emotion": (None, None),
    "tiny_imagenet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
}


def _open_maybe_gz(path):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    return open(path, "rb")


def _read_idx(path, magic_expected, header):
    with _open_maybe_gz(path) as f:
        fields = struct.unpack(">" + "I" * header, f.read(4 * header))
        if fields[0] != magic_expected:
            raise ValueError(f"{path}: idx magic {fields[0]}, expected "
                             f"{magic_expected}")
        return fields[1:], np.frombuffer(f.read(), dtype=np.uint8)


def _read_idx_images(path):
    (n, rows, cols), data = _read_idx(path, 2051, 4)
    return data.reshape(n, 1, rows, cols).astype(np.float32) / 255.0


def _read_idx_labels(path):
    _, data = _read_idx(path, 2049, 2)
    return data.astype(np.int32)


def _load_mnist_like(data_dir, subdir):
    raw = os.path.join(data_dir, subdir, "raw")
    xs = _read_idx_images(os.path.join(raw, "train-images-idx3-ubyte"))
    ys = _read_idx_labels(os.path.join(raw, "train-labels-idx1-ubyte"))
    xt = _read_idx_images(os.path.join(raw, "t10k-images-idx3-ubyte"))
    yt = _read_idx_labels(os.path.join(raw, "t10k-labels-idx1-ubyte"))
    return xs, ys, xt, yt


def _load_cifar10(data_dir):
    base = os.path.join(data_dir, "cifar-10-batches-py")

    def read(name):
        with open(os.path.join(base, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        return d[b"data"], d[b"labels"]

    def fmt(x):
        return (np.asarray(x, np.uint8).reshape(-1, 3, 32, 32)
                .astype(np.float32) / 255.0)

    batches = [read(f"data_batch_{i}") for i in range(1, 6)]
    xt, yt = read("test_batch")
    return (fmt(np.concatenate([x for x, _ in batches])),
            np.concatenate([y for _, y in batches]).astype(np.int32),
            fmt(xt), np.asarray(yt, np.int32))


def _load_svhn(data_dir):
    from scipy.io import loadmat

    def load(split):
        m = loadmat(os.path.join(data_dir, f"{split}_32x32.mat"))
        x = m["X"].transpose(3, 2, 0, 1).astype(np.float32) / 255.0
        y = m["y"].reshape(-1).astype(np.int32)
        y[y == 10] = 0  # torchvision's SVHN labels digit 0 as 0, not 10
        return x, y

    xs, ys = load("train")
    xt, yt = load("test")
    return xs, ys, xt, yt


_EMOTIONS = ["angry", "disgust", "fear", "happy", "sad", "surprise", "neutral"]


def _load_image_folder(root, class_names, size, grayscale):
    from PIL import Image

    images, labels = [], []
    for ci, cname in enumerate(class_names):
        cdir = os.path.join(root, cname)
        if not os.path.isdir(cdir):
            continue
        for fname in sorted(os.listdir(cdir)):
            if not fname.lower().endswith((".png", ".jpg", ".jpeg")):
                continue
            img = Image.open(os.path.join(cdir, fname))
            img = img.convert("L" if grayscale else "RGB")
            if img.size != (size, size):
                img = img.resize((size, size))
            arr = np.asarray(img, np.float32) / 255.0
            images.append(arr[None] if grayscale else arr.transpose(2, 0, 1))
            labels.append(ci)
    return ((np.stack(images) if images else np.empty((0,))),
            np.asarray(labels, np.int32))


def _load_emotion(data_dir):
    """The emotion folders; without validation images, an 80/20 split of
    the train set by a seed-0 permutation (the reference's random_split,
    emotion_recognition.py:304-311, made deterministic)."""
    base = os.path.join(data_dir, "images")
    xs, ys = _load_image_folder(os.path.join(base, "train"), _EMOTIONS, 48,
                                True)
    xt, yt = _load_image_folder(os.path.join(base, "validation"), _EMOTIONS,
                                48, True)
    if len(yt) == 0 and len(ys) > 0:
        perm = np.random.default_rng(0).permutation(len(ys))
        n_train = int(0.8 * len(ys))
        tr, te = perm[:n_train], perm[n_train:]
        xs, ys, xt, yt = xs[tr], ys[tr], xs[te], ys[te]
    return xs, ys, xt, yt


def _tiny_fallback_image(idx, class_idx):
    """The reference's stand-in for an unreadable Tiny-ImageNet file
    (tiny_imagenet.py:497-504): a class colour plus seeded noise."""
    base = np.array([class_idx % 3, (class_idx // 3) % 3,
                     (class_idx // 9) % 3]) * 85
    noise = np.random.RandomState(idx).randint(-20, 20, (64, 64, 3))
    arr = np.clip(base.reshape(1, 1, 3) + noise, 0, 255).astype(np.uint8)
    return arr.astype(np.float32).transpose(2, 0, 1) / 255.0


def _load_tiny_imagenet(data_dir):
    from PIL import Image

    def read(path, idx, class_idx):
        try:
            img = Image.open(path).convert("RGB")
            if img.size != (64, 64):
                img = img.resize((64, 64))
            return np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
        except Exception:  # a corrupt file: the reference's stand-in
            return _tiny_fallback_image(idx, class_idx)

    base = os.path.join(data_dir, "tiny-imagenet-200")
    train_dir = os.path.join(base, "train")
    class_dirs = sorted(os.listdir(train_dir))
    class_to_idx = {c: i for i, c in enumerate(class_dirs)}
    xs, ys = [], []
    for cname in class_dirs:
        images_dir = os.path.join(train_dir, cname, "images")
        if not os.path.isdir(images_dir):
            continue
        for fname in sorted(os.listdir(images_dir)):
            if fname.endswith(".JPEG"):
                ci = class_to_idx[cname]
                xs.append(read(os.path.join(images_dir, fname), len(xs), ci))
                ys.append(ci)
    val_dir = os.path.join(base, "val")
    xt, yt = [], []
    ann = os.path.join(val_dir, "val_annotations.txt")
    if os.path.exists(ann):
        with open(ann) as f:
            for line in f:
                parts = line.strip().split("\t")
                img_path = os.path.join(val_dir, "images", parts[0])
                if os.path.exists(img_path) and parts[1] in class_to_idx:
                    ci = class_to_idx[parts[1]]
                    xt.append(read(img_path, len(xt), ci))
                    yt.append(ci)
    return (np.stack(xs), np.asarray(ys, np.int32),
            np.stack(xt), np.asarray(yt, np.int32))


_LOADERS = {
    "mnist": lambda d: _load_mnist_like(d, "MNIST"),
    "fashion_mnist": lambda d: _load_mnist_like(d, "FashionMNIST"),
    "cifar10": _load_cifar10,
    "svhn": _load_svhn,
    "emotion": _load_emotion,
    "tiny_imagenet": _load_tiny_imagenet,
}

# the file or directory whose presence selects the real loader
_PRESENCE = {
    "mnist": "MNIST/raw",
    "fashion_mnist": "FashionMNIST/raw",
    "cifar10": "cifar-10-batches-py",
    "svhn": "train_32x32.mat",
    "emotion": "images/train",
    "tiny_imagenet": "tiny-imagenet-200/train",
}


def load_dataset(name, data_dir="./data", *, synthetic_ok=True,
                 synthetic_train_per_class=20, synthetic_test_per_class=5,
                 balance=False):
    """An ``ArrayDataset`` of ``name`` read from ``data_dir``, or, when its
    files are absent and ``synthetic_ok``, the synthetic fixture
    (``ds.source`` says which: "real" or "synthetic").  ``balance`` cuts
    every training class to the smallest one's size (the emotion dataset's
    option, emotion_recognition.py:101,131-150)."""
    mean, std = NORMALIZATION[name]
    if os.path.exists(os.path.join(data_dir, _PRESENCE[name])):
        xs, ys, xt, yt = _LOADERS[name](data_dir)
        source = "real"
    elif synthetic_ok:
        xs, ys, xt, yt = make_synthetic(
            name, train_per_class=synthetic_train_per_class,
            test_per_class=synthetic_test_per_class)
        source = "synthetic"
    else:
        raise FileNotFoundError(f"{name} not found under {data_dir}")
    if balance:
        xs, ys = balance_classes(xs, ys)
    ds = ArrayDataset(xs, ys, xt, yt, mean=mean, std=std)
    ds.source = source
    return ds
