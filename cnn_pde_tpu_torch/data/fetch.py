"""Dataset acquisition — port of ``cnn_pde_tpu/data/fetch.py``.

The port's loaders (``data/real.py``) read pre-placed files in
torchvision's layouts; this module puts them there for users with network
access:

    python -m cnn_pde_tpu_torch.data.fetch mnist [--data-dir ./data]
    python -m cnn_pde_tpu_torch.data.fetch --all
    python -m cnn_pde_tpu_torch.data.fetch --layout   # print layouts only

Each dataset downloads from the public source torchvision uses and lands in
the on-disk layout ``load_dataset`` reads.  Without network (or for
emotion, a Kaggle dataset with no direct URL) the command prints the
expected layout and manual instructions and exits 0; every preset also
runs on the deterministic synthetic fixture (``--synthetic``) without any
files.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tarfile
import zipfile

from .real import _PRESENCE

__all__ = ["fetch", "LAYOUTS", "main"]

_MNIST_FILES = ["train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz",
                "t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"]

# name -> (human layout description, [(url, relative target)], archive kind)
LAYOUTS = {
    "mnist": (
        "MNIST/raw/{train,t10k}-{images,labels}-idx*-ubyte[.gz]  "
        "(idx format, gzip ok)",
        [("https://ossci-datasets.s3.amazonaws.com/mnist/" + f,
          os.path.join("MNIST", "raw", f)) for f in _MNIST_FILES],
        "none",
    ),
    "fashion_mnist": (
        "FashionMNIST/raw/{train,t10k}-{images,labels}-idx*-ubyte[.gz]",
        [("http://fashion-mnist.s3-website.eu-central-1.amazonaws.com/" + f,
          os.path.join("FashionMNIST", "raw", f)) for f in _MNIST_FILES],
        "none",
    ),
    "cifar10": (
        "cifar-10-batches-py/{data_batch_1..5, test_batch}  "
        "(python pickles from cifar-10-python.tar.gz)",
        [("https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz",
          "cifar-10-python.tar.gz")],
        "tar",
    ),
    "svhn": (
        "{train,test}_32x32.mat  (cropped-digits .mat, labels 1..10)",
        [("http://ufldl.stanford.edu/housenumbers/train_32x32.mat",
          "train_32x32.mat"),
         ("http://ufldl.stanford.edu/housenumbers/test_32x32.mat",
          "test_32x32.mat")],
        "none",
    ),
    "emotion": (
        "images/{train,validation}/<emotion>/*.png  (FER-2013 folders; "
        "emotions: angry disgust fear happy sad surprise neutral).  "
        "Kaggle-hosted — no direct URL; with kaggle credentials run:\n"
        "    import kagglehub  # the reference's own recipe, "
        "emotion_recognition.py:418\n"
        "    path = kagglehub.dataset_download('msambare/fer2013')\n"
        "then copy/symlink <path>/train -> <data-dir>/images/train and "
        "<path>/test -> <data-dir>/images/validation",
        [],
        "none",
    ),
    "tiny_imagenet": (
        "tiny-imagenet-200/{train/<cls>/images/*.JPEG, "
        "val/{images/*.JPEG, val_annotations.txt}}",
        [("http://cs231n.stanford.edu/tiny-imagenet-200.zip",
          "tiny-imagenet-200.zip")],
        "zip",
    ),
}


def _download(url, dest, timeout=30.0):
    """urllib fetch to a temp file then atomic rename; raises on failure."""
    import urllib.request

    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    tmp = dest + ".part"
    with urllib.request.urlopen(url, timeout=timeout) as r, \
            open(tmp, "wb") as f:
        shutil.copyfileobj(r, f)
    os.replace(tmp, dest)


def fetch(name, data_dir="./data", timeout=30.0):
    """Ensure ``name`` is on disk under ``data_dir`` in the layout
    `load_dataset` reads.  Returns one of 'present', 'downloaded',
    'unavailable' (no network / no direct URL — layout printed)."""
    layout, urls, kind = LAYOUTS[name]
    marker = os.path.join(data_dir, _PRESENCE[name])
    if os.path.exists(marker):
        print(f"{name}: already present at {marker}")
        return "present"
    if not urls:
        print(f"{name}: no direct download URL.\nExpected layout under "
              f"{data_dir}:\n  {layout}")
        return "unavailable"
    try:
        for url, rel in urls:
            dest = os.path.join(data_dir, rel)
            print(f"{name}: fetching {url}")
            _download(url, dest, timeout=timeout)
        if kind == "tar":
            with tarfile.open(os.path.join(data_dir, urls[0][1])) as tf:
                tf.extractall(data_dir, filter="data")
        elif kind == "zip":
            with zipfile.ZipFile(os.path.join(data_dir, urls[0][1])) as zf:
                zf.extractall(data_dir)
        if not os.path.exists(marker):
            raise FileNotFoundError(
                f"downloaded but expected marker missing: {marker}")
        print(f"{name}: ready at {marker}")
        return "downloaded"
    except Exception as e:  # no egress / mirror down — degrade to the doc
        print(f"{name}: download failed ({type(e).__name__}: "
              f"{str(e)[:120]}).\nExpected layout under {data_dir}:\n"
              f"  {layout}\nEvery preset also runs without files via the "
              "deterministic synthetic fixture (--synthetic).")
        return "unavailable"


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="download datasets into the load_dataset layout "
                    "(prints the expected layout when offline)")
    ap.add_argument("datasets", nargs="*",
                    help=f"datasets to fetch, from: {' '.join(LAYOUTS)} "
                         "(default: all six)")
    ap.add_argument("--all", action="store_true", help="fetch every dataset")
    ap.add_argument("--data-dir", default="./data")
    ap.add_argument("--layout", action="store_true",
                    help="print each dataset's expected on-disk layout and "
                    "exit (no network use)")
    ap.add_argument("--timeout", type=float, default=30.0)
    args = ap.parse_args(argv)

    names = list(LAYOUTS) if (args.all or not args.datasets) else args.datasets
    unknown = [n for n in names if n not in LAYOUTS]
    if unknown:
        ap.error(f"unknown dataset(s) {unknown}; choose from {list(LAYOUTS)}")
    if args.layout:
        for n in names:
            print(f"{n}:\n  {args.data_dir}/{LAYOUTS[n][0]}\n")
        return 0
    results = {n: fetch(n, args.data_dir, timeout=args.timeout)
               for n in names}
    print({n: r for n, r in results.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
