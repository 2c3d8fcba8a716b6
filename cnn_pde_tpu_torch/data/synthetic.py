"""Deterministic procedural stand-ins for the ported datasets (MNIST,
Fashion-MNIST, CIFAR-10) — the port's own copy of
``cnn_pde_tpu/data/synthetic.py`` (numpy only; PIL imported inside the
writer), so that training runs with no dataset on disk, and
``write_synthetic_tiny_imagenet`` puts the Tiny-ImageNet stand-in on disk
in the dataset's folder layout.

Images are float32 NCHW in [0, 1] (the post-ToTensor convention), labels
int32; the same arrays as the JAX package's for the same arguments.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SYNTHETIC_SPECS", "make_synthetic",
           "write_synthetic_tiny_imagenet"]

# dataset name: (channels, size, num_classes)
SYNTHETIC_SPECS = {"mnist": (1, 28, 10), "fashion_mnist": (1, 28, 10),
                   "svhn": (3, 32, 10), "cifar10": (3, 32, 10),
                   "emotion": (1, 48, 7), "tiny_imagenet": (3, 64, 200)}


def _pattern_image(size, channels, class_id, instance_id, num_classes):
    """Class-dependent pattern: primary/secondary colours, one of 4 pattern
    types, deterministic noise, a contrasting micro-feature square."""
    colors = np.array([
        [255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 0],
        [255, 0, 255], [0, 255, 255], [128, 128, 128], [255, 128, 0],
    ], dtype=np.int64)
    primary = colors[class_id % 8]
    secondary = colors[(class_id // 8) % 8]
    pattern_type = (class_id // 64) % 4 if num_classes > 64 else class_id % 4

    img = np.empty((size, size, 3), dtype=np.int64)
    img[:, :] = primary

    rng = np.random.RandomState(class_id * 1000 + instance_id)
    img = np.clip(img + rng.randint(-20, 20, (size, size, 3)), 0, 255)

    if pattern_type == 0:  # circle
        cx = size // 2 + (class_id % 7 - 3) * 3
        cy = size // 2 + ((class_id // 7) % 7 - 3) * 3
        radius = size // 8 + (class_id % 5) * 3
        y, x = np.ogrid[:size, :size]
        mask = (x - cx) ** 2 + (y - cy) ** 2 <= radius**2
        img[mask] = secondary
    elif pattern_type == 1:  # stripes
        w = 4 + (class_id % 4)
        for i in range(0, size, w * 2):
            img[:, i : i + w] = secondary
    elif pattern_type == 2:  # checkerboard
        b = size // 8 + (class_id % 3) * 4
        for i in range(0, size, b):
            for j in range(0, size, b):
                if (i // b + j // b) % 2 == 0:
                    img[i : i + b, j : j + b] = secondary
    else:  # diagonal stripes
        ii, jj = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
        mask = (ii + jj) % (6 + class_id % 4) < 3
        img[mask] = secondary

    # micro-feature: small contrasting square
    fx = size // 8 + (class_id % 6) * (size // 8)
    fy = size // 8 + ((class_id // 6) % 6) * (size // 8)
    fs = 2 + (class_id % 3)
    img[fy : fy + fs, fx : fx + fs] = 255 - primary

    if channels == 1:
        img = img.mean(axis=2, keepdims=True)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_synthetic(name, *, train_per_class=20, test_per_class=5, seed=0):
    """Build (train_images, train_labels, test_images, test_labels)."""
    channels, size, num_classes = SYNTHETIC_SPECS[name]

    def build(per_class, offset):
        n = num_classes * per_class
        images = np.empty((n, channels, size, size), dtype=np.float32)
        labels = np.empty((n,), dtype=np.int32)
        i = 0
        for c in range(num_classes):
            for j in range(per_class):
                img = _pattern_image(size, channels, c, offset + j, num_classes)
                images[i] = img.transpose(2, 0, 1).astype(np.float32) / 255.0
                labels[i] = c
                i += 1
        perm = np.random.RandomState(seed).permutation(n)
        return images[perm], labels[perm]

    train = build(train_per_class, 0)
    test = build(test_per_class, 10_000)
    return train[0], train[1], test[0], test[1]


def write_synthetic_tiny_imagenet(root_dir, *, num_classes=200,
                                  train_per_class=20, val_total=1000):
    """Write the synthetic dataset in the on-disk ``tiny-imagenet-200``
    layout (per-class ``train/<id>/images/*.JPEG``, ``val/images/*.JPEG``
    and ``val/val_annotations.txt``), the JAX package's files, names,
    annotation lines and pixels, so that the folder loader runs without
    the download.  Returns the dataset's root."""
    import os

    from PIL import Image

    base = os.path.join(root_dir, "tiny-imagenet-200")
    for c in range(num_classes):
        class_id = f"n{c:08d}"
        cdir = os.path.join(base, "train", class_id, "images")
        os.makedirs(cdir, exist_ok=True)
        for j in range(train_per_class):
            img = _pattern_image(64, 3, c, j, num_classes)
            Image.fromarray(img).save(os.path.join(cdir,
                                                   f"{class_id}_{j}.JPEG"))

    val_dir = os.path.join(base, "val", "images")
    os.makedirs(val_dir, exist_ok=True)
    with open(os.path.join(base, "val", "val_annotations.txt"), "w") as f:
        for i in range(val_total):
            c = i % num_classes
            class_id = f"n{c:08d}"
            img = _pattern_image(64, 3, c, i + 1000, num_classes)
            Image.fromarray(img).save(os.path.join(val_dir, f"val_{i}.JPEG"))
            f.write(f"val_{i}.JPEG\t{class_id}\t0\t0\t64\t64\n")
    return base
