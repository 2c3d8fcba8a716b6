"""Host-side batching — port of ``cnn_pde_tpu/data/pipeline.py``
(``ArrayDataset``, ``balance_classes``), numpy only.

The datasets stay host numpy arrays: each epoch's shuffle is a permutation
from ``np.random.default_rng(seed)``, the train batches keep a fixed shape
(the last partial batch dropped) and take their augmentation and
normalisation on the device inside the train step; eval batches are
normalised here (the deterministic test transform).  ``native=True``
takes the train batches from the C++ prefetching batcher
(``native/binding.py``), the JAX package's shuffle.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ArrayDataset", "balance_classes", "synthetic_dataset"]


def balance_classes(images, labels):
    """Truncate every class to the size of the smallest one, keeping the
    original order (the emotion dataset's balancing option)."""
    labels = np.asarray(labels)
    counts = np.bincount(labels)
    min_count = counts[counts > 0].min()
    keep = np.zeros(len(labels), dtype=bool)
    seen = np.zeros(counts.shape[0], dtype=np.int64)
    for i, lab in enumerate(labels):
        if seen[lab] < min_count:
            keep[i] = True
            seen[lab] += 1
    return images[keep], labels[keep]


class ArrayDataset:
    """In-memory dataset of NCHW float32 images in [0, 1] and int labels;
    ``mean``/``std`` normalise the eval batches."""

    def __init__(self, train_images, train_labels, test_images, test_labels,
                 *, mean: Optional[Sequence[float]] = None,
                 std: Optional[Sequence[float]] = None,
                 num_classes: Optional[int] = None):
        self.train_images = np.ascontiguousarray(train_images,
                                                 dtype=np.float32)
        self.train_labels = np.ascontiguousarray(train_labels, dtype=np.int32)
        self.test_images = np.ascontiguousarray(test_images, dtype=np.float32)
        self.test_labels = np.ascontiguousarray(test_labels, dtype=np.int32)
        self.mean = np.asarray(mean, np.float32) if mean is not None else None
        self.std = np.asarray(std, np.float32) if std is not None else None
        self.num_classes = num_classes or int(max(train_labels.max(),
                                                  test_labels.max()) + 1)

    def _normalize(self, images):
        if self.mean is None:
            return images
        return (images - self.mean[:, None, None]) / self.std[:, None, None]

    def train_batches(self, batch_size, seed=0, native=False
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Shuffled fixed-shape batches of raw [0, 1] images, the
        permutation from ``np.random.default_rng(seed)``, the remainder
        dropped.  ``native=True``: the C++ prefetching batcher's batches
        (a producer thread gathers the next batch while the device runs
        the current step), the JAX package's native shuffle of the same
        seed; it raises when the batcher cannot be built, with no
        fallback to the numpy path."""
        if native:
            from ..native import NativeBatcher

            yield from NativeBatcher(self.train_images, self.train_labels,
                                     batch_size, seed=seed)
            return
        n = self.train_images.shape[0]
        perm = np.random.default_rng(seed).permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = perm[i:i + batch_size]
            yield self.train_images[idx], self.train_labels[idx]

    def train_arrays(self):
        """The whole raw train split."""
        return self.train_images, self.train_labels

    def eval_arrays(self, split="test"):
        """The whole normalised split ('test' or 'train')."""
        images = self.test_images if split == "test" else self.train_images
        labels = self.test_labels if split == "test" else self.train_labels
        return self._normalize(images), labels

    def eval_batches(self, batch_size, split="test"):
        """Normalised batches of the split in order, the last one short."""
        images = self.test_images if split == "test" else self.train_images
        labels = self.test_labels if split == "test" else self.train_labels
        n = images.shape[0]
        for i in range(0, n, batch_size):
            yield (self._normalize(images[i:i + batch_size]),
                   labels[i:i + batch_size])

    def steps_for_batch(self, batch_size):
        return max(self.train_images.shape[0] // batch_size, 1)


def synthetic_dataset(name, *, train_per_class=20, test_per_class=5):
    """The synthetic stand-in of dataset ``name`` as an ``ArrayDataset``
    with the dataset's normalisation, as the JAX ``load_dataset`` builds it
    when the real files are absent."""
    from .real import NORMALIZATION
    from .synthetic import make_synthetic

    mean, std = NORMALIZATION[name]
    ds = ArrayDataset(*make_synthetic(name, train_per_class=train_per_class,
                                      test_per_class=test_per_class),
                      mean=mean, std=std)
    ds.source = "synthetic"
    return ds
