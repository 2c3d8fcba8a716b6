"""ctypes binding and first-use build of the native batcher — port of
``cnn_pde_tpu/native/binding.py``.

``batcher.cpp`` is compiled by ``g++`` at first use into the checkout's
``build/native/`` (the file name carries a hash of the source, so an
edited source is rebuilt), never next to its source.  There is no
fallback: when the build fails, ``NativeBatcher`` raises with the
compiler's output, and so does every path that asked for the native
loader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["NativeBatcher", "build", "native_available"]

SRC = Path(__file__).resolve().parent / "batcher.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
COMPILER = "g++"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
         "-pthread"]

_lib = None
_lock = threading.Lock()


def _target() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()
    return BUILD_DIR / f"libbatcher-{digest[:12]}.so"


def build() -> Path:
    """Compile ``batcher.cpp`` unless it is built already; raises with the
    compiler's output when the build fails.  Returns the library's path."""
    so = _target()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [COMPILER, *FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"the native batcher needs a C++ compiler: "
                           f"{COMPILER!r} was not found") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native batcher failed "
                           f"({' '.join(cmd)}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.batcher_create.restype = ctypes.c_void_p
        lib.batcher_create.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64]
        lib.batcher_total_batches.restype = ctypes.c_int64
        lib.batcher_total_batches.argtypes = [ctypes.c_void_p]
        lib.batcher_next.restype = ctypes.c_int
        lib.batcher_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p]
        lib.batcher_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the library builds and loads here (a failed build raises
    in ``NativeBatcher``; this only asks)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


class NativeBatcher:
    """Iterator over one epoch's shuffled (images, labels) batches, made by
    the C++ prefetch thread: float32 images and int32 labels, the last
    partial batch dropped.  The shuffle is xorshift64* Fisher-Yates seeded
    with ``seed + 1``, as in the JAX package.  Keeps the source arrays
    alive while it runs (the C++ side borrows them)."""

    _handle = None

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, seed: int = 0, ring: int = 4):
        lib = _load()
        self._lib = lib
        self.images = np.ascontiguousarray(images, dtype=np.float32)
        self.labels = np.ascontiguousarray(labels, dtype=np.int32)
        n = self.images.shape[0]
        self.item_shape = self.images.shape[1:]
        item_floats = int(np.prod(self.item_shape))
        self.batch_size = batch_size
        self._handle = lib.batcher_create(
            self.images.ctypes.data_as(ctypes.c_void_p),
            self.labels.ctypes.data_as(ctypes.c_void_p),
            n, item_floats, batch_size, ring, seed + 1)
        self.total_batches = lib.batcher_total_batches(self._handle)

    def __iter__(self):
        try:
            while True:
                imgs = np.empty((self.batch_size,) + self.item_shape,
                                np.float32)
                labs = np.empty((self.batch_size,), np.int32)
                ok = self._lib.batcher_next(
                    self._handle,
                    imgs.ctypes.data_as(ctypes.c_void_p),
                    labs.ctypes.data_as(ctypes.c_void_p))
                if not ok:
                    return
                yield imgs, labs
        finally:
            self.close()

    def close(self):
        if self._handle is not None:
            self._lib.batcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
