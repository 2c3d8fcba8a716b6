"""Dynamic micro-batching for serving — port of
``cnn_pde_tpu/serve_batch.py``: coalesce concurrent requests into one
predict call.

Every predict call pays a fixed cost on the host (the copy in, a graph
replay or the eager launches, the copy out), while the device time of a
small batch and a somewhat larger one differ little.  So N concurrent
single-image requests served one by one cost N calls; coalesced they cost
one.

``MicroBatcher`` wraps any callable(images) -> outputs whose first axis is
the batch (a numpy array or a tensor, which is copied to the host):
requests enqueue their arrays and block; a worker thread takes the first
waiting request, drains whatever else arrives within ``max_wait_ms`` (up
to ``max_batch`` rows), concatenates along axis 0, pads the total to the
next size in ``buckets`` (so a captured predict replays one of a few
graphs), runs one predict, and scatters the slices back.  Up to
``pipeline`` coalesced batches are in flight at once (a small thread
pool).  Outputs equal the per-request calls: the padding rows are
discarded.

    predict = make_predict_fn(model, output="labels")
    batched = MicroBatcher(predict, max_batch=64, max_wait_ms=2.0)
    labels = batched(images)          # thread-safe, coalesces with peers
    batched.close()
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

__all__ = ["MicroBatcher", "to_host"]

_SENTINEL = object()


def to_host(out):
    """A predict's output as a numpy array (a tensor copied to the host)."""
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return np.asarray(out)


class _Request:
    __slots__ = ("array", "event", "result", "error")

    def __init__(self, array):
        self.array = array
        self.event = threading.Event()
        self.result = None
        self.error = None


class MicroBatcher:
    """Thread-safe dynamic batching wrapper around a batched predict fn.

    ``buckets``: batch sizes to pad dispatch totals to (with ``max_batch``
    added); totals above the largest dispatch unpadded, which happens only
    for a single request larger than ``max_batch``, since ``_collect``
    stops draining at ``max_batch`` rows.  ``max_wait_ms`` bounds the
    added latency: the first request of a batch waits at most this long
    for company.
    """

    def __init__(self, predict_fn, max_batch=64, max_wait_ms=2.0,
                 buckets=(1, 8, 32, 64), pipeline=2):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.predict_fn = predict_fn
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.buckets = tuple(sorted(set(int(b) for b in buckets)
                                    | {self.max_batch}))
        self.n_dispatches = 0
        self.n_requests = 0
        self._q = queue.Queue()
        self._closed = False
        # ``pipeline`` coalesced batches may be in flight at once: the
        # collector hands each batch to this pool and goes back to
        # draining the queue, so the next batch's copy in overlaps the
        # previous one's copy out; pipeline=1 is strict serial dispatch
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, int(pipeline)),
            thread_name_prefix="microbatch-dispatch")
        self._stats_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ---------------- client side ----------------

    def __call__(self, images):
        """Enqueue a (b, ...) request and block for its outputs."""
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        arr = np.asarray(images)
        if arr.ndim < 1 or arr.shape[0] < 1:
            raise ValueError(f"need a batched array, got shape {arr.shape}")
        req = _Request(arr)
        self._q.put(req)
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def close(self):
        """Stop the worker (drains nothing new; in-flight requests finish)."""
        if not self._closed:
            self._closed = True
            self._q.put(_SENTINEL)
            self._worker.join(timeout=10)
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------- worker side ----------------

    def _collect(self):
        """One coalescing round: block for the first request, then drain
        until max_batch rows or the max_wait deadline."""
        first = self._q.get()
        if first is _SENTINEL:
            return None
        batch, rows = [first], first.array.shape[0]
        t_end = time.monotonic() + self.max_wait_s
        while rows < self.max_batch:
            timeout = t_end - time.monotonic()
            if timeout <= 0:
                break
            try:
                req = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if req is _SENTINEL:
                self._q.put(_SENTINEL)  # re-post for the outer loop
                break
            batch.append(req)
            rows += req.array.shape[0]
        return batch

    def _bucket(self, n):
        for b in self.buckets:
            if b >= n:
                return b
        return n  # above the largest bucket: dispatch unpadded

    def _run(self):
        while True:
            batch = self._collect()
            if batch is None:
                return
            self._pool.submit(self._dispatch_safe, batch)

    def _dispatch_safe(self, batch):
        try:
            self._dispatch(batch)
        except Exception as e:  # surface to every waiter, keep serving
            for req in batch:
                req.error = e
                req.event.set()

    def _dispatch(self, batch):
        arrays = [req.array for req in batch]
        total = sum(a.shape[0] for a in arrays)
        stacked = arrays[0] if len(arrays) == 1 else np.concatenate(arrays)
        target = self._bucket(total)
        if target > total:
            # pad by repeating the last row: always a valid input, and the
            # padded rows' outputs are sliced off below
            pad = np.broadcast_to(stacked[-1:],
                                  (target - total,) + stacked.shape[1:])
            stacked = np.concatenate([stacked, pad])
        out = to_host(self.predict_fn(stacked))
        with self._stats_lock:
            self.n_dispatches += 1
            self.n_requests += len(batch)
        ofs = 0
        for req, arr in zip(batch, arrays):
            b = arr.shape[0]
            req.result = out[ofs:ofs + b]
            ofs += b
            req.event.set()
