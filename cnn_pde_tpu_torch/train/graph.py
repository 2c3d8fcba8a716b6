"""A train step and an eval forward replayed from CUDA graphs over a split
kept on the device — the counterpart of the JAX Trainer's device epoch
(``cnn_pde_tpu/train/loop.py::_make_epoch_fn``, ``_evaluate_on_device``),
which runs a whole epoch as one ``lax.scan`` dispatch.

``EpochRunner`` holds the raw train split on the device, an index table
``idx`` (steps, B) of one chunk's shuffled batches, a step counter and a
(2, steps) table of each step's loss and accuracy.  Its body gathers the
batch of ``idx[counter]`` with ``index_select``, runs ``TrainStep.body``
(augmentation, forward, backward, clip, update at the device's learning
rate), writes ``stats[:, counter]`` and advances the counter, all on the
device.  On a CUDA device the body is captured once in a
``torch.cuda.CUDAGraph`` (two bodies with ``grad_accum``: "accumulate"
and "accumulate and apply", the host picking one from its step count) and
a chunk is one replay a step and one fetch of the stats; on the CPU the
same body runs eagerly (the caller's explicit device, not a fallback).

A runner's first ``WARMUP_ROUNDS``·k steps run eagerly on the stream that
then captures (they are the chunk's real steps, not steps to undo): the
kernels are built by nvcc at first use (``ops/kernels.py``), each launch
plan is checked against the C side at its first bind, K1-K5 opt into
large shared memory once a device, and the gradients, the optimizer's
moments and cuBLAS's workspace come to exist.  Then each body is
captured, and the rest of the run replays it; a run shorter than the
warm-up runs eagerly, and the next one goes on counting.  The Trainer's
``torch.Generator`` is registered with each graph (torch's graph-safe
generator state): the replays draw the augmentation and dropout numbers
of the eager steps they stand for.  A failed capture raises; nothing
falls back to eager steps.

``EvalRunner`` keeps a split padded to a batch multiple on the device and
replays a captured eval forward a batch, writing the predictions into a
device table that is fetched once.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["EpochRunner", "EvalRunner"]

WARMUP_ROUNDS = 2  # eager runs of each body before its capture


def _on_stream(stream, fn):
    """``fn()`` on ``stream``, after the current stream's work and before
    its next."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        fn()
    current.wait_stream(stream)


def _capture(bodies, stream, generator=None):
    """{key: CUDAGraph of ``bodies[key]()``}, captured on ``stream`` in one
    memory pool, each reading ``generator``'s state at its replay."""
    graphs, pool = {}, None
    for key, body in bodies.items():
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            body()
        pool = graph.pool()
        graphs[key] = graph
    return graphs


class EpochRunner:
    """Chunks of train steps of ``step`` (a ``TrainStep``) over the device
    split (``images`` float32 (N, C, H, W), ``labels`` int64 (N,)), at most
    ``capacity`` steps a chunk, each of ``batch`` images."""

    def __init__(self, step, images, labels, batch, capacity):
        device = step.device
        self.step = step
        self.images, self.labels = images, labels
        self.idx = torch.zeros((capacity, batch), dtype=torch.int64,
                               device=device)
        self.counter = torch.zeros((1,), dtype=torch.int64, device=device)
        self.stats = torch.zeros((2, capacity), device=device)
        self.use_graph = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.use_graph else None
        self.graphs = None  # {apply: CUDAGraph}
        self.table = None   # the learning-rate table the graphs read
        self.warm = 0       # eager steps since the graphs were dropped

    @property
    def capacity(self):
        return self.idx.shape[0]

    def body(self, apply):
        """One step on batch ``idx[counter]``; its loss and accuracy into
        ``stats[:, counter]``."""
        bidx = self.idx.index_select(0, self.counter)[0]
        x = self.images.index_select(0, bidx)
        y = self.labels.index_select(0, bidx)
        loss, acc = self.step.body(x, y, apply)
        self.stats.index_copy_(1, self.counter,
                               torch.stack([loss, acc])[:, None])
        self.counter.add_(1)

    def run(self, idx, horizon):
        """Train one chunk: ``idx`` (n, batch) int array of the chunk's
        batches; ``horizon``: the updates the run reaches (the learning
        rate table covers them).  Returns the (2, n) float32 losses and
        accuracies, fetched once."""
        n = idx.shape[0]
        if n > self.capacity:
            raise ValueError(f"a chunk of {n} steps exceeds the runner's "
                             f"{self.capacity}")
        step = self.step
        if self.use_graph and not step.capturable:
            raise TypeError(
                "a CUDA-graph train step needs the learning rates on the "
                "device (train/optim.py::OptaxAdamW, the preset's "
                "optimizer)")
        self.idx[:n].copy_(torch.from_numpy(np.ascontiguousarray(idx)))
        self.counter.zero_()
        step.reserve_updates(max(horizon, step.updates + n))
        if step.lr_table is not self.table:  # the graphs read the old one
            self.graphs, self.table, self.warm = None, step.lr_table, 0
        for _ in range(n):
            apply = step.applies()
            if self.graphs is not None:
                self.graphs[apply].replay()
            elif self.use_graph:
                _on_stream(self.stream, lambda: self.body(apply))
                self.warm += 1
                if self.warm == WARMUP_ROUNDS * step.k:
                    keys = [False, True] if step.k > 1 else [True]
                    self.graphs = _capture(
                        {a: (lambda a=a: self.body(a)) for a in keys},
                        self.stream, step.generator)
            else:
                self.body(apply)
            step.advance(apply)
        return self.stats[:, :n].cpu().numpy()


class EvalRunner:
    """The eval predictions of ``model`` over a split kept on the device,
    padded to ``batch`` images a batch; on a CUDA device one captured
    forward a batch."""

    def __init__(self, model, images, batch):
        n = images.shape[0]
        nb = -(-n // batch)
        pad = torch.zeros((nb * batch - n,) + tuple(images.shape[1:]),
                          dtype=images.dtype, device=images.device)
        self.model = model
        self.n = n
        self.images = torch.cat([images, pad]).reshape(
            (nb, batch) + tuple(images.shape[1:]))
        self.counter = torch.zeros((1,), dtype=torch.int64,
                                   device=images.device)
        self.preds = torch.zeros((nb, batch), dtype=torch.int64,
                                 device=images.device)
        self.use_graph = images.device.type == "cuda"
        self.stream = (torch.cuda.Stream(images.device) if self.use_graph
                       else None)
        self.graph = None
        self.warm = 0  # eager batches run before the capture

    def body(self):
        x = self.images.index_select(0, self.counter)[0]
        pred = self.model(x).argmax(dim=-1)
        self.preds.index_copy_(0, self.counter, pred[None])
        self.counter.add_(1)

    def run(self):
        """The split's predictions (N,), padding sliced off: one fetch."""
        self.model.eval()
        with torch.no_grad():
            self.counter.zero_()
            for _ in range(self.images.shape[0]):
                if self.graph is not None:
                    self.graph.replay()
                elif self.use_graph:
                    _on_stream(self.stream, self.body)
                    self.warm += 1
                    if self.warm == WARMUP_ROUNDS:
                        self.graph = _capture({None: self.body},
                                              self.stream)[None]
                else:
                    self.body()
        return self.preds.reshape(-1)[:self.n].cpu().numpy()
