"""The training engine — port of ``cnn_pde_tpu/train/loop.py``
(``TrainConfig``, ``TrainState``, ``Trainer``, ``GracefulPreemption``).

``Trainer.fit`` runs epochs of ``make_train_step`` steps over an
``ArrayDataset``, evaluates every ``eval_every`` epochs (and after the
last), keeps the best test accuracy, stops early after
``early_stop_patience`` evals without a better one, writes the 'best'
checkpoint at each new best and a rolling 'last' one every
``checkpoint_every`` epochs, at the end, on an early stop and on a
preemption, streams each epoch's record to a metrics sink, and resumes
from a checkpoint at the first uncompleted epoch.  ``refresh_bn_stats``
recomputes the BatchNorm statistics under the final weights.

    trainer = Trainer(model, TrainConfig.from_preset(values, epochs=2),
                      values)
    state = trainer.init_state()
    result = trainer.fit(state, dataset, checkpoint_dir="ckpt")

``TrainConfig(device_epoch=True)`` is the JAX device epoch: the train
split lives on the device, each epoch's batches are an index table there,
and the train step is captured once in a CUDA graph and replayed a step
(``train/graph.py``), with one fetch of the losses and accuracies a chunk;
with ``multi_epoch_dispatch`` (the default) a chunk is every epoch up to
the next eval.  Its eval keeps the test split on the device and replays a
captured forward a batch.  On a CPU model the same loop runs its bodies
without a graph, and ends on the host loop's weights bit for bit.

``TrainConfig(native_loader=True)`` feeds the host loop from the C++
prefetching batcher (``native/``); with ``device_epoch`` it is ignored
with a warning, as in JAX.

``Trainer(mesh=make_mesh())`` inside a process group (one process a
device: torchrun, or ``parallel.initialize``) is the JAX data-parallel
Trainer: ``batch_size`` is the global batch, each rank keeps the split and
takes its rows of each global batch (host loop and device epoch alike),
its step reduces across the ranks (``parallel/data_parallel.py``), eval
gathers every rank's predictions, and checkpoints are written by rank 0
behind a barrier and restored on every rank.

``Trainer(mesh=make_mesh(data=2, model=2), tp=True)`` also shards the FC
stacks and the Ruthotto K over the 'model' axis
(``parallel/tensor_parallel.py``) after the init (or ``init_state``'s
``initial`` weights), the optimizer's state living on the shards;
checkpoints hold the unsharded tensors (every rank gathers, rank 0
writes) and every rank restores its block.  ``image_spec=("data", None,
"spatial", None)`` with a spatial classifier (``parallel/spatial_model.py``)
hands the model each rank's block of H after the augmentation, which sees
whole images.  The device epoch captures the subgroups' collectives in its
graph on the card.  A model whose extractor's branches are split over the
'model' axis (``parallel/branch_parallel.py::enable_branch_parallel``)
trains under ``Trainer(mesh=)`` on either loop; with ``tp`` or
``image_spec`` it raises.
"""

from __future__ import annotations

import signal
import time
import warnings
from dataclasses import dataclass, fields
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..utils import debug
from .graph import EpochRunner, EvalRunner
from .step import make_schedule, make_train_step, preset_optimizer

__all__ = ["TrainConfig", "TrainState", "Trainer", "GracefulPreemption",
           "pde_param_stats"]


class GracefulPreemption:
    """Latch SIGTERM/SIGINT into a flag so ``Trainer.fit(preemption=...)``
    stops at the next eval boundary, checkpoints and returns; with
    ``checkpoint_dir`` and ``--resume`` the run restarts from the first
    uncompleted epoch with its optimizer and schedule intact.

    A context manager that restores the previous handlers on exit.  A
    second signal goes to the previous handler (a double Ctrl-C still stops
    a hung run).  Install it from the main thread only; elsewhere construct
    it with ``signals=()`` and set ``.requested`` yourself."""

    def __init__(self, signals=None, verbose=True):
        self.requested = False
        self.verbose = verbose
        self._signals = ((signal.SIGTERM, signal.SIGINT)
                         if signals is None else tuple(signals))
        self._previous = {}

    def _handle(self, signum, frame):
        if self.requested:  # second signal: defer to the original handler
            prev = self._previous.get(signum)
            if callable(prev):
                return prev(signum, frame)
            raise KeyboardInterrupt
        self.requested = True
        if self.verbose:
            print(f"[preemption] caught signal {signum}; finishing the "
                  "current chunk, then checkpointing and stopping",
                  flush=True)

    def __enter__(self):
        for s in self._signals:
            self._previous[s] = signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc):
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()
        return False


@dataclass
class TrainConfig:
    """The loop's settings (the JAX ``TrainConfig``'s fields).  The
    optimizer, loss and augmentation settings come from the preset's
    ``train`` values (``Trainer``'s ``train_values``); the fields here
    that overlap them override them."""

    epochs: int = 1
    batch_size: int = 128
    eval_batch_size: Optional[int] = None
    label_smoothing: float = 0.1
    clip_norm: Optional[float] = 1.0
    weight_decay: float = 1e-4
    default_lr_scale: float = 1.0
    param_groups: Sequence = ()
    regularizer: Optional[tuple] = None  # hybrid_pde_regularization alphas
    eval_every: int = 1          # epochs between evals (SVHN 2, emotion 5)
    early_stop_patience: Optional[int] = None  # in evals (emotion 10)
    log_every: int = 100         # batches between log lines
    seed: int = 0
    native_loader: bool = False  # the C++ batcher feeds the host loop
    grad_accum: int = 1          # micro-batches an update (optax.MultiSteps)
    moment_dtype: Optional[torch.dtype] = None  # AdamW's m and v storage
    device_epoch: bool = False   # the split on the device, a CUDA graph
    # with device_epoch: every epoch up to the next eval in one chunk (one
    # fetch of its stats); False: one chunk an epoch
    multi_epoch_dispatch: bool = True
    max_steps_per_epoch: Optional[int] = None  # a cap (smoke runs)
    debug_nans: bool = False     # raise at the first non-finite step

    @property
    def eval_bs(self):
        return self.eval_batch_size or self.batch_size

    @classmethod
    def from_preset(cls, train_values, **overrides):
        """The config of a preset's ``train`` values, then ``overrides``."""
        names = {f.name for f in fields(cls)}
        kw = {k: v for k, v in train_values.items() if k in names}
        kw["param_groups"] = tuple(train_values.get("param_groups", ()))
        kw.update(overrides)
        return cls(**kw)

    def step_values(self, train_values):
        """``train_values`` with this config's loss and optimizer fields,
        as ``make_train_step`` reads them."""
        return dict(train_values, label_smoothing=self.label_smoothing,
                    clip_norm=self.clip_norm, weight_decay=self.weight_decay,
                    default_lr_scale=self.default_lr_scale,
                    param_groups=tuple(self.param_groups),
                    regularizer=self.regularizer)


class TrainState:
    """What a run carries from step to step: the model (parameters and
    BatchNorm statistics), its optimizer, the train step (with its update
    counter and accumulated gradients), the device generator of its
    augmentation and dropout draws, and the step count."""

    def __init__(self, model, optimizer, train_step, generator, step=0):
        self.model = model
        self.optimizer = optimizer
        self.train_step = train_step
        self.generator = generator
        self.step = step


class Trainer:
    def __init__(self, model: nn.Module, config: TrainConfig, train_values,
                 schedule=None, mesh=None, tp=False, image_spec=None):
        """``train_values``: a preset's ``train`` entry (its augmentation,
        schedule and optimizer settings; ``augment`` None for none).
        ``schedule``: the learning rate by update count; by default the
        preset's over the updates of an epoch, which ``init_state`` fixes
        from the dataset.  ``mesh``: data-parallel training over the
        mesh's process group (the model on this rank's device).  ``tp``:
        shard the model over the mesh's 'model' axis as well.
        ``image_spec``: the layout of image batches, a tuple of axis names
        or None a dim (``("data", None, "spatial", None)``: each rank's
        block of H as well as its rows).  Both need a mesh in a process
        group."""
        if tp or image_spec is not None:
            from ..parallel.branch_parallel import branch_parallel_extractors

            if branch_parallel_extractors(model):
                raise ValueError(
                    "Trainer(tp=, image_spec=) with a branch-parallel model "
                    "(enable_branch_parallel): branch parallelism combined "
                    "with tensor parallelism or spatial sharding is not "
                    "covered")
        if (tp or image_spec is not None) and (mesh is None
                                               or mesh.group is None):
            raise ValueError(
                "Trainer(tp=, image_spec=) shards over a mesh of one "
                "process a device: bring up a process group and pass "
                "mesh=make_mesh(...) (parallel/multihost.py::initialize, "
                "or torchrun)")
        if image_spec is not None:
            image_spec = tuple(image_spec)
            if image_spec[:1] != ("data",) or any(
                    a not in (None, "data", "spatial", "model")
                    for a in image_spec):
                raise ValueError(f"image_spec {image_spec}: the batch dim "
                                 "over 'data', the others None or a mesh "
                                 "axis")
        self.mesh = mesh
        self.tp = bool(tp)
        self.image_spec = image_spec
        self.rows = None  # ('data' index, 'data' size) of a mesh run
        if mesh is not None and mesh.group is not None:
            _, index, size = mesh.axis("data")
            self.rows = (index, size)
            for name, b in (("batch_size", config.batch_size),
                            ("eval batch", config.eval_bs)):
                if b % size:
                    raise ValueError(
                        f"{name} {b} is not divisible by the 'data' axis "
                        f"size {size}")
        if config.native_loader and config.device_epoch:
            warnings.warn("device_epoch=True bypasses the native loader "
                          "(batching happens on device); native_loader "
                          "is ignored.")
        self.model = model
        self.config = config
        self.train_values = config.step_values(train_values)
        self.schedule = schedule
        self.device = next(model.parameters()).device
        self._dev_data = None  # (dataset, images, labels) on the device
        self._runner = None    # EpochRunner of the current split
        self._dev_eval = {}    # split -> (dataset, EvalRunner, labels)

    # ---------------- initialization ----------------

    def init_state(self, steps_per_epoch=1, initial=None) -> TrainState:
        """A fresh optimizer, generator (seeded with ``config.seed``) and
        train step for the model's current weights, or ``initial`` (an
        unsharded ``state_dict`` to warm-start from, loaded strictly).
        ``steps_per_epoch``: the train steps an epoch, for the default
        schedule (updates an epoch: steps // grad_accum).  With ``tp`` the
        model is sharded here, before the optimizer is made."""
        cfg = self.config
        if initial is not None:
            from ..parallel.tensor_parallel import load_full_state_dict

            load_full_state_dict(self.model, initial)
        if self.rows is not None:  # every rank starts from rank 0's weights
            from ..parallel.data_parallel import replicate

            if getattr(self.model, "tp_layout", None) is None:
                replicate(self.mesh, self.model)
        if self.tp and getattr(self.model, "tp_layout", None) is None:
            from ..parallel.tensor_parallel import (shard_pytree,
                                                    tp_param_specs)

            shard_pytree(self.mesh, self.model,
                         tp_param_specs(self.model, self.mesh))
        optimizer = preset_optimizer(self.model, self.train_values,
                                     cfg.moment_dtype)
        k = max(int(cfg.grad_accum or 1), 1)
        # the preset's horizon (its epochs), in updates, as the JAX CLI
        # makes it
        schedule = self.schedule or make_schedule(
            self.train_values, max(1, steps_per_epoch // k))
        generator = torch.Generator(self.device).manual_seed(cfg.seed)
        step = make_train_step(self.model, self.train_values,
                               steps_per_epoch, generator,
                               optimizer=optimizer, schedule=schedule,
                               grad_accum=k, mesh=self.mesh,
                               image_spec=self.image_spec)
        return TrainState(self.model, optimizer, step, generator)

    # ---------------- epoch drivers ----------------

    def train_epoch(self, state: TrainState, dataset, epoch: int, *,
                    verbose=True):
        """One epoch of ``dataset.train_batches(batch_size, seed + epoch)``
        (at most ``max_steps_per_epoch`` steps); the epoch's mean loss and
        train accuracy (percent) and its wall time."""
        cfg = self.config
        if cfg.device_epoch and hasattr(dataset, "train_arrays"):
            return self._run_epochs_on_device(state, dataset, epoch, 1,
                                              verbose=verbose)[0]
        t0 = time.time()
        losses, accs = [], []  # device scalars, fetched at the epoch's end
        batch_kwargs = {"native": True} if cfg.native_loader else {}
        for bi, (images, labels) in enumerate(
                dataset.train_batches(cfg.batch_size, seed=cfg.seed + epoch,
                                      **batch_kwargs)):
            if (cfg.max_steps_per_epoch is not None
                    and bi >= cfg.max_steps_per_epoch):
                break
            if self.rows is not None:  # this rank's rows
                lo, hi = self._block(images.shape[0])
                images, labels = images[lo:hi], labels[lo:hi]
            loss, acc = state.train_step(images, labels)
            if cfg.debug_nans:
                debug.check_step(loss, state.model, state.step)
            state.step += 1
            losses.append(loss)
            accs.append(acc)
            if verbose and bi % cfg.log_every == 0:
                print(f"Epoch {epoch+1}, Batch {bi}, Loss: {float(loss):.4f}, "
                      f"Acc: {100.0*float(acc):.2f}%")
        stats = (torch.stack([torch.stack(losses), torch.stack(accs)])
                 .cpu().numpy() if losses else np.zeros((2, 0), np.float32))
        dt = time.time() - t0  # after the fetch, which waits for the device
        return _epoch_record(stats, epoch, dt, 1, verbose)

    def _block(self, n):
        """This rank's rows [lo, hi) of a global batch of ``n``."""
        from ..parallel.data_parallel import _rows

        return _rows(self.mesh, n)

    def _layout(self, x):
        """``x`` (.., B, C, H, W) cut to this rank's block of each image
        dim that ``image_spec`` shards (the rows are cut already)."""
        if self.image_spec is None:
            return x
        from ..parallel.data_parallel import spec_block

        lead = x.dim() - len(self.image_spec)
        return spec_block(self.mesh, x, (None,) * lead + self.image_spec)

    # ---------------- the device epoch ----------------

    def _device_train_arrays(self, dataset):
        """The raw train split on the device, put there once a dataset
        (keyed on the object: an id can be reused after it is freed)."""
        if self._dev_data is None or self._dev_data[0] is not dataset:
            images, labels = dataset.train_arrays()
            self._dev_data = (dataset,
                              torch.as_tensor(images).to(self.device),
                              torch.as_tensor(labels).to(self.device,
                                                         torch.int64))
            self._runner = None
        return self._dev_data[1], self._dev_data[2]

    def _epoch_indices(self, n, epoch):
        """One epoch's shuffled batch table (steps, batch): the permutation
        of ``ArrayDataset.train_batches(seed + epoch)``, capped by
        ``max_steps_per_epoch``."""
        cfg = self.config
        perm = np.random.default_rng(cfg.seed + epoch).permutation(n)
        if cfg.max_steps_per_epoch is not None:
            perm = perm[: cfg.max_steps_per_epoch * cfg.batch_size]
        nb = perm.shape[0] // cfg.batch_size
        return perm[: nb * cfg.batch_size].reshape(nb, cfg.batch_size)

    def _run_epochs_on_device(self, state: TrainState, dataset, epoch0: int,
                              n_epochs: int, *, verbose=True):
        """``n_epochs`` whole epochs as one chunk: their batch tables
        concatenated, one replay of the captured step a step (the bodies
        run eagerly on a CPU model) and one fetch of the (2, steps) losses
        and accuracies.  The same batches and draws as the host loop.
        Each epoch's record has the chunk's wall time divided evenly and
        ``"chunk": n_epochs``."""
        cfg = self.config
        images, labels = self._device_train_arrays(dataset)
        n = images.shape[0]
        if n < cfg.batch_size:
            return [{"loss": 0.0, "acc": 0.0, "time": 0.0, "chunk": n_epochs}
                    for _ in range(n_epochs)]
        t0 = time.time()
        tables = [self._epoch_indices(n, epoch0 + e) for e in range(n_epochs)]
        idx = np.concatenate(tables)
        if self.rows is not None:  # this rank's rows of each batch
            lo, hi = self._block(cfg.batch_size)
            idx = idx[:, lo:hi]
        step0 = state.step
        runner = self._runner
        if (runner is None or runner.step is not state.train_step
                or runner.capacity < idx.shape[0]):
            runner = self._runner = EpochRunner(
                state.train_step, images, labels, idx.shape[1],
                idx.shape[0])
        # the updates of the whole run, which the learning-rate table covers
        horizon = cfg.epochs * tables[0].shape[0] // state.train_step.k + 1
        stats = runner.run(idx, horizon)
        state.step += idx.shape[0]
        if cfg.debug_nans:
            debug.check_chunk(stats[0], step0, state.model)
        dt = time.time() - t0
        out, lo = [], 0
        for e, table in enumerate(tables):
            hi = lo + table.shape[0]
            out.append(_epoch_record(stats[:, lo:hi], epoch0 + e,
                                     dt / n_epochs, n_epochs, verbose,
                                     cfg.log_every))
            lo = hi
        return out

    def evaluate(self, state: TrainState, dataset, *, split="test"):
        """Eval-mode accuracy (percent) over ``dataset.eval_batches``, with
        the predictions and labels as numpy arrays.  With ``device_epoch``
        the split stays on the device and a captured forward is replayed a
        batch (``_evaluate_on_device``)."""
        if self.rows is not None:
            return self._evaluate_on_mesh(state, dataset, split=split)
        if self.config.device_epoch and hasattr(dataset, "eval_arrays"):
            return self._evaluate_on_device(state, dataset, split=split)
        model = state.model
        model.eval()
        corrects, preds, labels_all = [], [], []
        total = 0
        with torch.inference_mode():
            for images, labels in dataset.eval_batches(self.config.eval_bs,
                                                       split=split):
                x = torch.as_tensor(images).to(self.device,
                                               dtype=torch.float32)
                y = torch.as_tensor(labels).to(self.device,
                                               dtype=torch.long)
                pred = model(x).argmax(dim=-1)
                corrects.append((pred == y).sum())
                preds.append(pred)
                labels_all.append(np.asarray(labels))
                total += labels.shape[0]
        correct = int(torch.stack(corrects).sum()) if corrects else 0
        return {"acc": 100.0 * correct / max(total, 1),
                "predictions": (torch.cat(preds).cpu().numpy() if preds
                                else np.array([])),
                "labels": (np.concatenate(labels_all) if labels_all
                           else np.array([]))}

    def _evaluate_on_device(self, state: TrainState, dataset, *, split):
        """The whole split padded to an eval-batch multiple and kept on
        the device (one slot a split, replaced when the dataset object or
        the state's model changes: the graph reads one model's
        parameters), a captured eval forward replayed a batch, the
        predictions fetched once and the padding sliced off: the host
        eval's accuracy, correct/total in integers."""
        cached = self._dev_eval.get(split)
        if (cached is None or cached[0] is not dataset
                or cached[1].model is not state.model):
            images, labels = dataset.eval_arrays(split)
            runner = EvalRunner(state.model,
                                torch.as_tensor(images).to(self.device),
                                self.config.eval_bs)
            self._dev_eval[split] = (dataset, runner,
                                     np.ascontiguousarray(labels))
        _, runner, labels = self._dev_eval[split]
        preds = runner.run()
        correct = int(np.sum(preds == labels))
        return {"acc": 100.0 * correct / max(labels.shape[0], 1),
                "predictions": preds, "labels": labels}

    def _evaluate_on_mesh(self, state: TrainState, dataset, *, split):
        """Eval under a data-parallel mesh: the split padded to an
        eval-batch multiple, each rank's rows of every batch through the
        model (a captured forward a batch with ``device_epoch``), the
        predictions gathered from every rank once and put back in order."""
        from ..parallel.data_parallel import _gather_rows

        images, labels = dataset.eval_arrays(split)
        n = images.shape[0]
        bs = self.config.eval_bs
        index, world = self.rows
        nb = max(-(-n // bs), 1)
        padded = np.zeros((nb * bs,) + images.shape[1:], np.float32)
        padded[:n] = images
        per = bs // world
        local = self._layout(torch.as_tensor(np.ascontiguousarray(
            padded.reshape((nb * world, per) + images.shape[1:])
            [index::world])).to(self.device))
        if self.config.device_epoch:
            cached = self._dev_eval.get(split)
            if (cached is None or cached[0] is not dataset
                    or cached[1].model is not state.model):
                runner = EvalRunner(state.model, local.reshape(
                    (nb * per,) + local.shape[2:]), per)
                self._dev_eval[split] = (dataset, runner)
            preds = torch.as_tensor(self._dev_eval[split][1].run()).to(
                self.device)
        else:
            model = state.model
            model.eval()
            with torch.inference_mode():
                preds = torch.cat([model(local[i]).argmax(dim=-1)
                                   for i in range(nb)])
        with torch.no_grad():
            gathered = _gather_rows(self.mesh, preds.reshape(1, nb * per))
        preds = (gathered.reshape(world, nb, per).permute(1, 0, 2)
                 .reshape(-1)[:n].cpu().numpy())
        labels = np.ascontiguousarray(labels)
        correct = int(np.sum(preds == labels))
        return {"acc": 100.0 * correct / max(n, 1), "predictions": preds,
                "labels": labels}

    def refresh_bn_stats(self, state: TrainState, dataset, *, batches=66,
                         batch_size=None, seed=0):
        """Precise-BN refresh: recompute every BatchNorm's running
        statistics under the final weights, by ``batches`` forwards over
        shuffled train images in eval preprocessing (normalised, not
        augmented) with dropout off and only the BatchNorms in batch-stat
        mode; the parameters are untouched.  ``dataset``: an object with
        ``eval_arrays(split='train')`` or an ``(images, labels)`` tuple.
        Updates the model in place and returns the state."""
        bs = batch_size or self.config.batch_size
        if hasattr(dataset, "eval_arrays"):
            images, _ = dataset.eval_arrays(split="train")
        else:
            try:
                images, _ = dataset
            except (TypeError, ValueError):
                raise TypeError(
                    "refresh_bn_stats expects a dataset exposing "
                    ".eval_arrays(split=...) or an (images, labels) tuple; "
                    f"got {type(dataset).__name__!r}") from None
        n = images.shape[0]
        bs = min(bs, n)
        rng = np.random.default_rng(seed)
        # shuffled fixed-shape batches, cycling the split when it is small
        idx = np.concatenate([rng.permutation(n) for _ in
                              range(int(np.ceil(batches * bs / n)))])
        stack = torch.as_tensor(images[idx[:batches * bs]]).reshape(
            (batches, bs) + tuple(images.shape[1:])).to(self.device)
        model = state.model
        model.eval()
        norms = [m for m in model.modules()
                 if isinstance(m, nn.modules.batchnorm._BatchNorm)]
        for m in norms:
            m.train()
        try:
            with torch.no_grad():
                for i in range(batches):
                    if self.rows is not None:  # this rank's rows
                        lo, hi = self._block(bs)
                        model(self._layout(stack[i][lo:hi]))
                    else:
                        model(stack[i])
        finally:
            for m in norms:
                m.eval()
        return state

    def fit(self, state: TrainState, dataset, *, verbose=True,
            checkpoint_dir=None, checkpoint_backend="pickle",
            checkpoint_async=False, checkpoint_every=None,
            start_epoch=None, param_stats_fn=None, metrics_sink=None,
            preemption=None):
        """The whole run: epochs in chunks up to each eval boundary, an
        eval after each chunk, best-accuracy tracking with a 'best'
        checkpoint at each new best, early stopping (counted in evals), a
        rolling 'last' checkpoint every ``checkpoint_every`` epochs (and at
        the end, on an early stop and on a preemption) whose ``extra``
        carries best_acc and patience_count, and the epoch records to
        ``metrics_sink``.

        ``start_epoch`` None derives the epoch to resume at from
        ``state.step`` and the dataset's steps an epoch (capped by
        ``max_steps_per_epoch``).  ``checkpoint_async=True`` saves off the
        training thread and waits for every save before returning.
        ``preemption``: an object whose ``requested`` turns True to stop
        at the next chunk boundary (a ``GracefulPreemption``); the result
        then says ``"preempted": True``."""
        from .checkpoint import (load_checkpoint, save_checkpoint,
                                 save_checkpoint_async, wait_for_checkpoints)

        cfg = self.config
        save = save_checkpoint_async if checkpoint_async else save_checkpoint
        if self.rows is not None:
            save = _rank0_saver(save, self.mesh)
        fuse = (cfg.device_epoch and cfg.multi_epoch_dispatch
                and hasattr(dataset, "train_arrays"))
        best_acc, patience_count = 0.0, 0
        preempted = False
        history = []
        if start_epoch is None:
            spe = (dataset.steps_for_batch(cfg.batch_size)
                   if hasattr(dataset, "steps_for_batch") else None)
            if spe and cfg.max_steps_per_epoch is not None:
                spe = min(spe, cfg.max_steps_per_epoch)
            start_epoch = (min(int(state.step) // spe, cfg.epochs)
                           if spe else 0)
        epoch = start_epoch
        if epoch and checkpoint_dir is not None:
            # the rolling 'last' checkpoint carries best_acc and
            # patience_count, so a resumed run neither overwrites a better
            # 'best' nor restarts the early-stopping count
            try:
                payload = load_checkpoint(checkpoint_dir, tag="last")
            except FileNotFoundError:
                payload = None
            extra = (payload or {}).get("extra")
            if extra and payload.get("step") == int(state.step):
                best_acc = float(extra.get("best_acc", 0.0))
                patience_count = int(extra.get("patience_count", 0))
        if verbose and epoch:
            print(f"Resuming at epoch {epoch + 1}/{cfg.epochs} "
                  f"(step {int(state.step)}, best_acc {best_acc:.2f})")
        stop = False
        while epoch < cfg.epochs and not stop:
            # epochs up to the next eval boundary (an eval after epoch e
            # when (e + 1) % eval_every == 0, and after the last epoch)
            chunk = min(cfg.eval_every - epoch % cfg.eval_every,
                        cfg.epochs - epoch)
            if fuse:
                stats_list = self._run_epochs_on_device(
                    state, dataset, epoch, chunk, verbose=verbose)
                # the weights between the chunk's epochs never reach the
                # host: the statistics are the chunk's end's
                if param_stats_fn is not None and verbose:
                    param_stats_fn(state.model, epoch + chunk - 1)
            else:
                stats_list = []
                for e in range(epoch, epoch + chunk):
                    stats_list.append(
                        self.train_epoch(state, dataset, e, verbose=verbose))
                    if param_stats_fn is not None and verbose:
                        param_stats_fn(state.model, e)
            prev_epoch, epoch = epoch, epoch + chunk
            if epoch % cfg.eval_every == 0 or epoch == cfg.epochs:
                ev = self.evaluate(state, dataset)
                stats_list[-1]["test_acc"] = ev["acc"]
                if verbose:
                    print(f"Epoch {epoch}: Test Acc: {ev['acc']:.2f}%")
                if ev["acc"] > best_acc:
                    best_acc = ev["acc"]
                    patience_count = 0
                    if checkpoint_dir is not None:
                        save(checkpoint_dir, state, tag="best",
                             backend=checkpoint_backend)
                else:
                    patience_count += 1
                if (cfg.early_stop_patience is not None
                        and patience_count >= cfg.early_stop_patience):
                    if verbose:
                        print(f"Early stopping at epoch {epoch}")
                    stop = True
            if (preemption is not None
                    and getattr(preemption, "requested", False)):
                if verbose:
                    what = ("checkpointing" if checkpoint_dir
                            else "no checkpoint dir")
                    print(f"Preemption: stopping after epoch {epoch} "
                          f"({what})")
                stop = preempted = True
            # the rolling 'last' save comes after the eval, so its extra
            # carries the post-eval best_acc and patience_count
            if checkpoint_dir is not None and (preempted or (
                    checkpoint_every and (
                        epoch // checkpoint_every
                        > prev_epoch // checkpoint_every
                        or epoch == cfg.epochs or stop))):
                save(checkpoint_dir, state, tag="last",
                     backend=checkpoint_backend,
                     extra={"best_acc": best_acc,
                            "patience_count": patience_count,
                            "epoch": epoch})
            if metrics_sink is not None:
                for i, rec in enumerate(stats_list):
                    metrics_sink.log({"epoch": prev_epoch + i + 1, **rec})
            history.extend(stats_list)
        if checkpoint_async and checkpoint_dir is not None:
            wait_for_checkpoints()
            if self.rows is not None:
                dist.barrier(group=self.mesh.group)
        return {"best_acc": best_acc, "history": history,
                "preempted": preempted}


def _rank0_saver(save, mesh):
    """``save`` written by rank 0 alone, every rank then waiting at a
    barrier (an asynchronous save is waited for at the end of ``fit``,
    before its own barrier).  A sharded model's checkpoint is gathered by
    every rank, so every rank calls ``save`` and only rank 0 writes."""

    def saver(directory, state, **kwargs):
        if mesh.rank == 0 or getattr(state.model, "tp_layout", None):
            save(directory, state, **kwargs)
        dist.barrier(group=mesh.group)

    return saver


def _epoch_record(stats, epoch, dt, chunk, verbose, log_every=None):
    """An epoch's history record from its (2, steps) float32 losses and
    accuracies, the means taken in float64 on the host (the same in both
    loops); ``verbose`` prints the epoch's line and, with ``log_every``,
    every ``log_every``-th step's."""
    losses, accs = stats
    if verbose and log_every:
        for bi in range(0, losses.shape[0], log_every):
            print(f"Epoch {epoch+1}, Batch {bi}, Loss: {losses[bi]:.4f}, "
                  f"Acc: {100.0*accs[bi]:.2f}%")
    avg_loss = float(np.mean(losses, dtype=np.float64)) if losses.size else 0.0
    avg_acc = (100.0 * float(np.mean(accs, dtype=np.float64))
               if accs.size else 0.0)
    if verbose:
        print(f"Epoch {epoch+1} - Loss: {avg_loss:.4f}, "
              f"Train Acc: {avg_acc:.2f}%, Time: {dt:.2f}s")
    return {"loss": avg_loss, "acc": avg_acc, "time": dt, "chunk": chunk}


def pde_param_stats(model, prefix=""):
    """Mean, std, min and max of every coefficient field (a parameter
    whose name holds 'alpha' or 'beta' and ``prefix``) of ``model``."""
    out = {}
    for name, p in model.named_parameters():
        if prefix in name and ("alpha" in name or "beta" in name):
            arr = p.detach().double()
            out[name] = {"mean": float(arr.mean()),
                         "std": float(arr.std(unbiased=False)),
                         "min": float(arr.min()), "max": float(arr.max())}
    return out
