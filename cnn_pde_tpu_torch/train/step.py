"""The train step — port of ``cnn_pde_tpu/train/loop.py::Trainer.
_make_train_step``: augment → train-mode forward → label-smoothed CE (+ the
preset's regulariser) → backward → global-norm clip → grouped AdamW at the
scheduled learning rate, in place on the model's device; with
``grad_accum=k``, optax.MultiSteps' accumulation.  ``train/loop.py::
Trainer`` runs it over epochs.

    step = make_train_step(model, PRESETS["cifar10_noconv"]["train"],
                           steps_per_epoch, torch.Generator(device))
    loss, acc = step(images, labels)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data.augment import AugmentSpec, augment
from ..models import set_dropout_generator
from .losses import cross_entropy, hybrid_pde_regularization
from .optim import (OptaxAdamW, ParamGroup, build_optimizer,
                    clip_by_global_norm_, set_learning_rates)
from .schedules import constant, cosine_annealing, onecycle

__all__ = ["make_schedule", "make_train_step", "TrainStep",
           "preset_optimizer", "train_steps"]


def make_schedule(train_values, steps_per_epoch):
    """The preset's schedule as a function of the global step."""
    if train_values["schedule"] == "cosine":
        kw = train_values.get("schedule_kwargs", {})
        return cosine_annealing(train_values["lr"],
                                kw.get("t_max", train_values["epochs"]),
                                steps_per_epoch, kw.get("eta_min", 0.0))
    if train_values["schedule"] == "onecycle":
        kw = train_values.get("schedule_kwargs", {})
        return onecycle(kw.get("max_lr", train_values["lr"]),
                        total_steps=train_values["epochs"] * steps_per_epoch,
                        pct_start=kw.get("pct_start", 0.3))
    if train_values["schedule"] == "constant":
        return constant(train_values["lr"])
    raise ValueError(f"unknown schedule {train_values['schedule']!r}")


def preset_optimizer(model, train_values, moment_dtype=None):
    """The preset's grouped AdamW over ``model`` (``moment_dtype``: its
    moments' storage dtype, None for float32)."""
    return build_optimizer(
        model, groups=[ParamGroup(*g) for g in train_values["param_groups"]],
        default_weight_decay=train_values["weight_decay"],
        default_lr_scale=train_values["default_lr_scale"],
        moment_dtype=moment_dtype)


def make_train_step(model, train_values, steps_per_epoch, generator, *,
                    optimizer=None, moment_dtype=None, schedule=None,
                    grad_accum=1, mesh=None, image_spec=None):
    """``step(images, labels) -> (loss, acc)``, both 0-d tensors on the
    model's device: a ``TrainStep``.

    ``train_values``: a preset's ``train`` entry (``presets.py``); its
    ``augment`` may be None for no augmentation, and its ``regularizer``
    (the alphas of ``hybrid_pde_regularization``) is added to the loss
    before the backward.  ``generator``: a ``torch.Generator`` on the
    model's device, for the augmentation draws and the dropout masks.
    ``optimizer``: by default the preset's grouped AdamW
    (``preset_optimizer``); any torch optimizer whose param groups carry
    ``lr_scale`` may stand in (the tests' SGD trajectories).
    ``schedule``: the learning rate as a function of the update count; by
    default the preset's over ``steps_per_epoch`` updates an epoch.

    ``grad_accum=k`` (optax.MultiSteps): each step's gradients go into a
    running mean, acc ← acc + (g − acc)/(i + 1) over the i-th micro-batch
    of k, and every k-th step the mean is clipped and applied once; the
    schedule advances once an update.  ``step.state_dict()`` and
    ``step.load_state_dict(d)`` carry the update count, the micro-step and
    the running mean across a checkpoint.

    ``mesh`` (``parallel.make_mesh()`` inside a process group): the step
    of one rank of a data-parallel run, called on its rows of each global
    batch (``parallel/data_parallel.py``); of a tensor-parallel one when
    the model is sharded (``parallel/tensor_parallel.py``).
    ``image_spec`` (a tuple of axis names or None a dim): the images cut
    to this rank's block of each dim it shards after the augmentation
    (a spatial classifier's H, ``parallel/spatial_model.py``)."""
    return TrainStep(model, train_values, steps_per_epoch, generator,
                     optimizer=optimizer, moment_dtype=moment_dtype,
                     schedule=schedule, grad_accum=grad_accum, mesh=mesh,
                     image_spec=image_spec)


class TrainStep:
    """The train step of ``make_train_step``.  ``body(x, y, apply)`` is
    its work on a batch already on the device, written so that a CUDA
    graph can capture it (``train/graph.py``): no host sync, and every
    value that changes from step to step read on the device:

    * the gradients are zeroed in place, and a parameter the forward does
      not read keeps the zero gradient it got once;
    * the micro-step of the running mean is a device scalar, and the host
      picks the body ("accumulate", or "accumulate and apply" on the k-th
      micro-step) from its own count, which the graph's replays follow;
    * with ``OptaxAdamW`` (the preset's optimizer) each update's learning
      rates come from a table of the schedule on the device, read at the
      device's update count; another optimizer a caller passes (the
      tests' SGD) gets them from the host (``set_learning_rates``) and
      cannot be captured.

    ``__call__`` runs ``body`` eagerly on a host batch and advances the
    host's counts (``updates``, ``micro``)."""

    def __init__(self, model, train_values, steps_per_epoch, generator, *,
                 optimizer=None, moment_dtype=None, schedule=None,
                 grad_accum=1, mesh=None, image_spec=None):
        self.device = device = next(model.parameters()).device
        self.model = model
        self.generator = generator
        if optimizer is None:
            optimizer = preset_optimizer(model, train_values, moment_dtype)
        self.optimizer = optimizer
        self.schedule = (make_schedule(train_values, steps_per_epoch)
                         if schedule is None else schedule)
        self.spec = None
        if train_values.get("augment"):
            spec = AugmentSpec(**train_values["augment"])
            if spec.mean is not None:  # on the device once, not a step
                spec = dataclasses.replace(
                    spec, mean=torch.tensor(spec.mean, device=device),
                    std=torch.tensor(spec.std, device=device))
            self.spec = spec
        self.smoothing = train_values["label_smoothing"]
        self.clip = train_values["clip_norm"]
        self.alphas = train_values.get("regularizer")
        self.k = int(grad_accum or 1)
        if self.k < 1:
            raise ValueError(f"grad_accum must be at least 1: {grad_accum}")
        self.params = list(model.parameters())
        # over a process group, this rank's part of the global step
        # (parallel/data_parallel.py): its share of the loss, the summed
        # gradients, global BatchNorm statistics and global draws
        self.reducer = None
        if mesh is not None:
            from ..parallel.data_parallel import StepReducer, _check_mesh

            _check_mesh(mesh)
            if mesh.group is not None:
                self.reducer = StepReducer(mesh, model, self.params)
        self.rows = self.reducer.rows if self.reducer is not None else None
        self.mesh, self.image_spec = mesh, image_spec
        set_dropout_generator(model, generator, rows=self.rows)
        self.capturable = isinstance(self.optimizer, OptaxAdamW)
        self.updates = self.micro = 0  # the host's counts
        self.micro_t = torch.zeros((), device=device)
        self.update_t = torch.zeros((1,), dtype=torch.int64, device=device)
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.k > 1 else None)
        self.lr_table = None  # (groups, updates), for OptaxAdamW

    def __call__(self, images, labels):
        x = torch.as_tensor(images).to(device=self.device,
                                       dtype=torch.float32)
        y = torch.as_tensor(labels).to(device=self.device, dtype=torch.long)
        apply = self.applies()
        if apply:
            self.reserve_updates(self.updates + 1)
        loss, acc = self.body(x, y, apply)
        self.advance(apply)
        return loss, acc

    def applies(self):
        """Whether the next step applies an update (its k-th micro-step)."""
        return self.micro == self.k - 1

    def advance(self, apply):
        """The host's counts after a step (``apply``: it updated)."""
        self.micro = 0 if apply else self.micro + 1
        self.updates += int(apply)

    def reserve_updates(self, n):
        """Make the learning-rate table cover updates [0, n) (for
        ``OptaxAdamW``), the schedule evaluated once an update.  A grown
        table is a new tensor: a graph captured before reads the old one,
        so ``train/graph.py`` reserves the whole run before it captures."""
        have = 0 if self.lr_table is None else self.lr_table.shape[1]
        if not self.capturable or have >= n:
            return
        lrs = np.array([self.schedule(u) for u in range(have,
                                                        max(n, 2 * have))],
                       np.float64)
        scales = np.array([g.get("lr_scale", 1.0)
                           for g in self.optimizer.param_groups], np.float64)
        # each entry rounded once from float64, as set_learning_rates' fill
        new = torch.tensor(scales[:, None] * lrs[None], dtype=torch.float32,
                           device=self.device)
        self.lr_table = (new if self.lr_table is None
                         else torch.cat([self.lr_table, new], dim=1))

    def body(self, x, y, apply):
        """One step on the device batch (x, y): augment, train-mode
        forward, loss, backward, then accumulate, and with ``apply`` clip
        and update.  Returns the loss and the accuracy, 0-d tensors."""
        model = self.model
        model.train()
        if self.spec is not None:
            x = augment(self.spec, x, self.generator, self.rows)
        if self.image_spec is not None:
            from ..parallel.data_parallel import spec_block

            x = spec_block(self.mesh, x, self.image_spec)
        logits = model(x)
        loss = cross_entropy(logits, y, self.smoothing)
        if self.alphas is not None:
            loss = loss + hybrid_pde_regularization(model, *self.alphas)
        if self.reducer is not None:
            # this rank's share: its rows' sum over the global batch
            loss = loss / self.reducer.world
        grads = [p.grad for p in self.params if p.grad is not None]
        if grads:
            torch._foreach_zero_(grads)
        loss.backward()
        for p in self.params:
            # a parameter the forward does not read (ResidualDiffusion's
            # beta_base) gets jax.grad's zero, so AdamW decays it as optax
            # does, where torch would skip it; made once, zeroed in place
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        with torch.no_grad():
            if self.reducer is not None:
                acc = (logits.argmax(dim=-1) == y).float().mean()
                loss, acc = self.reducer.reduce(
                    [p.grad for p in self.params], loss.detach(),
                    acc / self.reducer.world)
            if self.k > 1:
                self._accumulate(apply)
            if apply:
                if self.clip is not None:
                    clip_by_global_norm_(self.params, self.clip, self.model)
                if self.capturable:
                    lrs = self.lr_table.index_select(1, self.update_t)
                    for g, group in enumerate(self.optimizer.param_groups):
                        group["lr"].copy_(lrs[g, 0])
                else:
                    set_learning_rates(self.optimizer,
                                       self.schedule(self.updates))
                self.optimizer.step()
                self.update_t.add_(1)
            if self.reducer is None:
                acc = (logits.argmax(dim=-1) == y).float().mean()
        return loss.detach(), acc

    def _accumulate(self, apply):
        """Fold the gradients into the running mean as optax.MultiSteps
        does; on the k-th micro-step put the mean into the gradients and
        reset."""
        grads = [p.grad for p in self.params]
        delta = torch._foreach_sub(grads, self.acc)
        torch._foreach_add_(self.acc, torch._foreach_div(
            delta, self.micro_t + 1.0))
        if apply:
            torch._foreach_copy_(grads, self.acc)
            torch._foreach_zero_(self.acc)
            self.micro_t.zero_()
        else:
            self.micro_t.add_(1.0)

    def state_dict(self):
        return {"updates": self.updates, "micro": self.micro,
                "acc": (None if self.acc is None
                        else [a.clone() for a in self.acc])}

    def load_state_dict(self, d):
        """The counts and running mean of a checkpoint, written into this
        step's tensors (a captured graph keeps reading them)."""
        self.updates, self.micro = int(d["updates"]), int(d["micro"])
        self.update_t.fill_(self.updates)
        self.micro_t.fill_(self.micro)
        if self.acc is not None:
            for a, saved in zip(self.acc, d["acc"] or [0.0] * len(self.acc)):
                a.copy_(torch.as_tensor(saved))


def train_steps(step, data, n, batch_size, seed=0):
    """Run ``n`` steps over shuffled batches of ``data`` = (images, labels)
    (numpy or tensors), a new permutation each epoch from
    ``np.random.default_rng(seed + epoch)`` as the JAX loop draws them; the
    last incomplete batch of an epoch is dropped.  Returns the losses as a
    list of floats (one host sync, at the end)."""
    images, labels = (torch.as_tensor(a) for a in data)
    per_epoch = max(images.shape[0] // batch_size, 1)
    losses = []
    for i in range(n):
        epoch, k = divmod(i, per_epoch)
        if k == 0:
            perm = torch.from_numpy(np.random.default_rng(seed + epoch)
                                    .permutation(images.shape[0]))
        idx = perm[k * batch_size:(k + 1) * batch_size]
        loss, _ = step(images[idx], labels[idx])
        losses.append(loss)
    return torch.stack(losses).tolist() if losses else []
