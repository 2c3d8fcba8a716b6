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

import numpy as np
import torch

from ..data.augment import AugmentSpec, augment
from ..models import set_dropout_generator
from .losses import cross_entropy, hybrid_pde_regularization
from .optim import (ParamGroup, build_optimizer, clip_by_global_norm_,
                    set_learning_rates)
from .schedules import constant, cosine_annealing, onecycle

__all__ = ["make_schedule", "make_train_step", "preset_optimizer",
           "train_steps"]


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
                    grad_accum=1):
    """``step(images, labels) -> (loss, acc)``, both 0-d tensors on the
    model's device.

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
    the running mean across a checkpoint."""
    device = next(model.parameters()).device
    if optimizer is None:
        optimizer = preset_optimizer(model, train_values, moment_dtype)
    if schedule is None:
        schedule = make_schedule(train_values, steps_per_epoch)
    spec = (AugmentSpec(**train_values["augment"])
            if train_values.get("augment") else None)
    smoothing = train_values["label_smoothing"]
    clip = train_values["clip_norm"]
    alphas = train_values.get("regularizer")
    k = int(grad_accum or 1)
    if k < 1:
        raise ValueError(f"grad_accum must be at least 1: {grad_accum}")
    params = list(model.parameters())
    set_dropout_generator(model, generator)
    state = {"updates": 0, "micro": 0, "acc": None}

    def step(images, labels):
        model.train()
        x = torch.as_tensor(images).to(device=device, dtype=torch.float32)
        y = torch.as_tensor(labels).to(device=device, dtype=torch.long)
        if spec is not None:
            x = augment(spec, x, generator)
        logits = model(x)
        loss = cross_entropy(logits, y, smoothing)
        if alphas is not None:
            loss = loss + hybrid_pde_regularization(model, *alphas)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in params:
            # a parameter the forward does not read (ResidualDiffusion's
            # beta_base) gets jax.grad's zero, so AdamW decays it as
            # optax does, where torch would skip it
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if k > 1 and not _accumulate(params, state, k):
            optimizer.zero_grad(set_to_none=True)
        else:
            if clip is not None:
                clip_by_global_norm_(params, clip)
            set_learning_rates(optimizer, schedule(state["updates"]))
            optimizer.step()
            state["updates"] += 1
        acc = (logits.argmax(dim=-1) == y).float().mean()
        return loss.detach(), acc

    def state_dict():
        acc = state["acc"]
        return {"updates": state["updates"], "micro": state["micro"],
                "acc": None if acc is None else [a.clone() for a in acc]}

    def load_state_dict(d):
        state["updates"], state["micro"] = int(d["updates"]), int(d["micro"])
        state["acc"] = (None if d["acc"] is None else
                        [a.to(p.device) for a, p in zip(d["acc"], params)])

    step.optimizer = optimizer
    step.schedule = schedule
    step.state_dict = state_dict
    step.load_state_dict = load_state_dict
    return step


@torch.no_grad()
def _accumulate(params, state, k):
    """Fold the gradients of ``params`` into ``state``'s running mean as
    optax.MultiSteps does; on the k-th micro-step put the mean into the
    gradients, reset, and return True."""
    if state["acc"] is None:
        state["acc"] = [torch.zeros_like(p) for p in params]
    i = state["micro"]
    for p, a in zip(params, state["acc"]):
        a.add_((p.grad - a) / (i + 1))
    if i < k - 1:
        state["micro"] = i + 1
        return False
    for p, a in zip(params, state["acc"]):
        p.grad.copy_(a)
        a.zero_()
    state["micro"] = 0
    return True


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
