"""The train step — port of ``cnn_pde_tpu/train/loop.py::Trainer.
_make_train_step``: augment → train-mode forward → label-smoothed CE →
backward → global-norm clip → grouped AdamW at the scheduled learning rate,
in place on the model's device.  The full ``Trainer`` (fit, eval cadence,
checkpoints, early stop, gradient accumulation) is ROADMAP.md A12.

    step = make_train_step(model, PRESETS["cifar10_noconv"]["train"],
                           steps_per_epoch, torch.Generator(device))
    loss, acc = step(images, labels)
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.augment import AugmentSpec, augment
from ..models import set_dropout_generator
from .losses import cross_entropy
from .optim import (ParamGroup, build_optimizer, clip_by_global_norm_,
                    set_learning_rates)
from .schedules import constant, cosine_annealing, onecycle

__all__ = ["make_schedule", "make_train_step", "train_steps"]


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


def make_train_step(model, train_values, steps_per_epoch, generator, *,
                    optimizer=None, moment_dtype=None):
    """``step(images, labels) -> (loss, acc)``, both 0-d tensors on the
    model's device.

    ``train_values``: a preset's ``train`` entry (``presets.py``); its
    ``augment`` may be None for no augmentation.  ``generator``: a
    ``torch.Generator`` on the model's device, for the augmentation draws
    and the dropout masks.  ``optimizer``: by default the preset's grouped
    AdamW (``moment_dtype``: its moments' storage dtype, None for
    float32); any torch optimizer whose param groups carry ``lr_scale`` may
    stand in (the tests' SGD trajectories)."""
    device = next(model.parameters()).device
    if optimizer is None:
        optimizer = build_optimizer(
            model, groups=[ParamGroup(*g)
                           for g in train_values["param_groups"]],
            default_weight_decay=train_values["weight_decay"],
            default_lr_scale=train_values["default_lr_scale"],
            moment_dtype=moment_dtype)
    schedule = make_schedule(train_values, steps_per_epoch)
    spec = (AugmentSpec(**train_values["augment"])
            if train_values.get("augment") else None)
    smoothing = train_values["label_smoothing"]
    clip = train_values["clip_norm"]
    params = list(model.parameters())
    set_dropout_generator(model, generator)
    count = 0

    def step(images, labels):
        nonlocal count
        model.train()
        x = torch.as_tensor(images).to(device=device, dtype=torch.float32)
        y = torch.as_tensor(labels).to(device=device, dtype=torch.long)
        if spec is not None:
            x = augment(spec, x, generator)
        logits = model(x)
        loss = cross_entropy(logits, y, smoothing)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in params:
            # a parameter the forward does not read (ResidualDiffusion's
            # beta_base) gets jax.grad's zero, so AdamW decays it as
            # optax does, where torch would skip it
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if clip is not None:
            clip_by_global_norm_(params, clip)
        set_learning_rates(optimizer, schedule(count))
        optimizer.step()
        count += 1
        acc = (logits.argmax(dim=-1) == y).float().mean()
        return loss.detach(), acc

    step.optimizer = optimizer
    step.schedule = schedule
    return step


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
