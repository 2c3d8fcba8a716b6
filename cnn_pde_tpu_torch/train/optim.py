"""Optimizer — port of ``cnn_pde_tpu/train/optim.py`` (``ParamGroup``,
``_group_labels``, ``build_optimizer``): AdamW with named parameter groups
after a global-norm clip.

Groups are chosen by a substring of the dotted parameter name; a parameter
takes the first group that matches, else the default group.  Each torch
param group carries its ``lr_scale``: the train step sets its lr to
schedule(step)·lr_scale before every update, as optax evaluates the schedule
at the update's count.  ``torch.optim.AdamW`` (decoupled weight decay, bias
corrections, eps outside the square root) computes optax's ``adamw``
update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

__all__ = ["ParamGroup", "group_labels", "build_optimizer",
           "clip_by_global_norm_", "set_learning_rates"]


@dataclass(frozen=True)
class ParamGroup:
    match_substrings: Sequence[str]
    lr_scale: float = 1.0
    weight_decay: float = 1e-4


def group_labels(model, groups: Sequence[ParamGroup]) -> dict:
    """{parameter name: index of its group as a string, or 'default'}."""
    def label(name):
        for gi, g in enumerate(groups):
            if any(s in name for s in g.match_substrings):
                return str(gi)
        return "default"

    return {name: label(name) for name, _ in model.named_parameters()}


def build_optimizer(model, *, groups: Sequence[ParamGroup] = (),
                    default_weight_decay=1e-4, default_lr_scale=1.0,
                    b1=0.9, b2=0.999, eps=1e-8):
    """AdamW over ``model``'s parameters in the groups' order, then the
    default group.  Learning rates start at 0 and are set per step."""
    labels = group_labels(model, groups)
    settings = [(str(gi), g.lr_scale, g.weight_decay)
                for gi, g in enumerate(groups)]
    settings.append(("default", default_lr_scale, default_weight_decay))
    param_groups = []
    for key, lr_scale, wd in settings:
        params = [p for n, p in model.named_parameters() if labels[n] == key]
        if params:
            param_groups.append({"params": params, "lr_scale": lr_scale,
                                 "weight_decay": wd, "name": key})
    return torch.optim.AdamW(param_groups, lr=0.0, betas=(b1, b2), eps=eps)


def set_learning_rates(optimizer, lr):
    for group in optimizer.param_groups:
        group["lr"] = lr * group.get("lr_scale", 1.0)


@torch.no_grad()
def clip_by_global_norm_(params, max_norm):
    """optax's ``clip_by_global_norm``: g ← g·max_norm/‖g‖ when the global
    norm ‖g‖ of all gradients exceeds ``max_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``).  Returns ‖g‖."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    keep = norm < max_norm  # stays on the device: no host sync
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm
