"""Optimizer — port of ``cnn_pde_tpu/train/optim.py`` (``ParamGroup``,
``_group_labels``, ``build_optimizer``): AdamW with named parameter groups
after a global-norm clip.

Groups are chosen by a substring of the dotted parameter name; a parameter
takes the first group that matches, else the default group.  Each torch
param group carries its ``lr_scale``: the train step sets its lr to
schedule(step)·lr_scale before every update, as optax evaluates the schedule
at the update's count.  ``torch.optim.AdamW`` (decoupled weight decay, bias
corrections, eps outside the square root) computes optax's ``adamw``
update.  ``moment_dtype=torch.bfloat16`` (``--bf16-moments``) takes
``AdamWLowPrecision`` instead: the port of ``scale_by_adam_low_precision``,
float32 arithmetic with both moments stored in bf16, in optax's chain
order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

__all__ = ["ParamGroup", "group_labels", "build_optimizer",
           "AdamWLowPrecision", "clip_by_global_norm_",
           "set_learning_rates"]


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


class AdamWLowPrecision(torch.optim.Optimizer):
    """AdamW with Adam's m and v stored in ``moment_dtype``: each update
    reads them into float32, m ← b1·m + (1 − b1)·g, v ← b2·v + (1 − b2)·g²,
    u = (m/(1 − b1ᵗ))/(√(v/(1 − b2ᵗ)) + eps), then adds the decayed weight
    wd·p and steps p ← p − lr·u (optax's scale_by_adam →
    add_decayed_weights → scale_by_learning_rate), and stores m and v back
    at ``moment_dtype``.  Not torch's semantics, which keep float32
    moments: an opt-in."""

    def __init__(self, params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=1e-4, moment_dtype=torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay,
                                      moment_dtype=moment_dtype))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamWLowPrecision takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    for key in ("exp_avg", "exp_avg_sq"):
                        state[key] = torch.zeros_like(
                            p, dtype=group["moment_dtype"])
                g = p.grad.float()
                m = b1 * state["exp_avg"].float() + (1 - b1) * g
                v = b2 * state["exp_avg_sq"].float() + (1 - b2) * g * g
                state["step"] += 1
                t = state["step"]
                update = (m / (1 - b1 ** t)) / (
                    (v / (1 - b2 ** t)).sqrt() + group["eps"])
                update += group["weight_decay"] * p
                p.sub_(group["lr"] * update)
                state["exp_avg"].copy_(m)
                state["exp_avg_sq"].copy_(v)


def build_optimizer(model, *, groups: Sequence[ParamGroup] = (),
                    default_weight_decay=1e-4, default_lr_scale=1.0,
                    b1=0.9, b2=0.999, eps=1e-8, moment_dtype=None):
    """AdamW over ``model``'s parameters in the groups' order, then the
    default group.  Learning rates start at 0 and are set per step.
    ``moment_dtype``: None keeps float32 moments (``torch.optim.AdamW``);
    ``torch.bfloat16`` stores them in bf16 (``AdamWLowPrecision``)."""
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
    if moment_dtype is not None:
        return AdamWLowPrecision(param_groups, betas=(b1, b2), eps=eps,
                                 moment_dtype=moment_dtype)
    return torch.optim.AdamW(param_groups, lr=0.0, betas=(b1, b2), eps=eps)


def set_learning_rates(optimizer, lr):
    for group in optimizer.param_groups:
        group["lr"] = lr * group.get("lr_scale", 1.0)


@torch.no_grad()
def clip_by_global_norm_(params, max_norm):
    """optax's ``clip_by_global_norm``: g ← g·max_norm/‖g‖ when the global
    norm ‖g‖ of all gradients exceeds ``max_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``).  Each tensor's norm is summed in
    float64 and the global norm rounded to float32 once: a float32 norm
    of a large gradient (the hybrid's 3072 × 3072 K) on the CPU is off by
    3.5e-4 of its value, where XLA's pairwise sum is not.  Returns ‖g‖."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm(g, dtype=torch.float64) for g in grads
    ])).to(grads[0].dtype)
    keep = norm < max_norm  # stays on the device: no host sync
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm
