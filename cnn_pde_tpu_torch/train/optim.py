"""Optimizer — port of ``cnn_pde_tpu/train/optim.py`` (``ParamGroup``,
``_group_labels``, ``build_optimizer``): AdamW with named parameter groups
after a global-norm clip.

Groups are chosen by a substring of the dotted parameter name; a parameter
takes the first group that matches, else the default group.  Each torch
param group carries its ``lr_scale``: the train step sets its lr to
schedule(step)·lr_scale before every update, as optax evaluates the schedule
at the update's count.  ``OptaxAdamW`` computes optax's ``adamw`` update,
and with ``moment_dtype=torch.bfloat16`` (``--bf16-moments``) its
``scale_by_adam_low_precision``: float32 arithmetic with both moments
stored in bf16, in optax's chain order.  Its learning rates and update
count live on the parameters' device, so that a CUDA graph of the train
step (``train/graph.py``) stays right at every replay; the eager step
runs the same update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

__all__ = ["ParamGroup", "group_labels", "build_optimizer",
           "OptaxAdamW", "clip_by_global_norm_",
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


class OptaxAdamW(torch.optim.Optimizer):
    """optax's ``adamw`` (``scale_by_adam`` → ``add_decayed_weights`` →
    ``scale_by_learning_rate``) with Adam's m and v stored in
    ``moment_dtype`` (None: the parameters' dtype): each update reads them
    into float32, m ← b1·m + (1 − b1)·g, v ← b2·v + (1 − b2)·g²,
    u = (m/(1 − b1ᵗ))/(√(v/(1 − b2ᵗ)) + eps) + wd·p, p ← p − lr·u, and
    stores m and v back.

    Each group's ``lr`` and update count t are 0-d float32 tensors on the
    parameters' device, read and advanced there, and the update is written
    with ``torch._foreach_*`` ops, so that one ``step()`` captured in a
    CUDA graph is right at every replay; the train step writes the learning
    rates (``set_learning_rates``, or its table on the device).

    ``load_state_dict`` copies into the tensors it has, so that a captured
    graph still reads them after a checkpoint's restore, and the moments
    keep ``moment_dtype`` (torch's copy would cast them to the
    parameters')."""

    def __init__(self, params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=1e-4, moment_dtype=None):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay,
                                      moment_dtype=moment_dtype))
        for group in self.param_groups:
            device = group["params"][0].device
            group["lr"] = torch.tensor(float(group["lr"]),
                                       dtype=torch.float32, device=device)
            group["step"] = torch.zeros((), dtype=torch.float32,
                                        device=device)

    def init_state(self):
        """Make every parameter's moments now (zeros), not at its first
        update: a graph captures reads of tensors that exist."""
        for group in self.param_groups:
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    dtype = group["moment_dtype"] or p.dtype
                    for key in ("exp_avg", "exp_avg_sq"):
                        state[key] = torch.zeros_like(p, dtype=dtype)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxAdamW takes no closure")
        self.init_state()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if params:
                self._update(group, params)

    def _update(self, group, params):
        b1, b2 = group["betas"]
        t = group["step"]
        t.add_(1.0)
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        grads = [p.grad.float() for p in params]
        ms = [self.state[p]["exp_avg"] for p in params]
        vs = [self.state[p]["exp_avg_sq"] for p in params]
        m = torch._foreach_mul([x.float() for x in ms], b1)
        torch._foreach_add_(m, torch._foreach_mul(grads, 1 - b1))
        v = torch._foreach_mul([x.float() for x in vs], b2)
        gg = torch._foreach_mul(grads, 1 - b2)
        torch._foreach_mul_(gg, grads)
        torch._foreach_add_(v, gg)
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group["eps"])
        update = torch._foreach_div(m, bc1)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(update, torch._foreach_mul(
            params, group["weight_decay"]))
        torch._foreach_mul_(update, group["lr"])
        torch._foreach_sub_(params, update)
        torch._foreach_copy_(ms, m)
        torch._foreach_copy_(vs, v)

    def load_state_dict(self, state_dict):
        saved_groups = state_dict["param_groups"]
        if len(saved_groups) != len(self.param_groups) or any(
                len(s["params"]) != len(g["params"])
                for s, g in zip(saved_groups, self.param_groups)):
            raise ValueError("the saved optimizer has other parameter groups")
        self.init_state()
        for group, saved in zip(self.param_groups, saved_groups):
            for key in ("lr", "step"):
                group[key].copy_(torch.as_tensor(saved[key]))
            for p, pid in zip(group["params"], saved["params"]):
                moments = state_dict["state"].get(pid)  # None: no update yet
                for key, t in self.state[p].items():
                    if moments:
                        t.copy_(moments[key])
                    else:
                        t.zero_()


def build_optimizer(model, *, groups: Sequence[ParamGroup] = (),
                    default_weight_decay=1e-4, default_lr_scale=1.0,
                    b1=0.9, b2=0.999, eps=1e-8, moment_dtype=None):
    """``OptaxAdamW`` over ``model``'s parameters in the groups' order,
    then the default group.  Learning rates start at 0 and are set per
    step.  ``moment_dtype``: None keeps float32 moments,
    ``torch.bfloat16`` stores them in bf16."""
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
    return OptaxAdamW(param_groups, betas=(b1, b2), eps=eps,
                      moment_dtype=moment_dtype)


def set_learning_rates(optimizer, lr):
    """Each group's learning rate to ``lr``·lr_scale (written into the
    group's lr tensor where it has one)."""
    for group in optimizer.param_groups:
        value = lr * group.get("lr_scale", 1.0)
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(value)
        else:
            group["lr"] = value


@torch.no_grad()
def clip_by_global_norm_(params, max_norm, model=None):
    """optax's ``clip_by_global_norm``: g ← g·max_norm/‖g‖ when the global
    norm ‖g‖ of all gradients exceeds ``max_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``).  Each tensor's squared norm is
    taken in float64 and the global norm rounded to float32 once: a
    float32 norm of a large gradient (the hybrid's 3072 × 3072 K) on the
    CPU is off by 3.5e-4 of its value, where XLA's pairwise sum is not.

    ``model``: the model of ``params``.  Where it is sharded by tensor
    parallelism the squares of its sharded blocks are summed over the
    model axis and the others counted once
    (``parallel.tensor_parallel.model_total``): ‖g‖ is the unsharded
    model's.  Returns ‖g‖."""
    from ..parallel.tensor_parallel import model_total

    params = [p for p in params if p.grad is not None]
    names = ({id(p): n for n, p in model.named_parameters()}
             if model is not None else {})
    grads = [p.grad for p in params]
    norm = model_total(model, [
        (names.get(id(p)),
         torch.linalg.vector_norm(p.grad, dtype=torch.float64).square())
        for p in params]).sqrt().to(grads[0].dtype)
    keep = norm < max_norm  # stays on the device: no host sync
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm
