"""Learning-rate schedules — port of ``cnn_pde_tpu/train/schedules.py``
(``cosine_annealing``, ``onecycle``, ``constant``).  A schedule is a
function of the global step; the cosine is torch's CosineAnnealingLR
stepped once per epoch, so the step is floor-divided by
``steps_per_epoch``; ``onecycle`` is stepped once per batch."""

from __future__ import annotations

import math

__all__ = ["cosine_annealing", "onecycle", "constant"]


def constant(lr):
    return lambda step: float(lr)


def cosine_annealing(base_lr, t_max, steps_per_epoch, eta_min=0.0):
    """lr(e) = eta_min + (base − eta_min)·(1 + cos(π·e/T_max))/2 with
    e = step // steps_per_epoch."""

    def schedule(step):
        epoch = step // steps_per_epoch
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * epoch / t_max))

    return schedule


def onecycle(max_lr, total_steps, pct_start=0.3, div_factor=25.0,
             final_div_factor=1e4):
    """torch's OneCycleLR with cosine annealing, stepped per batch: from
    max_lr/div_factor up to max_lr over pct_start of the steps, then down
    to max_lr/(div_factor·final_div_factor); constant past the last."""
    initial = max_lr / div_factor
    final = initial / final_div_factor
    up_steps = float(pct_start * total_steps) - 1.0
    down_steps = float(total_steps - 1) - up_steps

    def _cos(a, b, pct):
        return b + (a - b) * 0.5 * (1.0 + math.cos(math.pi * pct))

    def schedule(step):
        step = float(min(step, total_steps - 1))
        if step <= up_steps:
            return _cos(initial, max_lr,
                        min(max(step / max(up_steps, 1.0), 0.0), 1.0))
        return _cos(max_lr, final, min(max(
            (step - up_steps) / max(down_steps, 1.0), 0.0), 1.0))

    return schedule
