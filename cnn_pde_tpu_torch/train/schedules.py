"""Learning-rate schedules — port of ``cnn_pde_tpu/train/schedules.py``
(``cosine_annealing``, ``constant``).  A schedule is a function of the
global step; the cosine is torch's CosineAnnealingLR stepped once per epoch,
so the step is floor-divided by ``steps_per_epoch``."""

from __future__ import annotations

import math

__all__ = ["cosine_annealing", "constant"]


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
