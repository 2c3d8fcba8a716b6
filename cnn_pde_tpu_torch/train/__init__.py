"""Training of the port: loss, grouped AdamW with global-norm clipping
(float32 or bf16 moments), the per-epoch cosine and per-batch OneCycle
schedules and the train step of the ported presets."""

from .losses import cross_entropy
from .optim import ParamGroup, build_optimizer, clip_by_global_norm_
from .schedules import constant, cosine_annealing, onecycle
from .step import make_train_step, train_steps

__all__ = ["cross_entropy", "ParamGroup", "build_optimizer",
           "clip_by_global_norm_", "constant", "cosine_annealing",
           "onecycle",
           "make_train_step", "train_steps"]
