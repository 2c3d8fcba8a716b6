"""Training of the port: loss and the hybrid regulariser, grouped AdamW
with global-norm clipping (float32 or bf16 moments; learning rates and
update count on the device), the per-epoch cosine and per-batch OneCycle schedules, the train
step of every preset, and the ``Trainer`` that fits, evaluates,
checkpoints and resumes, on the host loop or the device epoch (a CUDA
graph of the step, ``graph.py``)."""

from .losses import cross_entropy, hybrid_pde_regularization
from .loop import (GracefulPreemption, TrainConfig, Trainer, TrainState,
                   pde_param_stats)
from .optim import ParamGroup, build_optimizer, clip_by_global_norm_
from .schedules import constant, cosine_annealing, onecycle
from .step import TrainStep, make_train_step, preset_optimizer, train_steps

__all__ = ["cross_entropy", "hybrid_pde_regularization", "ParamGroup",
           "build_optimizer", "clip_by_global_norm_", "constant",
           "cosine_annealing", "onecycle", "make_train_step", "TrainStep",
           "preset_optimizer", "train_steps", "GracefulPreemption",
           "TrainConfig", "Trainer", "TrainState", "pde_param_stats"]
