"""The values of the JAX presets that the port's CLIs need
(``cnn_pde_tpu/utils/config.py``), copied so the port imports nothing of
the JAX package; the synthetic specs and normalisation constants live in
``data/synthetic.py`` and ``data/real.py``, as in the JAX package, and are
re-exported here."""

from __future__ import annotations

from .data.real import NORMALIZATION
from .data.synthetic import SYNTHETIC_SPECS

__all__ = ["PRESETS", "SYNTHETIC_SPECS", "NORMALIZATION", "get_preset"]

# Each preset: the reference script's training values, with label smoothing
# 0.1, a global-norm clip of 1, an eval every epoch, no early stop and no
# regulariser unless it says otherwise.  "regularizer" holds the alphas of
# train/losses.py::hybrid_pde_regularization; "eval_every" counts epochs,
# "early_stop_patience" evals.
PRESETS = {
    # mnist_test.py:263-345 of the reference: 1 epoch, batch 128, AdamW
    # 1e-3 / wd 1e-4 in one group, cosine with T_max = 3 stepped per epoch
    "mnist": {
        "name": "mnist", "model": "mnist", "dataset": "mnist",
        "model_kwargs": {},
        "train": {
            "epochs": 1, "batch_size": 128, "lr": 1e-3,
            "weight_decay": 1e-4, "schedule": "cosine",
            "schedule_kwargs": {"t_max": 3}, "label_smoothing": 0.1,
            "clip_norm": 1.0, "default_lr_scale": 1.0, "param_groups": (),
            "augment": {"rotation": 5.0, "translate": 0.05},
        },
    },
    # fashion_mnist.py:256-331: 25 epochs, batch 128, AdamW 2e-3 / wd 5e-4,
    # cosine with T_max = 5
    "fashion_mnist": {
        "name": "fashion_mnist", "model": "fashion_mnist",
        "dataset": "fashion_mnist", "model_kwargs": {},
        "train": {
            "epochs": 25, "batch_size": 128, "lr": 2e-3,
            "weight_decay": 5e-4, "schedule": "cosine",
            "schedule_kwargs": {"t_max": 5}, "label_smoothing": 0.1,
            "clip_norm": 1.0, "default_lr_scale": 1.0, "param_groups": (),
            "augment": {
                "rotation": 10.0, "translate": 0.1, "hflip": 0.5,
                "mean": NORMALIZATION["fashion_mnist"][0],
                "std": NORMALIZATION["fashion_mnist"][1]},
        },
    },
    # SVHN.py:300-406: 15 epochs, batch 256, AdamW 1e-2 / wd 1e-4,
    # OneCycleLR (max 1e-2) stepped per batch, cross-entropy without
    # smoothing, normalisation only, an eval every 2 epochs
    "svhn": {
        "name": "svhn", "model": "svhn", "dataset": "svhn",
        "model_kwargs": {},
        "train": {
            "epochs": 15, "batch_size": 256, "lr": 1e-2,
            "weight_decay": 1e-4, "schedule": "onecycle",
            "schedule_kwargs": {"max_lr": 1e-2}, "label_smoothing": 0.0,
            "clip_norm": 1.0, "default_lr_scale": 1.0, "param_groups": (),
            "eval_every": 2,
            "augment": {"mean": NORMALIZATION["svhn"][0],
                        "std": NORMALIZATION["svhn"][1]},
        },
    },
    # cifar10.py:400-527: 20 epochs, batch 64, two-group AdamW (α/β at lr
    # with weight decay 1e-6, the rest at lr·0.5 with 1e-4), cosine with
    # T_max = epochs stepped per epoch
    "cifar10_noconv": {
        "name": "cifar10_noconv", "model": "cifar10_noconv",
        "dataset": "cifar10", "model_kwargs": {},
        "train": {
            "epochs": 20, "batch_size": 64, "lr": 1e-3,
            "weight_decay": 1e-4, "schedule": "cosine",
            "schedule_kwargs": {}, "label_smoothing": 0.1, "clip_norm": 1.0,
            "default_lr_scale": 0.5,
            # (match substrings, lr scale, weight decay)
            "param_groups": ((("alpha", "beta"), 1.0, 1e-6),),
            "augment": {
                "crop_padding": 4, "hflip": 0.5, "rotation": 10.0,
                "brightness": 0.2, "contrast": 0.2, "saturation": 0.2,
                "hue": 0.1, "erasing_p": 0.1,
                "mean": NORMALIZATION["cifar10"][0],
                "std": NORMALIZATION["cifar10"][1]},
        },
    },
    # cifar_2version.py:470-595: 25 epochs, batch 64, one group (α, β,
    # channel mixing and the combination weights at lr with weight decay
    # 1e-6), the rest at lr·0.8 with 1e-4, cosine with T_max = epochs
    # stepped per epoch, the hybrid regulariser with (2e-4, 1e-4, 1e-6)
    "cifar10_hybrid": {
        "name": "cifar10_hybrid", "model": "cifar10_hybrid",
        "dataset": "cifar10", "model_kwargs": {},
        "train": {
            "epochs": 25, "batch_size": 64, "lr": 1e-3,
            "weight_decay": 1e-4, "schedule": "cosine",
            "schedule_kwargs": {}, "label_smoothing": 0.1, "clip_norm": 1.0,
            "default_lr_scale": 0.8,
            "param_groups": ((("alpha", "beta", "channel_mixing",
                               "combination_weights"), 1.0, 1e-6),),
            "regularizer": (2e-4, 1e-4, 1e-6),
            "augment": {
                "crop_padding": 4, "hflip": 0.5, "rotation": 10.0,
                "brightness": 0.2, "contrast": 0.2, "saturation": 0.2,
                "hue": 0.1, "erasing_p": 0.1,
                "mean": NORMALIZATION["cifar10"][0],
                "std": NORMALIZATION["cifar10"][1]},
        },
    },
    # emotion_recognition.py:265-369: up to 70 epochs, batch 64, AdamW 1e-3
    # / wd 1e-4, cosine with T_max = 70 and eta_min 1e-6 stepped per epoch,
    # no label smoothing and no grad clip (its train loop is the one
    # without), hflip and rotation with no normalisation; an eval every 5
    # epochs, stopping after 10 evals without a better test accuracy
    "emotion": {
        "name": "emotion", "model": "emotion", "dataset": "emotion",
        "model_kwargs": {},
        "train": {
            "epochs": 70, "batch_size": 64, "lr": 1e-3,
            "weight_decay": 1e-4, "schedule": "cosine",
            "schedule_kwargs": {"t_max": 70, "eta_min": 1e-6},
            "label_smoothing": 0.0, "clip_norm": None,
            "default_lr_scale": 1.0, "param_groups": (),
            "eval_every": 5, "early_stop_patience": 10,
            "augment": {"hflip": 0.5, "rotation": 10.0},
        },
    },
    # tiny_imagenet.py:517-621: 10 epochs, batch 32, OneCycle (max 1e-2,
    # pct_start 0.1) stepped per batch, Resize(72) + RandomCrop(64), hflip,
    # colour jitter and ImageNet normalisation, 200 classes
    "tiny_imagenet": {
        "name": "tiny_imagenet", "model": "tiny_imagenet",
        "dataset": "tiny_imagenet", "model_kwargs": {"num_classes": 200},
        "train": {
            "epochs": 10, "batch_size": 32, "lr": 1e-3,
            "weight_decay": 1e-4, "schedule": "onecycle",
            "schedule_kwargs": {"max_lr": 1e-2, "pct_start": 0.1},
            "label_smoothing": 0.1, "clip_norm": 1.0,
            "default_lr_scale": 1.0, "param_groups": (),
            "augment": {
                "resize_crop": 72, "hflip": 0.5, "brightness": 0.1,
                "contrast": 0.1, "saturation": 0.1, "hue": 0.05,
                "mean": NORMALIZATION["tiny_imagenet"][0],
                "std": NORMALIZATION["tiny_imagenet"][1]},
        },
    },
}


def get_preset(name):
    """The preset ``name``'s values (a dict; ``train`` holds the training
    values that ``train.make_train_step`` and ``train.TrainConfig`` read)."""
    from .models import NOT_YET_PORTED

    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"preset {name!r} is not yet ported: ROADMAP.md "
            f"{NOT_YET_PORTED[name]}")
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; ported: {sorted(PRESETS)}")
    return PRESETS[name]
