"""The values of the JAX presets, synthetic specs and normalisation constants
that the port's CLIs need (``cnn_pde_tpu/utils/config.py``,
``data/synthetic.py`` and ``data/real.py`` there), copied so the port
imports nothing of the JAX package."""

from __future__ import annotations

__all__ = ["PRESETS", "SYNTHETIC_SPECS", "NORMALIZATION", "get_preset"]

# dataset name: (channels, size, num_classes)
SYNTHETIC_SPECS = {"cifar10": (3, 32, 10)}

# torchvision normalisation constants (mean, std) of the reference scripts
NORMALIZATION = {"cifar10": ((0.4914, 0.4822, 0.4465),
                             (0.2023, 0.1994, 0.2010))}

# cifar10.py:400-527 of the reference: 20 epochs, batch 64, two-group AdamW
# (α/β at lr with weight decay 1e-6, the rest at lr·0.5 with 1e-4), cosine
# with T_max = epochs stepped per epoch, CE with label smoothing 0.1, clip 1.
PRESETS = {
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
}


def get_preset(name):
    from .models import NOT_YET_PORTED

    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"preset {name!r} is not yet ported: ROADMAP.md "
            f"{NOT_YET_PORTED[name]}")
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; ported: {sorted(PRESETS)}")
    return PRESETS[name]
