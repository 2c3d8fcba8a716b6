"""The values of the JAX presets and synthetic specs that the serve CLI needs
(``cnn_pde_tpu/utils/config.py`` and ``data/synthetic.py`` there), copied so
the port imports nothing of the JAX package."""

from __future__ import annotations

__all__ = ["PRESETS", "SYNTHETIC_SPECS", "get_preset"]

# dataset name: (channels, size, num_classes)
SYNTHETIC_SPECS = {"cifar10": (3, 32, 10)}

# cifar10.py:400-527 of the reference
PRESETS = {
    "cifar10_noconv": {"name": "cifar10_noconv", "model": "cifar10_noconv",
                       "dataset": "cifar10", "model_kwargs": {}},
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
