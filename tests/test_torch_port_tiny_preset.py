"""The Tiny-ImageNet preset, its one-cycle schedule and its synthetic set
against the JAX package's on the CPU (split from
``test_torch_port_tiny.py``): the preset's values and augmentation, the
schedule step by step (rel 1e-5), the synthetic arrays bit for bit."""

import numpy as np
import pytest

from cnn_pde_tpu.data.synthetic import make_synthetic as jax_make_synthetic
from cnn_pde_tpu.utils.config import get_preset as jax_preset
from cnn_pde_tpu_torch.data.synthetic import make_synthetic
from cnn_pde_tpu_torch.models import NOT_YET_PORTED
from cnn_pde_tpu_torch.presets import NORMALIZATION, PRESETS, SYNTHETIC_SPECS
from cnn_pde_tpu_torch.train.step import make_schedule


def test_tiny_preset_matches_jax():
    ref = jax_preset("tiny_imagenet")
    train = PRESETS["tiny_imagenet"]["train"]
    for key in ("epochs", "batch_size", "lr", "weight_decay", "schedule",
                "schedule_kwargs", "label_smoothing", "clip_norm",
                "default_lr_scale"):
        assert train[key] == getattr(ref, key), key
    assert train["schedule_kwargs"] == {"max_lr": 1e-2, "pct_start": 0.1}
    assert PRESETS["tiny_imagenet"]["model_kwargs"] == ref.model_kwargs
    aug = ref.augment
    for key in ("resize_crop", "hflip", "brightness", "contrast",
                "saturation", "hue"):
        assert train["augment"][key] == getattr(aug, key), key
    assert tuple(train["augment"]["mean"]) == tuple(aug.mean)
    assert tuple(train["augment"]["std"]) == tuple(aug.std)
    assert NORMALIZATION["tiny_imagenet"] == ((0.485, 0.456, 0.406),
                                              (0.229, 0.224, 0.225))
    assert NOT_YET_PORTED == {}


def test_tiny_schedule_is_per_batch_onecycle_with_pct_start_01():
    ours = make_schedule(PRESETS["tiny_imagenet"]["train"],
                         steps_per_epoch=7)
    theirs = jax_preset("tiny_imagenet").make_schedule(7)
    peak = max(range(70), key=ours)
    assert peak == 6  # the top at pct_start · 70 − 1
    for step in range(0, 72):
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-5,
                                           abs=1e-9), step


def test_tiny_synthetic_data_matches_jax():
    assert SYNTHETIC_SPECS["tiny_imagenet"] == (3, 64, 200)
    for port, ref in zip(make_synthetic("tiny_imagenet", train_per_class=1,
                                        test_per_class=1),
                         jax_make_synthetic("tiny_imagenet",
                                            train_per_class=1,
                                            test_per_class=1)):
        assert port.dtype == ref.dtype
        np.testing.assert_array_equal(port, ref)
