"""Experiment-sweep harness — port of ``cnn_pde_tpu/utils/sweep.py``:
train a preset under several configuration overrides and tabulate the
results, each configuration's failure isolated (it records 0.0 and its
traceback is printed)."""

from __future__ import annotations

import traceback
from typing import Callable, Optional, Sequence

__all__ = ["compare_configs", "compare_spatial_discretizations",
           "format_table"]


def compare_configs(run_one: Callable[[dict], float],
                    configs: Sequence[dict],
                    descriptions: Optional[Sequence[str]] = None):
    """Run ``run_one(config) -> accuracy`` for each configuration; one that
    raises records 0.0 after its traceback is printed."""
    results = []
    for i, cfg in enumerate(configs):
        desc = descriptions[i] if descriptions else str(cfg)
        try:
            acc = float(run_one(cfg))
        except Exception:
            traceback.print_exc()
            acc = 0.0
        results.append({"config": cfg, "description": desc, "accuracy": acc})
    return results


def compare_spatial_discretizations(*, epochs=1, steps=None, synthetic=True,
                                    seed=0, verbose=False, device="cuda",
                                    batch_size=None, data_dir="./data"):
    """The reference's four-configuration dx/dy sweep on the MNIST model:
    each ``MNISTClassifier(dx=, dy=)`` trained by the Trainer for
    ``epochs`` (at most ``steps`` steps an epoch) on ``device`` and
    evaluated."""
    import torch

    from ..data import load_dataset, synthetic_dataset
    from ..models import build_model
    from ..presets import get_preset
    from ..train import TrainConfig, Trainer

    configs = [
        {"dx": 1.0, "dy": 1.0}, {"dx": 1.0, "dy": 0.5},
        {"dx": 0.5, "dy": 1.0}, {"dx": 2.0, "dy": 1.0},
    ]
    descriptions = ["Square grid (isotropic)", "Fine Y resolution",
                    "Fine X resolution", "Coarse X resolution"]

    preset = get_preset("mnist")
    values = preset["train"]
    dataset = (synthetic_dataset("mnist") if synthetic
               else load_dataset("mnist", data_dir, synthetic_ok=True))
    bs = batch_size or values["batch_size"]

    def run_one(cfg):
        model = build_model("mnist", device=device,
                            generator=torch.Generator().manual_seed(seed),
                            dx=cfg["dx"], dy=cfg["dy"])
        config = TrainConfig.from_preset(values, epochs=epochs,
                                         batch_size=bs, seed=seed,
                                         max_steps_per_epoch=steps)
        trainer = Trainer(model, config, values)
        spe = dataset.steps_for_batch(bs)
        state = trainer.init_state(min(spe, steps) if steps else spe)
        for e in range(epochs):
            trainer.train_epoch(state, dataset, e, verbose=verbose)
        return trainer.evaluate(state, dataset)["acc"]

    return compare_configs(run_one, configs, descriptions)


def format_table(results):
    lines = [f"{'description':<28} {'accuracy':>9}", "-" * 39]
    for r in results:
        lines.append(f"{r['description']:<28} {r['accuracy']:>8.2f}%")
    return "\n".join(lines)
