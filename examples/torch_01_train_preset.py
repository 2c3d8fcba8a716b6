"""Train a preset end to end with the library API of the PyTorch port.

Equivalent CLI: ``python -m cnn_pde_tpu_torch.train --preset mnist
--synthetic --device-epoch``.  It runs on the card (``cuda``) unless given
``--device cpu``; without CUDA and without ``--device cpu`` it stops.

Usage: python examples/torch_01_train_preset.py [preset] [epochs]
       [--device cpu] [--data-dir DIR]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))  # run from any directory of the checkout

import torch

from cnn_pde_tpu_torch.data import load_dataset
from cnn_pde_tpu_torch.models import build_model
from cnn_pde_tpu_torch.presets import get_preset
from cnn_pde_tpu_torch.train import TrainConfig, Trainer
from cnn_pde_tpu_torch.utils import model_summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("preset", nargs="?", default="mnist")
    ap.add_argument("epochs", nargs="?", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data-dir", default="data",
                    help="the real files (MIGRATION.md §2); absent, the "
                         "deterministic synthetic fixture")
    args = ap.parse_args(argv)

    preset = get_preset(args.preset)
    values = preset["train"]
    dataset = load_dataset(preset["dataset"], args.data_dir,
                           synthetic_ok=True)
    model = build_model(preset["model"], device=args.device,
                        generator=torch.Generator().manual_seed(0),
                        **preset["model_kwargs"])
    summ = model_summary(model, (values["batch_size"],)
                         + dataset.train_images.shape[1:])
    print(f"{preset['name']} ({dataset.source} data, {args.device}): "
          f"{summ['total_params']:,} params ({summ['pde_params']:,} in PDE "
          f"groups) -> {summ['output_shape']}")

    # device_epoch: the train split on the device and the step captured in
    # one CUDA graph, replayed a batch (on the CPU the same loop runs
    # eagerly); the batches, draws and weights are the host loop's
    config = TrainConfig.from_preset(values, epochs=args.epochs,
                                     device_epoch=True)
    trainer = Trainer(model, config, values)
    state = trainer.init_state(dataset.steps_for_batch(config.batch_size))
    result = trainer.fit(state, dataset, verbose=False)
    print(f"best test acc: {result['best_acc']:.2f}%")


if __name__ == "__main__":
    main()
