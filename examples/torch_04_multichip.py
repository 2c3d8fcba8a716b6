"""Data-parallel training of the PyTorch port on a mesh: one process a
card in a ``torch.distributed`` group.

On the card: ``python examples/torch_04_multichip.py`` is a one-rank NCCL
group on one card; ``--ranks N`` spawns N ranks, one a card.  On the CPU,
``--device cpu --ranks 2`` runs two gloo processes.  Each rank takes its
block of the global batch (``shard_batch``); one all-reduce a step sums
the gradients, so every rank's step is the single-device step on the
whole batch.

Usage: python examples/torch_04_multichip.py [--ranks N] [--device cpu]
"""

import argparse
import os
import socket
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from cnn_pde_tpu_torch.models import build_model
from cnn_pde_tpu_torch.parallel import (initialize, make_dp_train_step,
                                        make_mesh, shard_batch)
from cnn_pde_tpu_torch.presets import get_preset


def worker(rank, ranks, port, device, steps):
    """One rank: its group, its mesh, ``steps`` DP steps of the
    flagship."""
    if device == "cpu":
        torch.set_num_threads(2)
    # NCCL over the cards; gloo only when asked for (the CPU)
    initialize(f"tcp://127.0.0.1:{port}", num_processes=ranks,
               process_id=rank, backend="nccl" if device == "cuda" else "gloo")
    try:
        # ('data', 'spatial', 'model') mesh over every rank; size-1 axes are
        # free.  The train CLI's --dp / --tp build the same thing.
        mesh = make_mesh(spatial=1, model=1, device=device)
        model = build_model("cifar10_noconv", device=mesh.device,
                            generator=torch.Generator().manual_seed(0))
        values = dict(get_preset("cifar10_noconv")["train"],
                      schedule="constant", lr=1e-3, augment=None)
        # rank 0's weights are broadcast to every rank here
        step = make_dp_train_step(model, values, mesh)

        rng = np.random.default_rng(0)  # the same global batch on each rank
        batch = 8 * ranks
        images = rng.random((batch, 3, 32, 32), dtype=np.float32)
        labels = rng.integers(0, 10, batch)
        x, y = shard_batch(mesh, (images, labels))
        for i in range(steps):
            loss, _ = step(x, y)
            if rank == 0:
                print(f"step {i}: loss {loss.item():.4f} (batch {batch} "
                      f"over {mesh.shape['data']} data shards, "
                      f"{mesh.device.type})", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device is available; pass --device cpu to run "
                 "gloo processes on the CPU")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    run = (port, args.device, args.steps)
    if args.ranks == 1:
        worker(0, 1, *run)
    else:
        mp.spawn(worker, args=(args.ranks, *run), nprocs=args.ranks)


if __name__ == "__main__":
    main()
