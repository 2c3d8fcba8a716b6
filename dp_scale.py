#!/usr/bin/env python3
"""Data-parallel training over the cards of one host: ``Trainer(mesh=)``
in a process group of one process a card against one card alone.

    python3 dp_scale.py [--ranks 4] [--device cuda] [--steps 30]

Starts ``--ranks`` processes (a process group over tcp://127.0.0.1, NCCL
on cards, gloo with ``--device cpu``); each runs, for fused mnist at 128
images a rank and the per-sweep flagship at 64 a rank (the global batch
is the ranks' sum), the device epoch of ``Trainer(mesh=make_mesh())``:

* a first step, whose weights rank 0 holds against the meshless Trainer
  run alone on the whole global batch from the same seeded model and
  data: the loss within 1e-5 and the parameters within 5e-5 of each
  tensor's largest entry (the JAX package's DP bars) where the
  reference's clipped gradient exceeds 1e-6 (Adam's first step is
  lr·sign(g), and another order of sums moves the sign of a gradient
  near 0), the biases before a train-mode BatchNorm left out (their
  gradient vanishes in exact arithmetic), as the CPU tests hold two gloo
  ranks;
* ``--steps`` steps a rank by CUDA events (after a capture at that
  chunk size), and the same on rank 0's card alone at the global batch
  and at a rank's batch: the ideal data-parallel step takes the time of
  a rank's batch alone;
* the step's all-reduce alone (its flat buffer of the gradients, the
  loss and the accuracy), 50 calls by CUDA events, and the NCCL kernels
  and their device time in a profiled epoch of 5 captured steps.

Rank 0 prints the card's name and power limit and one JSON line of the
readings; the script exits non-zero if any rank fails or a check misses.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

CASES = {"mnist fused": ("mnist", 128), "flagship per_sweep": ("cifar10", 64)}
COMPARED_STEPS = 1
GRAD_FLOOR = 1e-6
PROFILE_STEPS = 5
ALLREDUCE_CALLS = 50
PARAM_TOL = 5e-5
LOSS_TOL = 1e-5


def _model(label, device):
    import chip_smoke as cs

    if label == "mnist fused":
        return cs.grayscale_model(device, fused_inference=True, fused=True)
    return cs.flagship(device)


def _dataset(name, B, steps, seed):
    from cnn_pde_tpu_torch.data import NORMALIZATION, SYNTHETIC_SPECS
    from cnn_pde_tpu_torch.data import ArrayDataset

    channels, size, classes = SYNTHETIC_SPECS[name]
    rng = np.random.default_rng(seed)
    n = steps * B
    images = rng.random((n + B, channels, size, size), dtype=np.float32)
    labels = rng.integers(0, classes, n + B)
    mean, std = NORMALIZATION[name]
    return ArrayDataset(images[:n], labels[:n], images[n:], labels[n:],
                        mean=mean, std=std, num_classes=classes)


def _trainer(label, device, B, steps, mesh):
    import chip_smoke as cs
    from cnn_pde_tpu_torch.train import TrainConfig, Trainer

    values = cs.GRAY_TRAIN if label == "mnist fused" else cs.TRAIN
    config = TrainConfig.from_preset(values, epochs=4, batch_size=B,
                                     seed=cs.SEED,
                                     max_steps_per_epoch=COMPARED_STEPS,
                                     device_epoch=True, log_every=10**9)
    trainer = Trainer(_model(label, device), config, values, mesh=mesh)
    return trainer, trainer.init_state(steps)


def _step_ms(trainer, state, data, steps, device):
    """ms a step of an epoch of ``steps`` (CUDA events on a card), after
    one epoch of that chunk size (its capture)."""
    import torch

    trainer.config.max_steps_per_epoch = steps
    trainer.train_epoch(state, data, 1, verbose=False)
    if device.type != "cuda":
        t0 = time.perf_counter()
        trainer.train_epoch(state, data, 2, verbose=False)
        return 1e3 * (time.perf_counter() - t0) / steps
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    trainer.train_epoch(state, data, 2, verbose=False)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / steps


def _nccl_profile(fn):
    """(NCCL kernels, their device µs, device events) of ``fn()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    nccl = [e for e in events if "nccl" in e.name.lower()]
    return len(nccl), sum(e.time_range.elapsed_us() for e in nccl), \
        len(events)


def _allreduce_ms(reducer, device):
    import torch
    import torch.distributed as dist

    for _ in range(3):
        dist.all_reduce(reducer.flat, group=reducer.mesh.group)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(ALLREDUCE_CALLS):
        dist.all_reduce(reducer.flat, group=reducer.mesh.group)
    if device.type == "cuda":
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / ALLREDUCE_CALLS
    return 1e3 * (time.perf_counter() - t0) / ALLREDUCE_CALLS


def _case(label, ranks, steps, mesh, device):
    import torch.distributed as dist

    import chip_smoke as cs

    name, per_rank = CASES[label]
    B = per_rank * ranks
    data = _dataset(name, B, steps, cs.SEED + 90)
    trainer, state = _trainer(label, device, B, steps, mesh)
    rec = trainer.train_epoch(state, data, 0, verbose=False)
    dp_sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    dp_ms = _step_ms(trainer, state, data, steps, device)
    allreduce = _allreduce_ms(state.train_step.reducer, device)
    trainer.config.max_steps_per_epoch = PROFILE_STEPS
    nccl = _nccl_profile(lambda: trainer.train_epoch(state, data, 3,
                                                     verbose=False))
    out = {"global_batch": B, "ranks": ranks, "dp_step_ms": dp_ms,
           "dp_images_per_s": 1e3 * B / dp_ms,
           "allreduce_ms": allreduce,
           "allreduce_bytes": 4 * state.train_step.reducer.flat.numel(),
           "nccl_kernels_per_step": nccl[0] / PROFILE_STEPS,
           "nccl_device_us_per_step": nccl[1] / PROFILE_STEPS,
           "profiled_device_events": nccl[2]}
    dist.barrier()
    if mesh.rank == 0:
        ref, ref_state = _trainer(label, device, B, steps, None)
        ref_rec = ref.train_epoch(ref_state, data, 0, verbose=False)
        ref_sd = ref_state.model.state_dict()
        worst, where = 0.0, None
        for k, p in ref_state.model.named_parameters():
            moved = p.grad.abs() > GRAD_FLOOR
            if k in cs.ZERO_IN_EXACT_ARITHMETIC or not moved.any():
                continue
            err = float((dp_sd[k] - ref_sd[k])[moved].abs().max()
                        / ref_sd[k].abs().max().clamp_min(1e-30))
            if err >= worst:
                worst, where = err, k
        loss_err = abs(rec["loss"] - ref_rec["loss"])
        out.update({"worst_rel_err": worst, "worst_where": where,
                    "loss_err": loss_err,
                    "single_step_ms": _step_ms(ref, ref_state, data, steps,
                                               device)})
        out["single_images_per_s"] = 1e3 * B / out["single_step_ms"]
        local, local_state = _trainer(label, device, per_rank, steps, None)
        local_data = _dataset(name, per_rank, steps, cs.SEED + 91)
        local.train_epoch(local_state, local_data, 0, verbose=False)
        out["rank_batch_alone_step_ms"] = _step_ms(local, local_state,
                                                   local_data, steps, device)
        cs.log(f"[dp-scale] {label}: {ranks} ranks, global B = {B}: "
               f"{dp_ms:.3f} ms a step ({out['dp_images_per_s']:.1f} "
               f"images/s); one card alone {out['single_step_ms']:.3f} ms "
               f"at B = {B} ({out['single_images_per_s']:.1f} images/s), "
               f"{out['rank_batch_alone_step_ms']:.3f} ms at B = "
               f"{per_rank}; all-reduce of {out['allreduce_bytes']} bytes "
               f"{allreduce:.4f} ms; NCCL kernels a captured step "
               f"{out['nccl_kernels_per_step']:g} "
               f"({out['nccl_device_us_per_step']:.1f} us, of "
               f"{nccl[2]} device events profiled); after "
               f"{COMPARED_STEPS} step against one card: worst parameter "
               f"{where} {worst:.3e}, loss {loss_err:.3e}")
        if not (worst <= PARAM_TOL and loss_err <= LOSS_TOL
                and np.isfinite(ref_rec["loss"])):
            raise AssertionError(f"{label}: DP over {ranks} ranks against "
                                 f"one card: {where} {worst} (tolerance "
                                 f"{PARAM_TOL}), loss {loss_err} "
                                 f"(tolerance {LOSS_TOL})")
    dist.barrier()
    return out


def worker(rank, ranks, port, device, steps, out_path):
    import torch

    from cnn_pde_tpu_torch.parallel import initialize, make_mesh

    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    initialize(f"tcp://127.0.0.1:{port}", num_processes=ranks,
               process_id=rank, backend=backend)
    try:
        mesh = make_mesh()
        if device.type == "cuda":
            import chip_smoke as cs

            if rank == 0:
                cs.phase_device()  # the card's name and power limit
            # every rank's float32 products and convolutions off TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            device = mesh.device
        results = {label: _case(label, ranks, steps, mesh, device)
                   for label in CASES}
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(results, f)
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build", "dp_scale")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "results.json")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=root)
    if args.device == "cpu":
        env["OMP_NUM_THREADS"] = "2"
    code = ("import sys, dp_scale; dp_scale.worker(int(sys.argv[1]), "
            "int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], "
            "int(sys.argv[5]), sys.argv[6])")
    procs = [subprocess.Popen([sys.executable, "-u", "-c", code, str(r),
                               str(args.ranks), str(port), args.device,
                               str(args.steps), out_path], cwd=root, env=env)
             for r in range(args.ranks)]
    try:
        codes = [p.wait(timeout=1500) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(codes):
        raise SystemExit(f"dp_scale: ranks exited {codes}")
    with open(out_path) as f:
        results = json.load(f)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
