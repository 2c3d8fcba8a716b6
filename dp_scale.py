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

With ``--tp N`` or ``--spatial N`` the mesh is data=ranks/(N·M) ×
spatial × model and the script runs the sharded-model cases instead
(``SHARDED_CASES``): at ``--tp`` the full hybrid (exact grade, 64 images
a step) and, where the 'data' axis is 2 or more, the per-sweep flagship
(64) through ``Trainer(mesh, tp=True)``; at ``--spatial`` the emotion and
Tiny-ImageNet spatial classifiers (32 images) through
``Trainer(mesh, image_spec=("data", None, "spatial", None))`` against
their unsharded models, and the two ADI strategies (the all_to_all swap
and the partitioned solve) on a (96, 64, 64) state.  For each: the first
step's agreement with one card (the loss within 1e-5 relative and its
clipped gradients within 1e-4 of each tensor's largest entry, held; the
parameters after AdamW's first update recorded: lr·sign(g) moves 2·lr
where another order of sums flips the sign of a small gradient), ms a
captured step by CUDA events beside one card alone, and the collectives
of one eager step by ``parallel/hlo_audit.py`` with the NCCL kernels'
device time in a profiled captured epoch, by kernel with the median µs a
launch (the ADI steps: a forward and backward, eager and captured in a
CUDA graph, its replays profiled, and their K1/K3 launches on every
rank).
With ``--branch N`` the mesh is data=ranks/N × model=N and the case is
the flagship's hoisted lockstep with its three PDE branches split over
'model' (``enable_branch_parallel``, 64 images a step, through
``Trainer(mesh)``) against one card's meshless hoisted lockstep, at the
tensor-parallel cases' first-step bars.  A tensor-parallel case's
gradients are held against one card replaying
the sharded step's ReLU decisions, and each decision that one card
alone takes the other way must lie within the rounding between the runs
(``_sharded_case``): a pre-activation at zero within rounding flips a
ReLU, which moves a whole row of the next layer's gradient.  A case that
fails is recorded with its error and the script exits non-zero after
writing the others.

    python3 dp_scale.py --ranks 4 --tp 4
    python3 dp_scale.py --ranks 4 --tp 2
    python3 dp_scale.py --ranks 4 --spatial 4
    python3 dp_scale.py --ranks 3 --branch 3
    python3 dp_scale.py --ranks 4 --branch 2
    python3 dp_scale.py --ranks 4 --spatial 4 --device cpu --steps 2

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
GRAD_TOL = 1e-4     # the sharded cases' first gradient, of its largest entry


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


def _nccl_profile(fn, calls=1):
    """(NCCL kernels, their device µs, device events, {NCCL kernel: [its
    launches, its device µs, its median µs a launch]}) of ``fn()``, the
    kernels and µs a call of ``calls``.  A collective kernel's time
    includes its wait for the other ranks, and the first one of a
    profile waits for the rank whose profiler started last: the median
    a launch leaves that wait out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    nccl = [e for e in events if "nccl" in e.name.lower()]
    times = {}
    for e in nccl:
        times.setdefault(e.name.split("(")[0], []).append(
            e.time_range.elapsed_us())
    by_kernel = {k: [len(t) / calls, sum(t) / calls, float(np.median(t))]
                 for k, t in times.items()}
    return len(nccl) / calls, sum(e.time_range.elapsed_us()
                                  for e in nccl) / calls, len(events), \
        by_kernel


def _by_kernel(by_kernel):
    """``_nccl_profile``'s kernels, for a log: launches a call x the median
    µs a launch (the µs a call in all)."""
    return ", ".join(f"{k} {n:g} x {med:.1f} us ({us:.1f} us)"
                     for k, (n, us, med) in sorted(by_kernel.items()))


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
                                                     verbose=False),
                         PROFILE_STEPS)
    out = {"global_batch": B, "ranks": ranks, "dp_step_ms": dp_ms,
           "dp_images_per_s": 1e3 * B / dp_ms,
           "allreduce_ms": allreduce,
           "allreduce_bytes": 4 * state.train_step.reducer.flat.numel(),
           "nccl_kernels_per_step": nccl[0],
           "nccl_device_us_per_step": nccl[1],
           "profiled_device_events": nccl[2],
           "nccl_by_kernel_per_step": nccl[3]}
    dist.barrier()
    missed = None
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
               f"{nccl[2]} device events profiled: {_by_kernel(nccl[3])}); "
               f"after "
               f"{COMPARED_STEPS} step against one card: worst parameter "
               f"{where} {worst:.3e}, loss {loss_err:.3e}")
        if not (worst <= PARAM_TOL and loss_err <= LOSS_TOL
                and np.isfinite(ref_rec["loss"])):
            missed = (f"{label}: DP over {ranks} ranks against one card: "
                      f"{where} {worst} (tolerance {PARAM_TOL}), loss "
                      f"{loss_err} (tolerance {LOSS_TOL})")
    dist.barrier()  # every rank here before rank 0 may raise
    if missed:
        raise AssertionError(missed)
    return out


# the sharded cases: label -> (dataset, global batch, train values key,
# tensor parallel, image_spec)
SHARDED_CASES = {
    "hybrid exact": ("cifar10", 64, "HYBRID_TRAIN", True, None),
    "flagship per_sweep": ("cifar10", 64, "TRAIN", True, None),
    "emotion": ("emotion", 32, "EMOTION_TRAIN", False,
                ("data", None, "spatial", None)),
    "tiny_imagenet": ("tiny_imagenet", 32, "TINY_TRAIN", False,
                      ("data", None, "spatial", None)),
    "flagship branch": ("cifar10", 64, "TRAIN", False, None),
}
ADI_SHAPE = (96, 64, 64)
ADI_CALLS = 20


def _progress(mesh, label, what, t0=time.perf_counter()):
    """Rank 0's progress line (a hung collective shows where it stopped)."""
    if mesh.rank == 0:
        print(f"[dp-scale] {time.perf_counter() - t0:8.1f} s {label}: {what}",
              flush=True)


def _sharded_labels(mesh, branch=False):
    if branch:
        return ["flagship branch"]
    if mesh.shape["model"] > 1:
        return ["hybrid exact"] + (["flagship per_sweep"]
                                   if mesh.shape["data"] > 1 else [])
    return ["emotion", "tiny_imagenet", "adi"]


def _sharded_model(label, device, mesh):
    """The case's model from chip_smoke's seeded model functions; a
    spatial case's sharded classifier carries the unsharded one's
    weights."""
    import chip_smoke as cs
    from cnn_pde_tpu_torch.parallel import (SpatialFTCSClassifier,
                                            SpatialTinyImageNetClassifier)

    if label == "hybrid exact":
        return cs.hybrid_model(device, grade="exact")
    if label == "flagship per_sweep":
        return cs.flagship(device)
    if label == "flagship branch":
        from cnn_pde_tpu_torch.parallel import enable_branch_parallel

        if mesh is None:  # one card: the meshless hoisted lockstep
            return cs.study_model(device, "hoisted_f32")
        model = cs.study_model(device, "per_sweep")
        enable_branch_parallel(model, mesh)
        return model
    ref = (cs.emotion_model(device) if label == "emotion"
           else cs.tiny_model(device))
    if mesh is None or mesh.shape["spatial"] == 1:
        return ref
    cls = (SpatialFTCSClassifier if label == "emotion"
           else SpatialTinyImageNetClassifier)
    kwargs = {} if label == "emotion" else {"num_classes": 200}
    model = cls(mesh, **kwargs).to(device)
    model.load_state_dict(ref.state_dict())
    return model


def _sharded_trainer(label, device, B, steps, mesh):
    import chip_smoke as cs
    from cnn_pde_tpu_torch.train import TrainConfig, Trainer

    name, _, values_key, tp, spec = SHARDED_CASES[label]
    values = getattr(cs, values_key)
    config = TrainConfig.from_preset(values, epochs=4, batch_size=B,
                                     seed=cs.SEED,
                                     max_steps_per_epoch=COMPARED_STEPS,
                                     device_epoch=True, log_every=10**9)
    sharded = mesh is not None
    trainer = Trainer(_sharded_model(label, device, mesh), config, values,
                      mesh=mesh, tp=tp and sharded,
                      image_spec=spec if sharded else None)
    return trainer, trainer.init_state(steps)


def _relu_inputs(model, mesh=None):
    """Forward pre-hooks that record the input of every call of each
    ``nn.ReLU`` of ``model`` made whole: on a tensor-parallel rank the
    feature block gathered over 'model' (between a column- and a
    row-parallel Linear, and inside a sharded SymmetricLayer) and the rows
    over 'data', a collective on every rank.  Returns ({name: [input a
    call]}, the hooks' handles)."""
    import torch
    from torch import nn

    from cnn_pde_tpu_torch.parallel.collectives import gather_dim
    from cnn_pde_tpu_torch.parallel.tensor_parallel import (
        ColumnParallelLinear)
    from cnn_pde_tpu_torch.pde.ruthotto import SymmetricLayer

    modules = dict(model.named_modules())
    block = next((m.features for m in modules.values()
                  if isinstance(m, ColumnParallelLinear)), None)
    record, handles = {}, []
    for name, m in modules.items():
        if not isinstance(m, nn.ReLU):
            continue
        owner = modules[name.rpartition(".")[0]]

        def hook(mod, args, name=name, owner=owner):
            with torch.no_grad():
                x = args[0].detach()
                if mesh is not None:
                    if ((block is not None and block.block is not None)
                            or (isinstance(owner, SymmetricLayer)
                                and owner.tp is not None)):
                        x = gather_dim(x, mesh, "model", -1)
                    x = gather_dim(x, mesh, "data", 0)
                record.setdefault(name, []).append(x.clone())
        handles.append(m.register_forward_pre_hook(hook))
    return record, handles


def _force_relu(model, inputs):
    """Forward hooks that make each ``nn.ReLU`` call of ``model`` take the
    branches of ``inputs`` (``_relu_inputs``' record of another run, in
    call order): x·[that run's input > 0].  Returns the handles."""
    from torch import nn

    calls = {}

    def make(name):
        def hook(mod, args, out):
            i = calls[name] = calls.get(name, -1) + 1
            return args[0] * (inputs[name][i] > 0).to(args[0].dtype)
        return hook
    return [m.register_forward_hook(make(n))
            for n, m in model.named_modules() if isinstance(m, nn.ReLU)]


def _relu_flips(got, ref):
    """The ReLU decisions of two runs (``_relu_inputs``' records):
    (entries whose sign differs, the largest |ref input| at such an entry
    and the largest difference of the entries whose sign agrees, both of
    the tensor's largest |ref input|, where (ReLU names), and whether every
    flipped entry sits within the rounding that separates the runs: its
    |ref input| no larger than the largest difference where they agree)."""
    n, at, rounding, where, within = 0, 0.0, 0.0, [], True
    for name, calls in ref.items():
        for r, g in zip(calls, got[name]):
            flip = (r > 0) != (g > 0)
            if not flip.any():
                continue
            scale = float(r.abs().max())
            top = float(r[flip].abs().max())
            agree = float((g - r)[~flip].abs().max())
            n += int(flip.sum())
            at, rounding = max(at, top / scale), max(rounding, agree / scale)
            where.append(name)
            within = within and top <= agree
    return n, at, rounding, sorted(set(where)), within


def _grad_errors(grads, sd, ref_state, zero):
    """(worst gradient error, where; worst parameter error, where) of one
    run's first step (``grads``, ``sd``: full tensors) against a reference
    ``TrainState``'s, each of the reference tensor's largest entry."""
    ref_sd = ref_state.model.state_dict()
    g_worst, g_where, worst, where = 0.0, None, 0.0, None
    for k, p in ref_state.model.named_parameters():
        moved = p.grad.abs() > GRAD_FLOOR
        # a gradient that vanishes in exact arithmetic (a bias before a
        # train-mode BatchNorm) is rounding in both runs
        if k in zero or not moved.any():
            continue
        # the first step's (clipped) gradient, which AdamW's first update
        # turns into lr·sign(g)
        g_err = float((grads[k] - p.grad).abs().max() / p.grad.abs().max())
        if g_err >= g_worst:
            g_worst, g_where = g_err, k
        err = float((sd[k] - ref_sd[k])[moved].abs().max()
                    / ref_sd[k].abs().max().clamp_min(1e-30))
        if err >= worst:
            worst, where = err, k
    return g_worst, g_where, worst, where


def _sharded_case(label, steps, mesh, device):
    """One sharded Trainer case: the first step against one card, ms a
    captured step, the collectives of an eager step and the NCCL kernels
    of a profiled captured epoch.  A tensor-parallel case records every
    ReLU input of its first step and one card replays that step twice:
    alone, and with each ReLU forced to the sharded run's decisions (the
    same branch of the piecewise-linear model); the gradients are held
    against the replay, whose only difference from the sharded step is
    the order of sums, and every ReLU decision that differs from one card
    alone must sit within the rounding that separates the two runs."""
    import torch.distributed as dist

    import chip_smoke as cs
    from cnn_pde_tpu_torch.parallel import full_state_dict
    from cnn_pde_tpu_torch.parallel.hlo_audit import audit

    name, B, _, tp, _ = SHARDED_CASES[label]
    data = _dataset(name, B, steps, cs.SEED + 92)
    _progress(mesh, label, "sharding the model")
    trainer, state = _sharded_trainer(label, device, B, steps, mesh)
    _progress(mesh, label, "the first step")
    relu, handles = (_relu_inputs(state.model, mesh) if tp
                     else (None, []))
    rec = trainer.train_epoch(state, data, 0, verbose=False)
    for h in handles:
        h.remove()
    sharded_sd = {k: v.clone() for k, v in
                  full_state_dict(state.model).items()}
    layout = getattr(state.model, "tp_layout", None)
    sharded_grads = {k: (p.grad if layout is None
                         else layout.whole(k, p.grad)).clone()
                     for k, p in state.model.named_parameters()}
    _progress(mesh, label, "the captured epoch")
    ms = _step_ms(trainer, state, data, steps, device)
    _progress(mesh, label, "the profiled epoch")
    trainer.config.max_steps_per_epoch = PROFILE_STEPS
    nccl = _nccl_profile(lambda: trainer.train_epoch(state, data, 3,
                                                     verbose=False),
                         PROFILE_STEPS)
    _progress(mesh, label, "the audited eager step")
    lo, hi = trainer._block(B)
    x = data.train_images[:B][lo:hi]
    y = data.train_labels[:B][lo:hi]
    collectives = audit(state.train_step, x, y)[0]
    _progress(mesh, label, "one card's reference")
    out = {"global_batch": B, "mesh": mesh.shape, "step_ms": ms,
           "images_per_s": 1e3 * B / ms,
           "collectives_per_eager_step": collectives,
           "nccl_kernels_per_step": nccl[0],
           "nccl_device_us_per_step": nccl[1],
           "profiled_device_events": nccl[2],
           "nccl_by_kernel_per_step": nccl[3]}
    dist.barrier()
    missed = None
    if mesh.rank == 0:
        zero = (cs.ZERO_IN_EXACT_ARITHMETIC | cs.HYBRID_ZERO
                | cs.EMOTION_ZERO | cs.TINY_ZERO)
        ref, ref_state = _sharded_trainer(label, device, B, steps, None)
        ref_relu, handles = _relu_inputs(ref_state.model) if tp else (
            None, [])
        ref_rec = ref.train_epoch(ref_state, data, 0, verbose=False)
        for h in handles:
            h.remove()
        g_worst, g_where, worst, where = _grad_errors(
            sharded_grads, sharded_sd, ref_state, zero)
        held, within = g_worst, True
        if tp:
            flips = _relu_flips(relu, ref_relu)
            within = flips[4]
            replay, replay_state = _sharded_trainer(label, device, B,
                                                    steps, None)
            handles = _force_relu(replay_state.model, relu)
            replay.train_epoch(replay_state, data, 0, verbose=False)
            for h in handles:
                h.remove()
            replayed = _grad_errors(sharded_grads, sharded_sd,
                                    replay_state, zero)
            held = replayed[0]
            out.update({"relu_flips": flips[0],
                        "relu_flip_input_rel": flips[1],
                        "relu_agreeing_diff_rel": flips[2],
                        "relu_flip_where": flips[3],
                        "relu_flips_within_rounding": within,
                        "replayed_grad_rel_err": replayed[0],
                        "replayed_grad_where": replayed[1],
                        "replayed_rel_err": replayed[2],
                        "replayed_where": replayed[3]})
        loss_err = abs(rec["loss"] - ref_rec["loss"])
        out.update({"worst_rel_err": worst, "worst_where": where,
                    "grad_rel_err": g_worst, "grad_where": g_where,
                    "loss_err": loss_err,
                    "loss_rel_err": loss_err / max(abs(ref_rec["loss"]),
                                                   1e-30),
                    "single_step_ms": _step_ms(ref, ref_state, data, steps,
                                               device)})
        out["single_images_per_s"] = 1e3 * B / out["single_step_ms"]
        replay_note = "" if not tp else (
            f"; {out['relu_flips']} ReLU decisions differ "
            f"({out['relu_flip_where']}: input at most "
            f"{out['relu_flip_input_rel']:.3e} of the tensor's largest, "
            f"agreeing entries differ by up to "
            f"{out['relu_agreeing_diff_rel']:.3e}; within rounding "
            f"{within}); one card replaying the sharded ReLU decisions: "
            f"gradient {out['replayed_grad_where']} "
            f"{out['replayed_grad_rel_err']:.3e}, parameter "
            f"{out['replayed_where']} {out['replayed_rel_err']:.3e}")
        cs.log(f"[dp-scale] {label}: mesh {mesh.shape}, B = {B}: {ms:.3f} "
               f"ms a captured step ({out['images_per_s']:.1f} images/s); "
               f"one card alone {out['single_step_ms']:.3f} ms; "
               f"collectives of an eager step {collectives}; NCCL kernels "
               f"a captured step {out['nccl_kernels_per_step']:g} "
               f"({out['nccl_device_us_per_step']:.1f} us: "
               f"{_by_kernel(nccl[3])}); after "
               f"{COMPARED_STEPS} step against one card: loss {loss_err:.3e}, "
               f"worst gradient {g_where} {g_worst:.3e} and parameter "
               f"{where} {worst:.3e} of their largest entry{replay_note}")
        # the loss and the gradients are held (a TP case's against the
        # replay of its ReLU decisions, each differing decision within
        # rounding); an AdamW parameter is recorded (lr·sign(g) moves 2·lr
        # where another order of sums flips a gradient's sign)
        if not (out["loss_rel_err"] <= LOSS_TOL and held <= GRAD_TOL
                and within and np.isfinite(ref_rec["loss"])):
            missed = (f"{label}: mesh {mesh.shape} against one card: loss "
                      f"{loss_err} (relative tolerance {LOSS_TOL}), "
                      f"gradient {held} (tolerance {GRAD_TOL}, "
                      f"{'replayed' if tp else 'alone'}), ReLU flips "
                      f"within rounding {within}")
    dist.barrier()  # every rank here before rank 0 may raise
    if missed:
        raise AssertionError(missed)
    return out


def _events_ms(fn, device, calls=ADI_CALLS):
    import torch

    for _ in range(3):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return 1e3 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / calls


def _graph(fn, device):
    """``fn`` captured in a CUDA graph (after two eager runs on the
    capturing stream), or None on the CPU."""
    import torch

    if device.type != "cuda":
        return None
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream(device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    return graph


def _captured_ms(fn, device):
    """ms a replay of ``fn`` captured in a CUDA graph, or None on the
    CPU."""
    graph = _graph(fn, device)
    return None if graph is None else _events_ms(graph.replay, device)


def _adi_case(mesh, device):
    """The two ADI strategies on an ADI_SHAPE state, H sharded over
    'spatial': a forward and the fields' gradients against one card's
    unsharded sweeps (rtol 2e-5 / atol 2e-6, gradients 1e-4 of their
    largest entry), the K1/K3 launches of one forward and backward on a
    rank, ms a forward and backward eager and captured, the collectives
    of one call and the NCCL kernels' device time of the captured
    replays."""
    import torch

    import chip_smoke as cs
    from cnn_pde_tpu_torch.ops.adi import sweep_x, sweep_y
    from cnn_pde_tpu_torch.parallel import (adi_strang_step_partitioned,
                                            adi_strang_step_spatial)
    from cnn_pde_tpu_torch.parallel.hlo_audit import audit
    from cnn_pde_tpu_torch.parallel.spatial import block

    rng = np.random.default_rng(cs.SEED + 95)
    B, H, W = ADI_SHAPE
    full = [rng.standard_normal((B, H, W)), rng.random((H, W)) + 0.2,
            rng.random((H, W)) + 0.2, rng.random((B, H, W))]
    full = [torch.tensor(a, dtype=torch.float32, device=device)
            for a in full]
    lo, hi = block(mesh, H)
    u, al, be, gw = (t[..., lo:hi, :].contiguous() for t in full)

    def reference(u, al, be, gw):
        al, be = al.clone().requires_grad_(), be.clone().requires_grad_()
        x = sweep_x(u, al, 0.005, 1.0, eps=1e-6)
        x = sweep_y(x, be, 0.01, 1.0, eps=1e-6)
        x = sweep_x(x, al, 0.005, 1.0, eps=1e-6)
        return (x.detach(),
                *torch.autograd.grad((x * gw).sum(), (al, be)))

    ref = reference(*full)
    out = {"single_ms": _events_ms(lambda: reference(*full), device),
           "single_captured_ms": _captured_ms(lambda: reference(*full),
                                              device)}
    for fn in (adi_strang_step_spatial, adi_strang_step_partitioned):
        _progress(mesh, fn.__name__, "eager, captured and audited")

        def step(fn=fn):
            a, b = al.clone().requires_grad_(), be.clone().requires_grad_()
            x = fn(mesh, u, a, b, dt=0.01)
            return (x.detach(), *torch.autograd.grad((x * gw).sum(),
                                                     (a, b)))
        cs.reset_counts()
        got = step()
        launched = {k: cs.counts()[k] for k in ("K1", "K3")}
        x_err = float((got[0] - ref[0][..., lo:hi, :]).abs().max())
        g_err = max(float((g - r[lo:hi]).abs().max() / r.abs().max())
                    for g, r in zip(got[1:], ref[1:]))
        counts, shapes, _ = audit(step)
        graph = _graph(step, device)
        run = step if graph is None else graph.replay

        def profiled(run=run):
            for _ in range(ADI_CALLS):
                run()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        nccl = _nccl_profile(profiled, ADI_CALLS)
        res = {"max_abs_err": x_err, "grad_rel_err": g_err,
               "launches": launched,
               "eager_ms": _events_ms(step, device),
               "captured_ms": (None if graph is None
                               else _events_ms(graph.replay, device)),
               "collectives_per_call": counts, "gathered": shapes,
               "nccl_kernels_per_call": nccl[0],
               "nccl_device_us_per_call": nccl[1],
               "profiled_device_events": nccl[2],
               "nccl_by_kernel_per_call": nccl[3]}
        out[fn.__name__] = res
        cs.log(f"[dp-scale] {fn.__name__} on {ADI_SHAPE}, mesh "
               f"{mesh.shape}: max abs err {x_err:.3e}, gradients "
               f"{g_err:.3e} of their largest entry against one card; "
               f"K1/K3 launches a forward and backward {launched}; "
               f"{res['eager_ms']:.3f} ms eager, captured "
               f"{res['captured_ms']} ms (one card "
               f"{out['single_ms']:.3f} / {out['single_captured_ms']} ms); "
               f"collectives a call {counts}, gathered {shapes}; NCCL "
               f"kernels a captured call {res['nccl_kernels_per_call']:g} "
               f"({res['nccl_device_us_per_call']:.1f} us, of "
               f"{nccl[2]} device events profiled over {ADI_CALLS} calls: "
               f"{_by_kernel(nccl[3])})")
        if not (x_err <= 2e-6 + 2e-5 * float(ref[0].abs().max())
                and g_err <= 1e-4):
            raise AssertionError(f"{fn.__name__}: {x_err}, {g_err}")
    return out


def _sharded_cases(steps, mesh, device, branch=False):
    results, failed = {}, []
    for label in _sharded_labels(mesh, branch):
        try:
            results[label] = (_adi_case(mesh, device) if label == "adi"
                              else _sharded_case(label, steps, mesh, device))
        except Exception as exc:  # recorded; the script exits non-zero
            results[label] = {"error": f"{type(exc).__name__}: {exc}"}
            failed.append(label)
    return results, failed


def worker(rank, ranks, port, device, steps, out_path, tp=1, spatial=1,
           branch=1):
    import torch

    from cnn_pde_tpu_torch.parallel import initialize, make_mesh

    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    initialize(f"tcp://127.0.0.1:{port}", num_processes=ranks,
               process_id=rank, backend=backend)
    try:
        mesh = make_mesh(spatial=spatial, model=tp * branch,
                         device=device.type)
        if device.type == "cuda":
            import chip_smoke as cs

            if rank == 0:
                cs.phase_device()  # the card's name and power limit
            # every rank's float32 products and convolutions off TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            device = mesh.device
        failed = []
        if tp == spatial == branch == 1:
            results = {label: _case(label, ranks, steps, mesh, device)
                       for label in CASES}
        else:
            results, failed = _sharded_cases(steps, mesh, device,
                                             branch > 1)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(results, f, default=str)
        if failed:
            raise SystemExit(f"dp_scale rank {rank}: failed {failed}")
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--tp", type=int, default=1, metavar="N",
                    help="the 'model' axis: the tensor-parallel cases")
    ap.add_argument("--spatial", type=int, default=1, metavar="N",
                    help="the 'spatial' axis: the spatial cases")
    ap.add_argument("--branch", type=int, default=1, metavar="N",
                    help="the 'model' axis: the branch-parallel case")
    args = ap.parse_args(argv)
    if args.branch > 1 and (args.tp > 1 or args.spatial > 1):
        raise SystemExit("--branch runs alone: branch parallelism with "
                         "--tp or --spatial is not covered")
    if args.ranks % (args.tp * args.spatial * args.branch):
        raise SystemExit(f"--tp {args.tp} x --spatial {args.spatial} x "
                         f"--branch {args.branch} must divide --ranks "
                         f"{args.ranks}")
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build", "dp_scale")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "results.json")
    if os.path.exists(out_path):
        os.remove(out_path)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=root)
    if args.device == "cpu":
        env["OMP_NUM_THREADS"] = "2"
    code = ("import sys, dp_scale; dp_scale.worker(int(sys.argv[1]), "
            "int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], "
            "int(sys.argv[5]), sys.argv[6], int(sys.argv[7]), "
            "int(sys.argv[8]), int(sys.argv[9]))")
    procs = [subprocess.Popen([sys.executable, "-u", "-c", code, str(r),
                               str(args.ranks), str(port), args.device,
                               str(args.steps), out_path, str(args.tp),
                               str(args.spatial), str(args.branch)],
                              cwd=root, env=env)
             for r in range(args.ranks)]
    try:
        codes = [p.wait(timeout=1500) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if os.path.exists(out_path):
        with open(out_path) as f:
            print(json.dumps(json.load(f)))
    if any(codes):
        raise SystemExit(f"dp_scale: ranks exited {codes}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
