#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one GPU and
hold its kernels against their plain versions.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure.
A phase's CLI runs are queued and run in phase 12, four at a time:

1. device: the card's name and power limit from nvidia-smi; TF32 off
   (phase 9 turns cuDNN's flag back on for Tiny-ImageNet);
2. build: K1 and K3 (csrc/thomas.cu), K2 and K4 (csrc/fused_channel.cu),
   K5 (csrc/fused_channel_vjp.cu), K6 and K7 (csrc/fused_grayscale.cu) and
   K8 (csrc/fused_grayscale_vjp.cu) with nvcc, one process a source, all
   started together, and ptxas's report (registers, shared memory, spills)
   of each kernel of every source;
3. each kernel against its plain PyTorch version on the card, at the
   shapes of the two model families' main paths (K1, K3: x- and y-sweeps of
   the flagship's three branch scales at B in {1, 7, 64, 128, 512, 1000,
   1024}, 1000 not a multiple of the kernels' chunk, plus bands (3, 5, N)
   and (3, N, 7) with N in {1, 2, 3, 33, 64} at B in {7, 300}, plus the
   grayscale layer's smoothed sweeps at B = 1024; K2, K4 and K5: the three
   branches (3, 32, 32), Strang and Lie, at B in {1, 7, 64, 512}, and
   (1, 28, 28), (2, 20, 33) and (3, 48, 64) at B in {7, 300} (K2 also
   (3, 64, 64)), K4 and K5 with fields that straddle both clamp bounds, K5
   twice on the same inputs and equal bit for bit, and K5 and its plain
   version each against the plain version in float64 (logged, not held);
   K6, K7 and K8: the mnist
   (10 steps) and fashion_mnist (4 steps) layers at B in {1, 7, 128, 1024},
   and (12, 12), (1, 28), (64, 64), (9, 13) and (33, 20) on the mnist
   layer's settings at B in {7, 300}, with fields that straddle eps, K8
   twice on the same inputs and equal bit for bit);
4. serving the CIFAR-10 flagship: the eager predict
   (``make_eager_predict_fn``, weights from a seed)
   in the per-sweep and the fused configuration at B in {1, 64, 1024},
   logits held against the same model on its plain versions, launch counts
   read around that run, then images/s; then the serve CLI on cuda;
5. the device's busy share of a served flagship forward (torch.profiler);
6. training the flagship: the train step (``make_train_step``, the preset's
   augmentation, dropout and grouped AdamW) per-sweep and fused: launch
   counts read around one step at B = 64, the loss and every gradient
   held against the same step on the plain versions at B = 64 and 256
   (and both against that step in float64, logged), 50 steps on synthetic CIFAR-10
   with a falling loss, images/s by CUDA events, the
   device's busy share of a step; then the train CLI on cuda;
7. the grayscale family (mnist): serving per-sweep (30 K1 a forward) and
   fused (1 K6) at B in {1, 128, 1024} against the plain versions, with
   images/s and the busy share; training per-sweep (30 K1 + 30 K3 a step)
   and fused (1 K7 + 1 K8) at B = 128: launch counts, the loss and every
   gradient against the plain versions, 50 steps on synthetic MNIST with a
   falling loss, images/s and the busy share; both CLIs with
   ``--preset mnist`` on cuda; then fashion_mnist the same way, served at
   B in {1, 128, 1024} (12 K1 or 1 K6 a forward) and trained at B = 128
   (12 K1 + 12 K3, or 1 K7 + 1 K8 a step), without its CLIs;
8. the AMP grade (hoisted sweep operators) and SVHN: K1 as the operator
   builder (``tridiag_inverse_operator``, the identity as a right-hand
   side of batch N) on the flagship's largest stack against its plain
   version, timed (float32 and bf16 X) beside the plain version, the
   bound and torch.linalg.inv; one bf16 operator sweep against the
   float32 one; one sweep's apply at the flagship's B = 64 and 1024 by
   each GEMM route (float32, bmm with a float32 result, bf16-rounded
   operands in a float32 GEMM), device time in a CUDA graph and call
   time by CUDA events;
   the flagship served (operators cached: 6 K1 launches, none a request)
   at B in {1, 64, 1024} and trained (6 K1 a step, no K3) at B = 64, with
   images/s and the busy share at 64 and 256, in both grades: float32
   hoisted against the per-sweep path (logits 1e-4, every ADI layer's
   output 1e-5, the train step's loss and gradients 1e-4 of their
   largest entry), bf16 (bmm with bf16 operands and a float32 result)
   against the same grade on its plain versions (bf16-rounded operands in
   a float32 GEMM: 4e-3 of the largest entry on logits, 6e-3 on
   gradients, layer outputs 4e-4 in the RMS and two bf16 steps, 2^-6, of
   the largest entry element by element), with its distance from float32
   logged, and a control that must fail those limits: the same requests
   with every bf16 GEMM returning bf16 (a bmm without ``out_dtype``);
   serving rates of the float32 grade, the bf16 grade and the bf16 grade
   on the rounded-operand route taken in turns, each profiled at the
   largest B; mnist the same way at B = 128 (2 K1); SVHN per-sweep (30 K1 a forward, 30 K1 and
   30 K3 a step) served at B in {1, 256} and trained at B = 256 against
   its plain versions (50 steps, falling loss), and its two hoisted
   grades the same way (2 K1); the serve CLI with --preset svhn --amp and
   the train CLI with --preset svhn --amp --bf16-moments on cuda;
9. the explicit-stencil families: emotion (48 x 48, FTCS; no kernel of
   ours) served at B in {1, 64, 1024} with logits within 1e-4 of their
   largest entry against the same model in float64, trained at B = 64
   with the loss and every gradient within 1e-4 of its largest entry
   against the float64 step (the six FTCS weights as one vector), 50 steps
   with a falling loss, images/s and the busy share, and both CLIs; then
   Tiny-ImageNet (64 x 64, ResNet-18, 200 classes) with cuDNN's TF32 flag
   at torch's default (on), so that the port's guard is what keeps the
   exact grade off TF32: served at B in {1, 32, 256} (logits within 1e-4
   of float64) and trained at B = 32 and 128 (every gradient within 1e-4
   of its largest entry against the float64 step, ReLU and max-pool
   decisions replayed), a control with the guard bypassed that must miss
   a limit, 50 steps, images/s and the busy share; ``pde_implicit=True``
   (2 K1 a forward, 2 K1 + 2 K3 a step, against the plain versions); the
   AMP grade (each kind of bf16 convolution of the backbone and its
   gradients against its plain version, within one bf16 step of the
   largest entry; the model within sqrt(2) times the plain
   grade's distance from the exact grade plus 2^-8; with ``pde_implicit``
   2 K1 a forward and a step, no K3); the serve CLI with --preset
   tiny_imagenet --amp and the train CLI with --synthetic --steps 20;
10. the CIFAR-10 hybrid (``cifar10_hybrid``, bf16 K products by default):
   its K products alone at B = 64 with both TF32 flags on (the exact
   grade within 1e-5 of float64, a control with the guard bypassed that
   must miss; the bf16 grade against its plain version with a control
   whose products return bf16), each timed in a CUDA graph beside its
   bound; served at B in {1, 64, 1024} in the exact grade (26 K1 a
   forward; logits within 1e-4 of the plain versions and of float64),
   the bf16 grade (26 K1; 4e-3) and the AMP grade (4 K1 for the cached
   operators, none a request; 4e-3); trained at B = 64 and 256 in the
   three grades (26 K1 + 26 K3 a step, or 4 K1): the exact grade's loss
   and every gradient within 1e-4 of the plain versions and float64; the
   bf16 and AMP grades' loss within 4e-3, their model gradients within
   3e-2 of the plain versions', as the sound runs' (the plain versions
   with every K product's float32 sum in another order) must be and the
   bf16-output control's must not, and each
   SymmetricLayer call replayed on the plain step's input and cotangent
   (``replay_calls``, flipped ReLU decisions logged) with a bf16-output
   control that must miss; 50 steps with a falling loss, images/s and
   the busy share; the serve CLI with --amp;
10b. the device epoch (``TrainConfig.device_epoch``: the Trainer's train
   step captured in a CUDA graph and replayed over a device-resident
   split): the flagship per-sweep and fused at B = 64 and 256, mnist
   per-sweep and fused at 128 (and fused with grad_accum 2: two captured
   bodies), svhn at 256, emotion at 64, tiny_imagenet at 32 and the hybrid
   (bf16) at 64, each on seeded data beside the same Trainer run eagerly:
   the weights after a 50-step epoch (warm-up and capture included)
   within 1e-6 of each tensor's largest entry of the eager run's, bit for
   bit logged (tiny_imagenet with cuDNN's deterministic algorithms, two
   eager steps without them logged); the on-device eval's predictions
   equal to the host eval's; images/s by CUDA events over a second epoch
   (50 captured steps, or 10 eager ones), busy share and launch calls a
   step over a profiled third of 5 (graph and eager side by side); the
   train CLI with --device-epoch --data-dir on a CIFAR-10 pickle
   fixture (queued for phase 12);
10c. serving (ROADMAP.md A13): ``make_predict_fn``, one CUDA graph a
   bucket (1, 64, 1024), against the eager predict on requests of 1, 7,
   64, 300 and 1024 images for the flagship per-sweep, fused, and hoisted
   f32 and bf16 (cached), and mnist per-sweep and fused: launches at
   warm-up and capture and none from Python at a replay, logits within
   1e-6 of their largest entry (bit for bit logged), the model's probs
   and labels predicts replaying the same graphs (probs within 1e-6,
   labels equal), images/s of both in turns at B = 1, 64, 1024, busy
   share and launch calls a request; the same checks without the rates
   on svhn hoisted bf16 (cached), emotion, tiny_imagenet (exact and AMP)
   and the hybrid (exact, bf16, AMP cached);
   ``linearize_pde_layers`` on the flagship per-sweep (the identity basis
   through K1), fused (K2 at B = 3,072) and mnist fused (K6 at B = 784):
   each composed matrix within 1e-5 of the plain versions' basis, the f32,
   bf16 and int8 grades served captured against the sequential predict
   (1e-4; rtol and atol 2e-2; 2e-2 of the largest entry and int8 labels
   equal on 16 images) and their images/s at B in {1, 16, 64, 256, 1024}
   (the ``select_linearize_grade`` table); ``export_model`` of the
   flagship per-sweep, fused and int8-linearized, each loaded in one fresh
   process that imports only the port (queued), within 1e-6 of the
   predict;
   ``serve_http`` on the serve CLI's captured flagship predicts
   (``serve_cli.warmed_predict_fns``; micro-batch 64, pipeline 2,
   buckets 1, 8, 64) under 8 client threads, every response within 1e-6
   of its eager logits, and across the CLI's reload to other weights; the
   serve CLI with --linearize auto --buckets, --export and --http
   (queued);
11. times of each kernel and its plain version beside the least time the
   card could take: K2 at B in {1, 64, 512} and K4 and K5 at B in {64, 512}
   on the 8-step Strang branch, launched back to back through their C entry
   points in a CUDA graph and by CUDA events around wrapper calls; K6 at
   B in {1, 128, 1024} and K7 and K8 at B in {128, 1024} on the mnist layer,
   and K6 on the fashion_mnist layer at B in {1, 128, 1024}, the same two
   ways; K1 and K3 at the
   main path's shapes (the flagship's sweeps at B = 64 and 512, the mnist
   layer's at B = 128 and 1024), in a CUDA graph, L2-warm and cold, with
   the wrapper's call time, the plain version, the bound and
   torch.linalg.solve on the dense system as the library yardstick;
12. every queued CLI run, four at a time, beside the Trainer through the
   train CLI: the hybrid at B = 64 for 2 epochs with checkpoints and a metrics
   file, a run stopped by SIGTERM in epoch 1 and resumed must end on the
   uninterrupted run's weights bit for bit; emotion for up to 60 epochs
   with its early stopping, then served from its checkpoint directory;
13. the ``kernels`` JSON line (K1's row also carries the operator build's
   figures and its hoisted, Tiny-ImageNet and hybrid launch counts, K3's
   the hybrid's), then the contract line.

Exits non-zero without a result when CUDA is unavailable.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import json
import os
import pickle
import shutil
import signal
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import cnn_pde_tpu_torch.layers as layers_module
import cnn_pde_tpu_torch.pde.ruthotto as ruthotto_module
from cnn_pde_tpu_torch.data import (NORMALIZATION, SYNTHETIC_SPECS,
                                    ArrayDataset)
from cnn_pde_tpu_torch.data.synthetic import make_synthetic
from cnn_pde_tpu_torch.models import build_model
from cnn_pde_tpu_torch.models.cifar10_noconv import MultiScaleExtractor
from cnn_pde_tpu_torch.ops import kernels
from cnn_pde_tpu_torch.ops import tridiag as tridiag_module
from cnn_pde_tpu_torch.ops.adi import _neumann_b, apply_sweep, sweep_operator
from cnn_pde_tpu_torch.ops.fused_channel import _ARGTYPES as FWD_ARGTYPES
from cnn_pde_tpu_torch.ops.fused_channel import (
    _dt_factors, fused_channel_diffusion_fwd, fused_channel_diffusion_plain,
    plan_tiles)
from cnn_pde_tpu_torch.ops.fused_channel import bind as bind_fused
from cnn_pde_tpu_torch.ops.fused_channel_vjp import \
    _BWD_ARGTYPES as BWD_ARGTYPES
from cnn_pde_tpu_torch.ops.fused_channel_vjp import (
    bwd_plan, fused_channel_bwd,
    fused_channel_bwd_plain, fused_channel_fwd_res,
    fused_channel_fwd_res_plain)
from cnn_pde_tpu_torch.ops.fused_grayscale import \
    _ARGTYPES as GRAY_ARGTYPES
from cnn_pde_tpu_torch.ops.fused_grayscale import bind as bind_gray
from cnn_pde_tpu_torch.ops.fused_grayscale import (
    factor_table, fused_grayscale_diffusion_fwd,
    fused_grayscale_diffusion_plain, plan_grayscale)
from cnn_pde_tpu_torch.ops.fused_grayscale_vjp import \
    _BWD_ARGTYPES as GRAY_BWD_ARGTYPES
from cnn_pde_tpu_torch.ops.fused_grayscale_vjp import (
    fused_grayscale_bwd, fused_grayscale_bwd_plain, fused_grayscale_fwd_res,
    fused_grayscale_fwd_res_plain)
from cnn_pde_tpu_torch.ops.smoothing import smooth3
from cnn_pde_tpu_torch.ops.tridiag import _ADJOINT_ARGTYPES, _ARGTYPES
from cnn_pde_tpu_torch.ops.tridiag import _bind as bind_thomas
from cnn_pde_tpu_torch.ops.tridiag import _line_shape
from cnn_pde_tpu_torch.ops.tridiag import _plan as tridiag_plan
from cnn_pde_tpu_torch.ops.tridiag import (gemm_route, tridiag_adjoint,
                                           tridiag_adjoint_plain,
                                           tridiag_inverse_operator,
                                           tridiag_solve, tridiag_solve_plain)
from cnn_pde_tpu_torch.pde import (SymmetricLayer, enable_amp,
                                   iter_adi_layers)
from cnn_pde_tpu_torch.pde.diffusion import (_coeff_at, _coeff_at_times,
                                             _substep_times_np)
from cnn_pde_tpu_torch.presets import PRESETS
from cnn_pde_tpu_torch.pde.linearize import iter_linear_pde_layers
from cnn_pde_tpu_torch.serve import (cache_hoisted_operators,
                                     clear_linear_cache,
                                     clear_operator_cache, export_model,
                                     linearize_pde_layers,
                                     make_eager_predict_fn, make_predict_fn)
from cnn_pde_tpu_torch.train import (TrainConfig, Trainer, cross_entropy,
                                     hybrid_pde_regularization,
                                     make_train_step, train_steps)
from cnn_pde_tpu_torch.train.graph import WARMUP_ROUNDS

SEED = 0
EPS = 1e-6
CMAX = 10.0
KERNEL_TOL = 1e-5   # same recurrence (K1, K3) or same system (K2, K4), fma
LOGIT_TOL = 1e-4    # the JAX package's full-model bound
GRAD_TOL = 1e-4     # relative to a tensor's largest entry: sums reordered
TRAIN = PRESETS["cifar10_noconv"]["train"]
GRAY_TRAIN = PRESETS["mnist"]["train"]
# the grayscale layers of the two presets (models/mlp_models.py):
# (dt, num_steps, init_value), all at 28 x 28 with dx = dy = 1
GRAY_LAYERS = {"mnist": (0.001, 10, 2.0), "fashion_mnist": (0.3, 4, 1.8)}
GRAY_KEYS = ("alpha_base", "alpha_time_coeff", "beta_base",
             "beta_time_coeff")
# gradients that are zero in exact arithmetic (a bias feeding a train-mode
# BatchNorm; the feature BN's bias, summed to zero over the batch by the
# BN1d head): there both paths must give |g| <= GRAD_TOL
ZERO_IN_EXACT_ARITHMETIC = {"feature_bn.bias"} | {
    f"classifier.network.{i}.bias" for i in (0, 4, 8, 12)}
USED_DEVICES = set()  # every device a model or kernel input was placed on
BUSY_REPS = 2  # profiled calls a busy-share reading averages
SCALES = MultiScaleExtractor.SCALES
# K1 and K3's cases: the flagship's sweeps at these batches (RAGGED_B not a
# multiple of the kernels' chunk), and bands (3, 5, N) and (3, N, 7) at
# these line lengths (one row a lane, two past 32)
RAGGED_B = 1000
THOMAS_BATCHES = (1, 7, 64, 128, 512, RAGGED_B, 1024)
THOMAS_NS = (1, 2, 3, 33, 64)
# K2, K4 and K5's cases: the flagship's (3, 32, 32) at these batches, and
# these shapes at these (lines of 28 rows; x-lines of 33; K5 with one
# factor buffer), and K2 also at FUSED_K2_SHAPES (one factor buffer, alpha
# not staged)
FUSED_BATCHES = (1, 7, 64, 512)
FUSED_SHAPES = ((1, 28, 28), (2, 20, 33), (3, 48, 64))
FUSED_SHAPE_BATCHES = (7, 300)
FUSED_K2_SHAPES = ((3, 64, 64),)
# K6, K7 and K8's cases beside the two presets' layers at GRAY_BATCHES:
# these (H, W) at these batches, on the mnist layer's settings (a 12-row
# line; a line of one row; the longest lines, whose halves pass through
# registers in chunks; H != W with H*W not a multiple of 4, K7's residual
# stores one float at a time; the longest lines whose halves stay in
# registers)
GRAY_BATCHES = (1, 7, 128, 1024)
GRAY_SHAPES = ((12, 12), (1, 28), (64, 64), (9, 13), (33, 20))
GRAY_SHAPE_BATCHES = (7, 300)
# (memory bytes/s, f32 non-tensor FLOP/s) from NVIDIA's data sheets
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100": (3.35e12, 67e12)}


def log(*parts):
    print(*parts, flush=True)


def card_peaks(name):
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise RuntimeError(f"no published peak rates for card {name!r}")


def max_err(x, y):
    return float((x.double() - y.double()).abs().max())


def check(label, err, tol):
    log(f"  {label}: max abs err {err:.3e} (tolerance {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{label}: {err} > {tol}")
    return err


def rel_err(x, y):
    """max |x - y| over the largest |y|: a gradient's error against its
    own scale."""
    y = y.double()
    return float((x.double() - y).abs().max()
                 / y.abs().max().clamp_min(1e-30))


def check_rel(label, err, tol, measure="max err", of="its largest entry"):
    log(f"  {label}: {measure} {err:.3e} of {of} (tolerance {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{label}: {err} > {tol}")
    return err


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fields(rng, device, C=3, H=32, W=32, straddle=False):
    """Trained-looking coefficient fields (C, H, W): bases 1 ± 0.5, time
    coefficients 5·N(0, 1), mixing I + 0.05·N(0, 1).  ``straddle``: bases
    uniform on [-0.5, CMAX + 0.5], so raw coefficients fall on both sides of
    both clamp bounds."""
    USED_DEVICES.add(torch.device(device))

    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    def base():
        if straddle:
            return t(rng.uniform(-0.5, CMAX + 0.5, (C, H, W)))
        return t(1.0 + 0.5 * rng.standard_normal((C, H, W)))
    return {
        "alpha_base": base(),
        "alpha_time_coeff": t(5.0 * rng.standard_normal((C, H, W))),
        "beta_base": base(),
        "beta_time_coeff": t(5.0 * rng.standard_normal((C, H, W))),
        "channel_mixing": t(np.eye(C) + 0.05 * rng.standard_normal((C, C))),
    }


FIELD_KEYS = ("alpha_base", "alpha_time_coeff", "beta_base",
              "beta_time_coeff", "channel_mixing")


def sweep_bands(field, dt, dh, dim):
    r = field * (dt / (dh * dh))
    return -r, (_neumann_b(r, dim) + EPS).contiguous(), -r


def bound(nbytes, flops, peak_bytes, peak_flops):
    """(ms, what bounds it): the larger of bytes over the memory rate and
    operations over the f32 rate."""
    by_bytes, by_ops = nbytes / peak_bytes, flops / peak_flops
    return 1e3 * max(by_bytes, by_ops), \
        "operations" if by_ops > by_bytes else "bytes"


def time_ms(fn, groups=20, per_group=10):
    """Median over groups of the mean time of one call, by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_group):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / per_group)
    return statistics.median(times)


WRAPPERS = {"K1": tridiag_solve, "K2": fused_channel_diffusion_fwd,
            "K3": tridiag_adjoint, "K4": fused_channel_fwd_res,
            "K5": fused_channel_bwd, "K6": fused_grayscale_diffusion_fwd,
            "K7": fused_grayscale_fwd_res, "K8": fused_grayscale_bwd}


def reset_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0


def counts():
    return {k: fn.launches for k, fn in WRAPPERS.items()}


def only(**launches):
    """The counts of a run that launched ``launches`` and nothing else."""
    return {k: launches.get(k, 0) for k in WRAPPERS}


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; nvidia-smi: {card}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}; TF32 off for matmul and cuDNN")
    return name, card


def fused_cases(rng, device, straddle, shapes=FUSED_SHAPES):
    """(label, state shape, field arguments, keywords) of K2's, K4's and
    K5's cases: the flagship's three branches (3, 32, 32), Strang and Lie,
    at FUSED_BATCHES, and ``shapes`` on the 8-step branch's settings at
    FUSED_SHAPE_BATCHES; fields from ``fields`` (``straddle``: raw values
    on both sides of both clamps)."""
    cases = [((3, 32, 32), scale, FUSED_BATCHES) for scale in SCALES]
    cases += [(shape, SCALES[1], FUSED_SHAPE_BATCHES) for shape in shapes]
    for shape, scale, batches in cases:
        f = fields(rng, device, *shape, straddle=straddle)
        args = [f[k] for k in FIELD_KEYS]
        ts = torch.tensor(_substep_times_np(scale["dt"], scale["num_steps"]),
                          dtype=torch.float32, device=device)
        for splitting in ("strang", "lie"):
            kw = dict(dt=scale["dt"], dx=scale["dx"], dy=scale["dy"], ts=ts,
                      splitting=splitting, eps=EPS, cmax=CMAX)
            for B in batches:
                yield (f"{shape} steps={scale['num_steps']} "
                       f"dx={scale['dx']} {splitting} B={B}", (B, *shape),
                       args, kw)


REPORTED_SOURCES = ("thomas", "fused_channel", "fused_channel_vjp",
                    "fused_grayscale", "fused_grayscale_vjp")


def phase_build():
    """Build every kernel; beside it, compile the sources of
    ``REPORTED_SOURCES`` once more to cubins with ``-Xptxas -v`` and print
    what ptxas reports for each of their kernels (registers, shared memory,
    spills).  One nvcc process a source, all started together."""
    t0 = time.perf_counter()
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    reports = {name: subprocess.Popen(
        [kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-Xptxas", "-v", "-cubin", "-o",
         str(kernels.BUILD_DIR / f"{name}-report.cubin"),
         str(kernels.CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in REPORTED_SOURCES}
    paths = kernels.build()
    log(f"[build] nvcc {' '.join(kernels.NVCC_FLAGS)}: "
        f"{', '.join(p.name for p in paths.values())} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        out, _ = report.communicate()
        if report.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v {name}.cu failed:\n{out}")
        for line in out.splitlines():
            if ("ptxas info" in line or "bytes stack frame" in line
                    or "ptxas warning" in line):
                log(f"[build] {name}.cu {line.strip()}")


def phase_kernels(device):
    rng = np.random.default_rng(SEED)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    chunk = tridiag_plan(RAGGED_B, 96, 32, 1, sms)[0]
    log(f"[kernels] K1 and K3 take B={RAGGED_B} in chunks of {chunk} "
        f"images on the flagship x-sweep ({sms} SMs)")
    if RAGGED_B % chunk == 0:
        raise AssertionError(f"B={RAGGED_B} is a multiple of the chunk")
    log("[kernels] K1 tridiag_solve against tridiag_solve_plain")
    k1_err = 0.0
    for scale in SCALES:
        f = fields(rng, device)
        ts = _substep_times_np(scale["dt"], scale["num_steps"])
        alpha = _coeff_at(f["alpha_base"], f["alpha_time_coeff"],
                          float(ts[-1, 2]), EPS, CMAX)
        beta = _coeff_at(f["beta_base"], f["beta_time_coeff"],
                         float(ts[-1, 1]), EPS, CMAX)
        for B in THOMAS_BATCHES:
            u = torch.rand((B, 3, 32, 32), device=device)
            for dim, field, dt in ((-1, alpha, scale["dt"] / 2),
                                   (-2, beta, scale["dt"])):
                bands = sweep_bands(field, dt, scale["dx"], dim)
                out = tridiag_solve(*bands, u, dim)
                torch.cuda.synchronize()
                ref = tridiag_solve_plain(*bands, u, dim)
                k1_err = max(k1_err, check(
                    f"dt={scale['dt']} dx={scale['dx']} B={B} "
                    f"{'x' if dim == -1 else 'y'}-sweep",
                    max_err(out, ref), KERNEL_TOL))
    for n in THOMAS_NS:
        for dim, shape in ((-1, (3, 5, n)), (-2, (3, n, 7))):
            r = torch.rand(shape, device=device) * 2.0
            bands = (-r, (_neumann_b(r, dim) + EPS).contiguous(), -r)
            for B in (7, 300):
                u = torch.rand((B, *shape), device=device)
                out = tridiag_solve(*bands, u, dim)
                torch.cuda.synchronize()
                k1_err = max(k1_err, check(
                    f"bands {shape} dim={dim} B={B}", max_err(
                        out, tridiag_solve_plain(*bands, u, dim)),
                    KERNEL_TOL))

    log("[kernels] K2 fused_channel_diffusion_fwd against its plain version")
    k2_err = 0.0
    for label, shape, args, kw in fused_cases(
            rng, device, False, FUSED_SHAPES + FUSED_K2_SHAPES):
        u = torch.rand(shape, device=device)
        out = fused_channel_diffusion_fwd(u, *args, **kw)
        torch.cuda.synchronize()
        ref = fused_channel_diffusion_plain(u, *args, **kw)
        k2_err = max(k2_err, check(label, max_err(out, ref), KERNEL_TOL))

    log("[kernels] K3 tridiag_adjoint against tridiag_adjoint_plain "
        "(λ abs, band gradients relative)")
    k3_abs, k3_rel = 0.0, 0.0

    def k3_case(label, bands, shape, dim, B):
        nonlocal k3_abs, k3_rel
        x = tridiag_solve_plain(*bands, torch.rand((B, *shape),
                                                   device=device),
                                dim).contiguous()
        g = torch.randn((B, *shape), device=device)
        out = tridiag_adjoint(*bands, g, x, dim)
        torch.cuda.synchronize()
        ref = tridiag_adjoint_plain(*bands, g, x, dim)
        k3_abs = max(k3_abs, check(f"{label} λ", max_err(out[0], ref[0]),
                                   KERNEL_TOL))
        for name, o, r in zip(("a", "b", "c"), out[1:], ref[1:]):
            k3_rel = max(k3_rel, check_rel(f"{label} grad_{name}",
                                           rel_err(o, r), GRAD_TOL))
            k3_abs = max(k3_abs, max_err(o, r))

    for scale in SCALES:
        f = fields(rng, device)
        ts = _substep_times_np(scale["dt"], scale["num_steps"])
        alpha = _coeff_at(f["alpha_base"], f["alpha_time_coeff"],
                          float(ts[-1, 2]), EPS, CMAX)
        beta = _coeff_at(f["beta_base"], f["beta_time_coeff"],
                         float(ts[-1, 1]), EPS, CMAX)
        for B in THOMAS_BATCHES:
            for dim, field, dt in ((-1, alpha, scale["dt"] / 2),
                                   (-2, beta, scale["dt"])):
                k3_case(f"dt={scale['dt']} dx={scale['dx']} B={B} "
                        f"{'x' if dim == -1 else 'y'}-sweep",
                        sweep_bands(field, dt, scale["dx"], dim),
                        (3, 32, 32), dim, B)
    for n in THOMAS_NS:
        for dim, shape in ((-1, (3, 5, n)), (-2, (3, n, 7))):
            r = torch.rand(shape, device=device) * 2.0
            for B in (7, 300):
                k3_case(f"bands {shape} dim={dim} B={B}",
                        (-r, (_neumann_b(r, dim) + EPS).contiguous(), -r),
                        shape, dim, B)

    log("[kernels] K4 fused_channel_fwd_res and K5 fused_channel_bwd "
        "against their plain versions (fields straddle both clamps); K5 "
        "twice on the same inputs, equal bit for bit")
    k4_err, k5_abs, k5_rel = 0.0, 0.0, 0.0
    for label, shape, args, kw in fused_cases(rng, device, straddle=True):
        u = torch.rand(shape, device=device)
        out, res = fused_channel_fwd_res(u, *args, **kw)
        torch.cuda.synchronize()
        ref_out, ref_res = fused_channel_fwd_res_plain(u, *args, **kw)
        k4_err = max(k4_err, check(f"K4 {label} output",
                                   max_err(out, ref_out), KERNEL_TOL),
                     check(f"K4 {label} residuals",
                           max_err(res, ref_res), KERNEL_TOL))
        g = torch.randn_like(u)
        grads = fused_channel_bwd(g, res, out, *args, **kw)
        again = fused_channel_bwd(g, res, out, *args, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f"K5 {label}: two runs differ")
        ref = fused_channel_bwd_plain(g, res, out, *args, **kw)
        ref64 = fused_channel_bwd_plain(
            *(t.double() for t in (g, res, out, *args)),
            **dict(kw, ts=kw["ts"].double()))
        far = []
        for name, o, r, d in zip(("u",) + FIELD_KEYS, grads, ref, ref64):
            k5_rel = max(k5_rel, check_rel(f"K5 {label} grad {name}",
                                           rel_err(o, r), GRAD_TOL))
            k5_abs = max(k5_abs, max_err(o, r))
            far.append(f"{name} {rel_err(o, d):.2e} / {rel_err(r, d):.2e}")
        log(f"  K5 {label} against the plain version in float64, kernel / "
            f"float32 plain, of each gradient's largest entry: "
            + ", ".join(far))
    return {"K1": k1_err, "K2": k2_err, "K3": (k3_abs, k3_rel),
            "K4": k4_err, "K5": (k5_abs, k5_rel)}


def flagship(device, fused=False, fused_pde=False, dropout_rate=0.3,
             fields_seed=SEED + 1):
    """The flagship with init from a seeded generator and its PDE fields
    replaced by trained-looking ones seeded by ``fields_seed``, so the
    clamps and the time bookkeeping are exercised."""
    model = build_model("cifar10_noconv", device=device,
                        generator=torch.Generator().manual_seed(SEED),
                        fused_inference=fused, fused_pde=fused_pde,
                        dropout_rate=dropout_rate)
    USED_DEVICES.add(next(model.parameters()).device)
    rng = np.random.default_rng(fields_seed)
    with torch.no_grad():
        for i in (1, 2, 3):
            pde = getattr(model.feature_extractor, f"pde{i}")
            for key, value in fields(rng, device).items():
                getattr(pde, key).copy_(value)
    return model


def device_busy(fn, reps, device, warm=True):
    """(busy share, host-clock µs a call, top kernels by device time, top
    host ops by self CPU time, kernel launch calls a call by the runtime
    and by the driver API, CUDA graph launches a call) of ``reps``
    calls of ``fn``: the time of the
    device's own events (kernels and copies, not the PyTorch ops that
    launched them) summed by torch.profiler over the wall time; None when
    the profiler recorded no device event.  ``warm``: one call of ``fn``
    first, outside the profile."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync(device)
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        # the device's own kernels and copies; a user annotation (such as
        # the optimizer's step range) spans kernels already counted
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
    device_us = sum(by_name.values())
    if device_us <= 0:
        return None
    top = sorted(by_name.items(), key=lambda r: -r[1])[:3]
    host = sorted(prof.key_averages(), key=lambda r: -r.self_cpu_time_total)
    # kernel launches by the runtime API: cudaLaunchKernel, and
    # cudaLaunchKernelExC for the grayscale kernels' dependent launches
    launches = sum(r.count for r in host
                   if r.key.startswith("cudaLaunchKernel"))
    # and by the driver API (cuLaunchKernel, cuLaunchKernelEx), which
    # cuBLAS may use
    driver = sum(r.count for r in host if r.key.startswith("cuLaunchKernel"))
    # and the replays of CUDA graphs
    graphs = sum(r.count for r in host if r.key.startswith("cudaGraphLaunch"))
    return (device_us / wall_us, wall_us / reps,
            "; ".join(f"{k[:48]} {100 * t / device_us:.0f}%" for k, t in top),
            "; ".join(f"{r.key[:40]} x{r.count // reps} "
                      f"{r.self_cpu_time_total / reps / 1e3:.2f} ms"
                      for r in host[:6]), launches / reps, driver / reps,
            graphs / reps)


def serve_family(tag, device, make_model, shape, batches, expected, reps,
                 seed, classes=10):
    """The eager predict (``make_eager_predict_fn``: one launch a kernel
    call, so that the counts are a forward's) on ``make_model(config)`` for
    each configuration
    of ``expected`` ({config: {kernel: launches a forward}}), over one
    request of each batch in ``batches`` of seeded images of ``shape``: the
    launch counts of that run, logits (``classes`` a row) within LOGIT_TOL
    of the same model on its plain versions with equal labels, then
    images/s (host clock, ``reps[B]`` requests after one warm-up).
    Returns (counts a config, rates)."""
    rng = np.random.default_rng(seed)
    images = {B: rng.random((B, *shape)).astype(np.float32)
              for B in batches}
    launches, rates = {}, {}
    for config, per in expected.items():
        predict = make_eager_predict_fn(make_model(config), output="logits")
        reset_counts()
        logits = {B: predict(images[B]) for B in batches}
        torch.cuda.synchronize()
        got = counts()
        log(f"[{tag}] {config}: launches {got} over {len(batches)} forwards")
        if got != only(**{k: n * len(batches) for k, n in per.items()}):
            raise AssertionError(f"{config}: expected {per} a forward")
        launches[config] = got
        with kernels.plain_versions():
            plain = {B: predict(images[B]) for B in batches}
        for B in batches:
            out = logits[B]
            if out.shape != (B, classes) or not torch.isfinite(out).all():
                raise AssertionError(f"{config} B={B}: bad logits {out.shape}")
            check(f"{config} B={B} logits vs plain versions",
                  max_err(out, plain[B]), LOGIT_TOL)
            if not torch.equal(out.argmax(-1), plain[B].argmax(-1)):
                raise AssertionError(f"{config} B={B}: labels differ")
        for B in batches:
            rates[f"{config}_B{B}"] = request_rate(
                tag, config, predict, torch.from_numpy(images[B]).to(device),
                reps[B])
    return launches, rates


def request_rate(tag, label, predict, x, reps):
    """images/s of ``predict`` on ``x`` (host clock, ``reps`` requests
    after one warm-up)."""
    B = x.shape[0]
    predict(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        predict(x)
    torch.cuda.synchronize()
    rate = B * reps / (time.perf_counter() - t0)
    log(f"[{tag}] {label} B={B}: {rate:.1f} images/s (host clock, {reps} "
        "requests after one warm-up)")
    return rate


def run_cli(module, preset, *args):
    """``python -m module --preset preset args`` on the default device
    (cuda); its summary line."""
    cli = subprocess.run(
        [sys.executable, "-m", module, "--preset", preset, *args],
        capture_output=True, text=True, timeout=300, check=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    return json.loads(cli.stdout.strip().splitlines()[-1])


# CLI runs the phases queue, each a function that runs its processes,
# checks them and returns its log lines: phase_clis runs them together,
# after every timed phase, so that no process competes with a timing
CLI_JOBS = []
CLI_WORKERS = 4


def cli_later(tag, module, preset, *args, ok):
    """Queue ``run_cli(module, preset, *args)``; ``ok(summary)`` says
    whether its summary line is right."""
    def job():
        summary = run_cli(module, preset, *args)
        if not ok(summary):
            raise AssertionError(f"{module} --preset {preset} on cuda: "
                                 f"{summary}")
        return [f"[{tag}] python -m {module} --preset "
                f"{' '.join((preset, *args))} (default device cuda): "
                f"{summary}"]
    job.__name__ = f"{module} --preset {preset}"
    CLI_JOBS.append(job)


def phase_slice(device):
    launches, rates = serve_family(
        "slice", device, lambda config: flagship(device, config == "fused"),
        (3, 32, 32), (1, 64, 1024),
        {"per_sweep": {"K1": 51}, "fused": {"K2": 3}},
        {1: 30, 64: 20, 1024: 5}, SEED + 2)
    cli_later("slice", "cnn_pde_tpu_torch.serve", "cifar10_noconv",
              ok=lambda s: len(s["predictions"]) == 8)
    return launches, rates


def log_busy(tag, label, busy, what):
    if busy is None:
        log(f"[{tag}] {label}: device busy share not measured (the profiler "
            "recorded no kernel)")
    else:
        log(f"[{tag}] {label}: device busy {100 * busy[0]:.1f}% of "
            f"{busy[1]:.0f} us a {what} (profiler on), device time "
            f"{busy[0] * busy[1]:.0f} us; top kernels: "
            f"{busy[2]}; top host ops a {what} (calls, self CPU time): "
            f"{busy[3]}; kernel launch calls (cudaLaunchKernel and "
            f"cudaLaunchKernelExC) a {what}: {busy[4]:g}, and by the "
            f"driver API (cuLaunchKernel): {busy[5]:g}")


def phase_profile(device):
    """Device busy share of a served forward (``device_busy`` over 5
    requests)."""
    rng = np.random.default_rng(SEED + 4)
    for config in ("per_sweep", "fused"):
        predict = make_eager_predict_fn(flagship(device, config == "fused"))
        for B in (1, 1024):
            x = torch.from_numpy(
                rng.random((B, 3, 32, 32)).astype(np.float32)).to(device)
            log_busy("profile", f"{config} B={B}",
                     device_busy(lambda: predict(x), BUSY_REPS, device),
                     "request")


def spiked_images(rng, B):
    """Images in [0, 0.5) with one pixel at 1 in every 8x8 max-pool window
    of every channel, so that each window's maximum stands clear of the
    rest after the short diffusion: at a near tie, a rounding difference of
    1e-7 between two paths moves the pool's argmax and every gradient
    upstream with it."""
    x = 0.5 * rng.random((B, 3, 32, 32))
    oy = rng.integers(0, 8, (B, 3, 4, 4)) + 8 * np.arange(4)[:, None]
    ox = rng.integers(0, 8, (B, 3, 4, 4)) + 8 * np.arange(4)[None, :]
    b, c = np.meshgrid(np.arange(B), np.arange(3), indexing="ij")
    x[b[..., None, None], c[..., None, None], oy, ox] = 1.0
    return x.astype(np.float32)


def _pool_indices(mod, x):
    """The argmax of each window of a max pool ``mod`` on ``x``."""
    if isinstance(mod, torch.nn.AdaptiveMaxPool2d):
        return torch.nn.functional.adaptive_max_pool2d(
            x, mod.output_size, return_indices=True)[1]
    return torch.nn.functional.max_pool2d(
        x, mod.kernel_size, mod.stride, mod.padding, return_indices=True)[1]


def train_grads(model, x, y, smoothing, relu_masks=None, regularizer=None):
    """Loss and gradients of one train-mode forward and backward (a
    parameter the forward did not read at zero; ``regularizer``: the
    alphas of ``hybrid_pde_regularization``, added to the loss).  Every
    ReLU's mask (output > 0) and every max pool's argmax, at each call of
    the module, is recorded into ``relu_masks`` when it is an empty dict,
    and replayed from it otherwise: a pre-activation within rounding of 0,
    or a window's near tie, would flip between two runs and move whole
    gradient rows, so the reference run takes the kernel run's
    decisions."""
    hooks = []
    replay = bool(relu_masks)
    calls = {}

    def key(name):
        calls[name] = calls.get(name, 0) + 1
        return f"{name}#{calls[name]}"

    def relu_hook(name):
        def hook(mod, inp, out):
            k = key(name)
            if replay:
                return inp[0] * relu_masks[k]
            relu_masks[k] = (out > 0).to(out.dtype)
        return hook

    def pool_hook(name):
        def hook(mod, inp, out):
            k = key(name)
            if replay:
                return inp[0].flatten(2).gather(
                    2, relu_masks[k].flatten(2)).view_as(out)
            relu_masks[k] = _pool_indices(mod, inp[0].detach())
        return hook

    for name, m in model.named_modules():
        if relu_masks is None:
            break
        if isinstance(m, torch.nn.ReLU):
            hooks.append(m.register_forward_hook(relu_hook(name)))
        elif isinstance(m, (torch.nn.MaxPool2d, torch.nn.AdaptiveMaxPool2d)):
            hooks.append(m.register_forward_hook(pool_hook(name)))
    model.train()
    model.zero_grad(set_to_none=True)
    try:
        loss = cross_entropy(model(x), y, smoothing)
        if regularizer is not None:
            loss = loss + hybrid_pde_regularization(model, *regularizer)
        loss.backward()
    finally:
        for h in hooks:
            h.remove()
    return loss.detach(), {n: torch.zeros_like(p) if p.grad is None
                           else p.grad for n, p in model.named_parameters()}


def train_family(tag, make_model, values, data, expected, batch, inputs,
                 grad_batches, rate_batches, rng, zero_names=()):
    """For each configuration of ``expected`` ({config: {kernel: launches a
    step}}), with ``make_model(config, dropout_rate)`` (None: the model's
    own rate): the launch counts of one ``make_train_step`` step at
    ``batch``; the loss and every gradient within GRAD_TOL of the same
    train-mode step on the plain versions at each B of ``grad_batches``
    (``inputs(B)`` gives the images and labels; dropout off; the kernel
    run's ReLU masks replayed; ``zero_names``: gradients that are zero in
    exact arithmetic, where both paths must give |g| <= GRAD_TOL); 50
    steps at ``batch`` on ``data`` with a falling loss; then images/s (CUDA
    events) and the device's busy share of a step at each B of
    ``rate_batches``.  Returns (counts, rates, first and last loss) by
    configuration."""
    device = data[0].device
    steps_per_epoch = max(data[0].shape[0] // batch, 1)
    launches, rates, losses = {}, {}, {}
    for config, per in expected.items():
        model = make_model(config, None)
        step = make_train_step(model, values, steps_per_epoch,
                               torch.Generator(device).manual_seed(SEED))
        x, y = data[0][:batch], data[1][:batch]
        step(x, y)
        sync(device)
        reset_counts()
        loss, _ = step(x, y)
        sync(device)
        got = counts()
        log(f"[{tag}] {config}: launches in one train step at B={batch}: "
            f"{got}")
        if got != only(**per):
            raise AssertionError(f"{config}: expected {per} a step")
        if not torch.isfinite(loss):
            raise AssertionError(f"{config}: loss {loss}")
        launches[config] = got

        for B in grad_batches:
            xs, ys = inputs(B)
            masks = {}
            loss_k, grads_k = train_grads(make_model(config, 0.0), xs, ys,
                                          values["label_smoothing"], masks)
            with kernels.plain_versions():
                loss_p, grads_p = train_grads(make_model(config, 0.0), xs,
                                              ys, values["label_smoothing"],
                                              masks)
                loss_d, grads_d = train_grads(
                    make_model(config, 0.0).double(), xs.double(), ys,
                    values["label_smoothing"], masks)
            sync(device)
            worst, where = rel_err(loss_k, loss_p), "loss"
            # the kernel path's and the float32 plain path's distance from
            # the float64 plain run: the float32 rounding floor of the step
            far = {"kernels": (rel_err(loss_k, loss_d), "loss"),
                   "float32 plain": (rel_err(loss_p, loss_d), "loss")}
            for name, g in grads_k.items():
                if name in zero_names:
                    size = max(g.abs().max().item(),
                               grads_p[name].abs().max().item())
                    if not size <= GRAD_TOL:
                        raise AssertionError(f"{config} B={B} {name}: {size}")
                    continue
                err = rel_err(g, grads_p[name])
                if err > worst:
                    worst, where = err, name
                for path, got in (("kernels", g),
                                  ("float32 plain", grads_p[name])):
                    far[path] = max(far[path],
                                    (rel_err(got, grads_d[name]), name))
            check_rel(f"{config} B={B} loss and every gradient vs plain "
                      f"versions (worst: {where})", worst, GRAD_TOL)
            log(f"  {config} B={B} against the same step in float64 on the "
                f"plain versions (the same ReLU masks), worst of the loss "
                f"and every gradient: " + "; ".join(
                    f"{path} {err:.3e} ({name})"
                    for path, (err, name) in far.items()))

        step, losses[config] = train_falling(
            tag, config, lambda rate: make_model(config, rate), values, data,
            batch)
        for B in rate_batches:
            rates.update({f"{config}_{k}": v for k, v in step_rates(
                tag, config, step, data, B, rng).items()})
    return launches, rates, losses


def check_train_cli(tag, preset):
    """Queue the train CLI with ``preset`` on cuda: one epoch of 5 steps at
    B = 16 (the synthetic sets hold 140 to 200 training images, so the
    presets' batches of 64-256 make 0-3 steps an epoch)."""
    cli_later(tag, "cnn_pde_tpu_torch.train", preset, "--synthetic",
              "--epochs", "1", "--steps", "5", "--batch-size", "16",
              ok=lambda s: s["steps"] == 5 and s["device"].startswith("cuda")
              and np.isfinite(s["last_loss"]))


def phase_train(device):
    """The flagship training step, per-sweep and fused."""
    rng = np.random.default_rng(SEED + 5)
    images, labels, _, _ = make_synthetic("cifar10")
    data = (torch.from_numpy(images).to(device),
            torch.from_numpy(labels).to(device))

    def inputs(B):
        return (torch.from_numpy(spiked_images(rng, B)).to(device),
                torch.from_numpy(rng.integers(0, 10, B)).to(device))

    result = train_family(
        "train", lambda config, rate: flagship(
            device, fused_pde=config == "fused",
            **({} if rate is None else {"dropout_rate": rate})),
        TRAIN, data, {"per_sweep": {"K1": 51, "K3": 51},
                      "fused": {"K4": 3, "K5": 3}},
        64, inputs, (64, 256), (64, 256), rng,
        zero_names=ZERO_IN_EXACT_ARITHMETIC)
    check_train_cli("train", "cifar10_noconv")
    return result


def gray_fields(rng, device, preset, straddle=False, shape=(28, 28)):
    """(H, W) coefficient fields for the grayscale layer of ``preset``:
    bases init ± 0.5 (``straddle``: uniform on [-0.5, 2·init], so that raw
    values fall on both sides of eps), time coefficients N(0, 1) over the
    layer's horizon, so that they move each coefficient by about 1 over
    it."""
    USED_DEVICES.add(torch.device(device))
    dt, steps, init = GRAY_LAYERS[preset]

    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    def base():
        if straddle:
            return t(rng.uniform(-0.5, 2.0 * init, shape))
        return t(init + 0.5 * rng.standard_normal(shape))

    def tc():
        return t(rng.standard_normal(shape) / (dt * steps))
    return {"alpha_base": base(), "alpha_time_coeff": tc(),
            "beta_base": base(), "beta_time_coeff": tc()}


def gray_kwargs(preset, device):
    dt, steps, _ = GRAY_LAYERS[preset]
    ts = torch.tensor(_substep_times_np(dt, steps), dtype=torch.float32,
                      device=device)
    return dict(dt=dt, dx=1.0, dy=1.0, ts=ts, eps=EPS)


def phase_gray_kernels(device):
    """K6, K7 and K8 against their plain versions on the two presets'
    layers at GRAY_BATCHES and on GRAY_SHAPES at GRAY_SHAPE_BATCHES; K1 and
    K3 on the grayscale per-sweep path's smoothed bands."""
    rng = np.random.default_rng(SEED + 6)
    log("[kernels] K6 fused_grayscale_diffusion_fwd, K7 "
        "fused_grayscale_fwd_res and K8 fused_grayscale_bwd against their "
        "plain versions (fields straddle eps); K8 twice, bit for bit")
    errs = [0.0, 0.0, 0.0, 0.0]  # K6, K7, K8 abs, K8 of the largest entry
    for preset in GRAY_LAYERS:
        f = gray_fields(rng, device, preset, straddle=True)
        for B in GRAY_BATCHES:
            gray_case(errs, f"{preset}", f, gray_kwargs(preset, device),
                      torch.rand((B, 28, 28), device=device))

    log("[kernels] K1 and K3 on the grayscale layer's smoothed sweeps "
        "(mnist, B=1024, 28x28)")
    k1, k3_abs, k3_rel = 0.0, 0.0, 0.0
    f = gray_fields(rng, device, "mnist")
    dt, steps, _ = GRAY_LAYERS["mnist"]
    t_last = float(_substep_times_np(dt, steps)[-1, 2])
    u = torch.rand((1024, 28, 28), device=device)
    g = torch.randn_like(u)
    for dim, key, dtf in ((-1, "alpha", dt / 2), (-2, "beta", dt)):
        field = _coeff_at(f[f"{key}_base"], f[f"{key}_time_coeff"], t_last,
                          EPS)
        bands = sweep_bands(smooth3(field, dim), dtf, 1.0, dim)
        label = f"{'x' if dim == -1 else 'y'}-sweep"
        x = tridiag_solve(*bands, u, dim)
        torch.cuda.synchronize()
        k1 = max(k1, check(f"K1 {label}",
                           max_err(x, tridiag_solve_plain(*bands, u, dim)),
                           KERNEL_TOL))
        out = tridiag_adjoint(*bands, g, x, dim)
        torch.cuda.synchronize()
        ref = tridiag_adjoint_plain(*bands, g, x, dim)
        k3_abs = max(k3_abs, check(f"K3 {label} λ", max_err(out[0], ref[0]),
                                   KERNEL_TOL))
        for name, o, r in zip(("a", "b", "c"), out[1:], ref[1:]):
            k3_rel = max(k3_rel, check_rel(f"K3 {label} grad_{name}",
                                           rel_err(o, r), GRAD_TOL))
            k3_abs = max(k3_abs, max_err(o, r))

    # their own generators, so that every case above sees the inputs it saw
    # before these were added
    rng = np.random.default_rng(SEED + 12)
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    for shape in GRAY_SHAPES:
        f = gray_fields(rng, device, "mnist", straddle=True, shape=shape)
        for B in GRAY_SHAPE_BATCHES:
            gray_case(errs, f"mnist {shape}", f, gray_kwargs("mnist", device),
                      torch.rand((B, *shape), device=device, generator=gen),
                      gen)
    return {"K1": k1, "K3": (k3_abs, k3_rel), "K6": errs[0], "K7": errs[1],
            "K8": (errs[2], errs[3])}


def gray_case(errs, label, f, kw, u, gen=None):
    """K6, K7 and K8 on input u against their plain versions, K8 twice and
    bit for bit; errs (K6, K7, K8 abs, K8 of a gradient's largest entry)
    takes each largest error."""
    args = [f[k] for k in GRAY_KEYS]
    label = f"{label} ({kw['ts'].shape[0]} steps) B={u.shape[0]}"
    out = fused_grayscale_diffusion_fwd(u, *args, **kw)
    torch.cuda.synchronize()
    errs[0] = max(errs[0], check(f"K6 {label}", max_err(
        out, fused_grayscale_diffusion_plain(u, *args, **kw)), KERNEL_TOL))
    out, res = fused_grayscale_fwd_res(u, *args, **kw)
    torch.cuda.synchronize()
    ref_out, ref_res = fused_grayscale_fwd_res_plain(u, *args, **kw)
    errs[1] = max(errs[1],
                  check(f"K7 {label} output", max_err(out, ref_out),
                        KERNEL_TOL),
                  check(f"K7 {label} residuals", max_err(res, ref_res),
                        KERNEL_TOL))
    g = torch.randn(u.shape, device=u.device, generator=gen)
    grads = fused_grayscale_bwd(g, res, out, *args, **kw)
    again = fused_grayscale_bwd(g, res, out, *args, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"K8 {label}: two runs differ")
    ref = fused_grayscale_bwd_plain(g, res, out, *args, **kw)
    for name, o, r in zip(("u",) + GRAY_KEYS, grads, ref):
        errs[3] = max(errs[3], check_rel(f"K8 {label} grad {name}",
                                         rel_err(o, r), GRAD_TOL))
        errs[2] = max(errs[2], max_err(o, r))


def grayscale_model(device, preset="mnist", fused_inference=False,
                    fused=False, dropout_rate=None):
    """The preset's classifier with init from a seeded generator and its PDE
    fields replaced by seeded trained-looking ones, so that the time
    bookkeeping is exercised."""
    model = build_model(preset, device=device,
                        generator=torch.Generator().manual_seed(SEED),
                        fused_inference=fused_inference, fused=fused,
                        **({} if dropout_rate is None
                           else {"dropout_rate": dropout_rate}))
    USED_DEVICES.add(next(model.parameters()).device)
    rng = np.random.default_rng(SEED + 7)
    with torch.no_grad():
        for key, value in gray_fields(rng, device, preset).items():
            getattr(model.diff, key).copy_(value)
    return model


def phase_grayscale(device):
    """The grayscale family: mnist served and trained in both
    configurations, and both CLIs; then fashion_mnist (4 steps, a BN head)
    served at B in {1, 128, 1024} and trained at B = 128 the same way."""
    launches, rates = serve_family(
        "gray-serve", device, lambda config: grayscale_model(
            device, fused_inference=config == "fused"),
        (1, 28, 28), (1, 128, 1024),
        {"per_sweep": {"K1": 30}, "fused": {"K6": 1}},
        {1: 30, 128: 20, 1024: 10}, SEED + 8)
    rng = np.random.default_rng(SEED + 9)
    for config in ("per_sweep", "fused"):
        predict = make_eager_predict_fn(grayscale_model(
            device, fused_inference=config == "fused"))
        for B in (1, 1024):
            x = torch.from_numpy(
                rng.random((B, 1, 28, 28)).astype(np.float32)).to(device)
            log_busy("gray-serve", f"{config} B={B}",
                     device_busy(lambda: predict(x), BUSY_REPS, device),
                     "request")
    cli_later("gray-serve", "cnn_pde_tpu_torch.serve", "mnist",
              ok=lambda s: len(s["predictions"]) == 8)

    # 640 synthetic images: 5 batches of 128 an epoch
    images, labels, _, _ = make_synthetic("mnist", train_per_class=64)
    data = (torch.from_numpy(images).to(device),
            torch.from_numpy(labels).to(device))

    def inputs(B):
        return (torch.from_numpy(rng.random((B, 1, 28, 28)).astype(
                    np.float32)).to(device),
                torch.from_numpy(rng.integers(0, 10, B)).to(device))

    train = train_family(
        "gray-train", lambda config, rate: grayscale_model(
            device, fused=config == "fused", dropout_rate=rate),
        GRAY_TRAIN, data, {"per_sweep": {"K1": 30, "K3": 30},
                           "fused": {"K7": 1, "K8": 1}},
        128, inputs, (128,), (128,), rng)
    check_train_cli("gray-train", "mnist")

    fashion_serve = serve_family(
        "fashion-serve", device, lambda config: grayscale_model(
            device, "fashion_mnist", fused_inference=config == "fused"),
        (1, 28, 28), (1, 128, 1024),
        {"per_sweep": {"K1": 12}, "fused": {"K6": 1}},
        {1: 30, 128: 20, 1024: 10}, SEED + 11)
    images, labels, _, _ = make_synthetic("fashion_mnist", train_per_class=64)
    data = (torch.from_numpy(images).to(device),
            torch.from_numpy(labels).to(device))
    fashion_train = train_family(
        "fashion-train", lambda config, rate: grayscale_model(
            device, "fashion_mnist", fused=config == "fused",
            dropout_rate=rate),
        PRESETS["fashion_mnist"]["train"], data,
        {"per_sweep": {"K1": 12, "K3": 12}, "fused": {"K7": 1, "K8": 1}},
        128, inputs, (128,), (128,), rng,
        # biases that feed a train-mode BatchNorm
        zero_names={"fc1.bias", "fc2.bias"})
    return (launches, rates), train, fashion_serve, fashion_train


# ---- the AMP grade (hoisted sweep operators) and SVHN -----------------------

AMP_OUT_TOL = 4e-3    # bf16 grade, card route against its plain versions
AMP_GRAD_TOL = 6e-3   # (outputs, gradients; of the largest entry)
# An ADI layer's output, element by element: the two routes sum in another
# order, and a state value within that rounding of a bf16 midpoint rounds
# the other way, one bf16 step (2^-8 to 2^-7 of the value) that later
# sweeps carry on; so the layer is held at two bf16 steps of its largest
# entry element by element, and in the RMS, where such flips are rare, at
# about five times the largest reading of the three families on an H100
# (5.5e-05 to 8.3e-05): a GEMM that rounds its outputs to bf16 rounds
# every element of the layer, about 2^-9 / sqrt(3) = 1.1e-3 in the RMS.
AMP_LAYER_MAX_TOL = 2.0 ** -6
AMP_LAYER_RMS_TOL = 4e-4
SVHN_TRAIN = PRESETS["svhn"]["train"]
# biases that feed a train-mode BatchNorm in the SVHN head
SVHN_ZERO = {f"fc{i}.bias" for i in (1, 2, 3, 4)}


def amp_switch(model, grade):
    """``model``'s ADI layers on the hoisted path: 'f32' (float32
    operators) or 'bf16' (``enable_amp``)."""
    if grade == "bf16":
        enable_amp(model)
    else:
        for layer in iter_adi_layers(model):
            layer.hoisted = True
    return model


def adi_outputs(model):
    """Forward hooks that keep each ADI layer's latest output; returns
    (outputs list, hooks)."""
    outs, hooks = [], []
    for layer in iter_adi_layers(model):
        hooks.append(layer.register_forward_hook(
            lambda mod, inp, out: outs.append(out.detach().clone())))
    return outs, hooks


def svhn_model(device, dropout_rate=None):
    """SVHN's classifier from a seeded generator, its ChannelCoupledDiffusion
    fields replaced by seeded ones that move over the horizon (bases
    0.1 ± 0.05, time coefficients N(0, 1), coupling I + 0.1·N(0, 1))."""
    model = build_model("svhn", device=device,
                        generator=torch.Generator().manual_seed(SEED),
                        **({} if dropout_rate is None
                           else {"dropout_rate": dropout_rate}))
    USED_DEVICES.add(next(model.parameters()).device)
    rng = np.random.default_rng(SEED + 13)
    shape = (3, 32, 32)
    values = {"alpha_base": 0.1 + 0.05 * rng.standard_normal(shape),
              "beta_base": 0.1 + 0.05 * rng.standard_normal(shape),
              "alpha_time_coeff": rng.standard_normal(shape),
              "beta_time_coeff": rng.standard_normal(shape),
              "channel_coupling": np.eye(3) + 0.1 * rng.standard_normal(
                  (3, 3))}
    with torch.no_grad():
        for key, value in values.items():
            getattr(model.diff, key).copy_(torch.tensor(value))
    return model


@contextlib.contextmanager
def bf16_gemm_outputs():
    """The control for the bf16 checks: every GEMM on bf16 operators
    returns bf16 (``torch.bmm`` on bf16 operands without ``out_dtype``),
    which rounds each of its outputs to bf16 before the float32 state
    takes it: a worse grade than the JAX one, which the checks must
    refuse."""
    bmm = tridiag_module._bmm

    def rounded(a, b):
        if b.dtype != torch.bfloat16:
            return bmm(a, b)
        return torch.bmm(a.to(torch.bfloat16), b).float()

    tridiag_module._bmm = rounded
    try:
        yield
    finally:
        tridiag_module._bmm = bmm


def bf16_readings(batches, big, logits, plain, layers, plain_layers):
    """The bf16 grade's readings against its plain versions, each (label,
    error, limit, measure, scale): logits of each B and every ADI layer's
    output at ``big``, in the RMS and element by element."""
    out = [(f"B={B} logits", rel_err(logits[B], plain[B]), AMP_OUT_TOL,
            "max err", "its largest entry") for B in batches]
    for i, (o, p) in enumerate(zip(layers, plain_layers)):
        rms = float((o.double() - p.double()).norm() / p.double().norm())
        out.append((f"B={big} ADI layer {i}", rms, AMP_LAYER_RMS_TOL, "RMS",
                    "the RMS"))
        out.append((f"B={big} ADI layer {i}, element by element",
                    rel_err(o, p), AMP_LAYER_MAX_TOL, "max err",
                    "its largest entry"))
    return out


def forward_with_layers(model, predict, batches, images):
    """Logits of one request of each B and every ADI layer's output at the
    last (largest) B."""
    outs, hooks = adi_outputs(model)
    logits = {B: predict(images[B]) for B in batches}
    for h in hooks:
        h.remove()
    return logits, outs[-len(hooks):]


def amp_serve(tag, device, make_model, shape, batches, builds, reps, seed):
    """The f32 and bf16 hoisted grades served by the eager predict with
    the operators cached (``cache_hoisted_operators``), against the
    per-sweep model (``make_model()``) on the same seeded requests.  Counts
    reset before the cache is built and read after one request of each B:
    ``builds`` K1 launches (two a layer) and nothing else.  f32: logits
    within LOGIT_TOL and every ADI layer's output within KERNEL_TOL of
    per-sweep.  bf16: logits within AMP_OUT_TOL of the largest entry
    against the same grade on its plain versions (bf16-rounded operands in
    a float32 GEMM, the grade the CPU tests hold against the JAX one), and
    layer outputs within AMP_LAYER_RMS_TOL in the RMS and
    AMP_LAYER_MAX_TOL element by element; their distance from per-sweep
    float32 is logged: the grade's own rounding, which grows with the
    sweeps (no bound).  The control (``bf16_gemm_outputs``) must exceed at
    least one of those limits.  Then images/s a B (host clock) of three
    routes taken in turns, three rounds of ``reps[B]`` requests each, the
    median: 'f32', 'bf16' (the card's route) and 'bf16_rounded_f32' (the
    bf16 model inside ``plain_versions()``, which with the operators
    cached changes only the GEMM route), and the busy share of each at the
    largest B.  Returns {route: (counts, rates)}."""
    rng = np.random.default_rng(seed)
    images = {B: torch.from_numpy(rng.random((B, *shape)).astype(
        np.float32)).to(device) for B in batches}
    big = max(batches)
    ref_model = make_model()
    ref, ref_layers = forward_with_layers(
        ref_model, make_eager_predict_fn(ref_model), batches, images)
    result, predicts = {}, {}
    for grade in ("f32", "bf16"):
        model = amp_switch(make_model(), grade)
        predict = make_eager_predict_fn(model)
        reset_counts()
        cached = cache_hoisted_operators(model)
        logits, layers = forward_with_layers(model, predict, batches, images)
        torch.cuda.synchronize()
        got = counts()
        log(f"[{tag}] {grade}: {cached} layers cached, launches {got} over "
            f"the cache and {len(batches)} requests; GEMM route "
            f"{gemm_route(model_operator_dtype(model), device)}")
        if got != only(K1=builds):
            raise AssertionError(f"{tag} {grade}: expected {builds} K1")
        for B in batches:
            if logits[B].shape != (B, 10) or not torch.isfinite(
                    logits[B]).all():
                raise AssertionError(f"{tag} {grade} B={B}: bad logits")
        if grade == "f32":
            for B in batches:
                check(f"{grade} B={B} logits vs per-sweep (K1)",
                      max_err(logits[B], ref[B]), LOGIT_TOL)
            for i, (o, r) in enumerate(zip(layers, ref_layers)):
                check(f"{grade} B={big} ADI layer {i} vs per-sweep",
                      max_err(o, r), KERNEL_TOL)
        else:
            with kernels.plain_versions():
                plain, plain_layers = forward_with_layers(
                    model, predict, batches, images)
            for label, err, tol, measure, of in bf16_readings(
                    batches, big, logits, plain, layers, plain_layers):
                check_rel(f"bf16 {label} vs its plain versions (bf16-"
                          "rounded operands, float32 GEMM)", err, tol,
                          measure, of)
            for B in batches:
                log(f"  bf16 B={B} logits vs per-sweep float32: "
                    f"{rel_err(logits[B], ref[B]):.3e} of the largest")
            for i, (o, r) in enumerate(zip(layers, ref_layers)):
                log(f"  bf16 B={big} ADI layer {i} vs per-sweep float32: "
                    f"{rel_err(o, r):.3e} of the largest")
            with bf16_gemm_outputs():
                trap, trap_layers = forward_with_layers(
                    model, predict, batches, images)
            failed = 0
            for label, err, tol, measure, of in bf16_readings(
                    batches, big, trap, plain, trap_layers, plain_layers):
                failed += not err <= tol
                log(f"  control (every bf16 GEMM returns bf16) {label} vs "
                    f"the plain versions: {measure} {err:.3e} of {of} "
                    f"(limit {tol:.0e}{'' if err <= tol else ', exceeded'})")
            if not failed:
                raise AssertionError(f"{tag}: the control passed every "
                                     "bf16 limit")
        predicts[grade] = predict
        result[grade] = (got, {})
    result["bf16_rounded_f32"] = (result["bf16"][0], {})
    routes = {"f32": (predicts["f32"], contextlib.nullcontext),
              "bf16": (predicts["bf16"], contextlib.nullcontext),
              "bf16_rounded_f32": (predicts["bf16"], kernels.plain_versions)}
    for B in batches:
        x = images[B]
        runs = {route: [] for route in routes}
        for _ in range(3):
            for route, (predict, ctx) in routes.items():
                with ctx():
                    predict(x)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(reps[B]):
                        predict(x)
                    torch.cuda.synchronize()
                runs[route].append(B * reps[B] / (time.perf_counter() - t0))
        for route, rates in runs.items():
            rate = statistics.median(rates)
            result[route][1][f"B{B}"] = rate
            log(f"[{tag}] {route} B={B}: {rate:.1f} images/s (host clock, "
                f"median of 3 rounds of {reps[B]} requests, routes in "
                f"turns; rounds {', '.join(f'{r:.1f}' for r in rates)})")
    for route, (predict, ctx) in routes.items():
        with ctx():
            busy = device_busy(lambda: predict(images[big]), BUSY_REPS,
                               device)
        log_busy(tag, f"{route} B={big}", busy, "request")
        if busy is not None:
            result[route][1][f"B{big}_busy"] = busy[0]
            result[route][1][f"B{big}_device_us_per_request"] = \
                busy[0] * busy[1]
            result[route][1][f"B{big}_launch_calls_per_request"] = busy[4]
    return result


def model_operator_dtype(model):
    return next(iter_adi_layers(model)).operator_dtype


def compare_grads(label, got, ref, tol, zero_names, rel_check=True,
                  vectors=()):
    """Worst of the loss and every gradient of ``got`` = (loss, grads)
    against ``ref``, relative to each one's largest entry (the names of
    each group in ``vectors`` as one vector); a gradient of ``zero_names``
    (zero in exact arithmetic) must be within GRAD_TOL of 0 on both sides
    instead.  Held at ``tol`` unless ``rel_check`` is False (then
    logged).  Returns the worst error and where."""
    worst, where = rel_err(got[0], ref[0]), "loss"
    grouped = {n for group in vectors for n in group}
    for name, g in got[1].items():
        if name in zero_names:
            size = max(g.abs().max().item(), ref[1][name].abs().max().item())
            if not size <= GRAD_TOL:
                raise AssertionError(f"{label} {name}: {size}")
            continue
        if name in grouped:
            continue
        err = rel_err(g, ref[1][name])
        if err > worst:
            worst, where = err, name
    for group in vectors:
        err = rel_err(torch.stack([got[1][n] for n in group]),
                      torch.stack([ref[1][n] for n in group]))
        if err > worst:
            worst, where = err, "+".join(group)
    if rel_check:
        check_rel(f"{label} (worst: {where})", worst, tol)
    else:
        log(f"  {label}: {worst:.3e} of its largest entry (worst: {where})")
    return worst, where


def amp_train(tag, make_model, values, data, batch, rate_batches, inputs,
              builds, zero_names, rng, steps=12):
    """The f32 and bf16 hoisted grades trained by ``make_train_step``:
    counts reset before one step at ``batch`` and read after it: ``builds``
    K1 launches (the operators are built in every training forward) and
    no K3 (the backward is GEMMs); the loss and every gradient of a
    train-mode step (dropout 0, the reference's ReLU masks) within
    GRAD_TOL of the per-sweep step (f32), or within AMP_GRAD_TOL of the
    same grade on its plain versions (bf16, with its distance from
    per-sweep float32 logged); ``steps`` steps with a falling loss; then
    images/s (CUDA events) at each B of ``rate_batches`` and the busy
    share there.  Returns {grade: (counts, rates,
    losses)}."""
    device = data[0].device
    steps_per_epoch = max(data[0].shape[0] // batch, 1)
    xs, ys = inputs(batch)
    masks = {}
    ref = train_grads(make_model(0.0), xs, ys, values["label_smoothing"],
                      masks)
    result = {}
    for grade in ("f32", "bf16"):
        model = amp_switch(make_model(None), grade)
        step = make_train_step(model, values, steps_per_epoch,
                               torch.Generator(device).manual_seed(SEED))
        x, y = data[0][:batch], data[1][:batch]
        step(x, y)
        sync(device)
        reset_counts()
        loss, _ = step(x, y)
        sync(device)
        got = counts()
        log(f"[{tag}] {grade}: launches in one train step at B={batch}: "
            f"{got}; GEMM route "
            f"{gemm_route(model_operator_dtype(model), device)}")
        if got != only(K1=builds):
            raise AssertionError(f"{tag} {grade}: expected {builds} K1")
        if not torch.isfinite(loss):
            raise AssertionError(f"{tag} {grade}: loss {loss}")
        run = train_grads(amp_switch(make_model(0.0), grade), xs, ys,
                          values["label_smoothing"], masks)
        if grade == "f32":
            compare_grads(f"f32 B={batch} loss and every gradient vs the "
                          "per-sweep step (K1, K3)", run, ref, GRAD_TOL,
                          zero_names)
        else:
            with kernels.plain_versions():
                plain = train_grads(amp_switch(make_model(0.0), grade), xs,
                                    ys, values["label_smoothing"], masks)
            compare_grads(f"bf16 B={batch} loss and every gradient vs its "
                          "plain versions", run, plain, AMP_GRAD_TOL,
                          zero_names)
            compare_grads(f"bf16 B={batch} vs the per-sweep float32 step",
                          run, ref, None, zero_names, rel_check=False)
        step, losses = train_falling(
            tag, grade, lambda rate: amp_switch(make_model(rate), grade),
            values, data, batch, steps)
        rates = {}
        for B in rate_batches:
            rates.update(step_rates(tag, grade, step, data, B, rng))
        result[grade] = (got, rates, losses)
    return result


def phase_amp_kernels(device, peak_bytes, peak_flops):
    """K1 as the operator builder: ``tridiag_inverse_operator`` on the
    flagship's largest stack (the 8-step branch's x stack: 8 steps × 2
    substeps × 3 channels × 32 rows of N = 32, one launch of batch 32)
    against its plain version, then timed (in a CUDA graph of calls, and
    by CUDA events around calls) beside the plain version, the bound and
    torch.linalg.inv on the dense matrices, and X built in bf16; one bf16
    sweep of the flagship at B = 64 against the float32 sweep, within
    AMP_OUT_TOL of the largest entry (bf16 rounds X and the state once
    each, by at most 2⁻⁸ of the value; the JAX record's figure for one
    solve is 4e-3); and one sweep's apply at B = 64 and 1024 by each GEMM
    route, timed."""
    rng = np.random.default_rng(SEED + 14)
    f = fields(rng, device)
    scale = SCALES[1]
    ts = torch.tensor(_substep_times_np(scale["dt"], scale["num_steps"]),
                      dtype=torch.float32, device=device)
    alpha = _coeff_at_times(f["alpha_base"], f["alpha_time_coeff"],
                            ts[:, [0, 2]], EPS, CMAX)
    a, b, c, _ = sweep_operator(alpha, scale["dt"] / 2, scale["dx"],
                                eps=EPS)
    n = alpha.shape[-1]
    rows = alpha.numel() // n
    log(f"[amp-kernels] K1 builds the operators of the 8-step branch's x "
        f"stack {tuple(alpha.shape)}: {rows} lines of N = {n}, batch {n}")
    reset_counts()
    X = tridiag_inverse_operator(a, b, c)
    torch.cuda.synchronize()
    if counts() != only(K1=1):
        raise AssertionError(f"operator build: {counts()}")
    with kernels.plain_versions():
        X_plain = tridiag_inverse_operator(a, b, c)
    err = check("K1 operator build vs its plain version", max_err(X, X_plain),
                KERNEL_TOL)
    T = (torch.diag_embed(b.reshape(rows, n))
         + torch.diag_embed(a.reshape(rows, n)[:, 1:], -1)
         + torch.diag_embed(c.reshape(rows, n)[:, :-1], 1))
    inv = torch.linalg.inv(T).transpose(-1, -2).reshape(X.shape)
    log(f"  K1 operator vs torch.linalg.inv of the dense matrices: "
        f"{max_err(X, inv):.3e}")
    # The function reads the bands and writes X, at X's dtype; per element
    # of X the recurrence's 5 flops, per band element 3.  The build moves
    # more: K1 reads the identity and writes its solutions (N, R, N) in
    # float32, and a copy reads them and writes X row-major.
    elems = rows * n * n
    flops = 5 * elems + 3 * rows * n
    build = dict(
        at=f"flagship 8-step x stack {tuple(alpha.shape)}", err=err,
        ms=graph_ms(lambda: [lambda: tridiag_inverse_operator(a, b, c)],
                    walks=20),
        call_ms=time_ms(lambda: tridiag_inverse_operator(a, b, c)),
        plain_ms=time_ms(lambda: tridiag_inverse_operator_plain(a, b, c),
                         groups=5, per_group=2),
        library_ms=time_ms(lambda: torch.linalg.inv(T), groups=10,
                           per_group=5))
    build["bound_ms"], build["bound_by"] = bound(
        4 * (elems + 3 * rows * n), flops, peak_bytes, peak_flops)
    build["moved_bytes"] = 4 * (4 * elems + 3 * rows * n)
    build["bf16_ms"] = graph_ms(lambda: [
        lambda: tridiag_inverse_operator(a, b, c, torch.bfloat16)], walks=20)
    build["bf16_bound_ms"] = bound(2 * elems + 12 * rows * n, flops,
                                   peak_bytes, peak_flops)[0]
    log(f"[amp-kernels] operator build: {build['ms']:.4f} ms in a CUDA "
        f"graph of calls (its K1 launch and the copy to X), "
        f"{build['call_ms']:.4f} ms a call (CUDA events, host included); "
        f"plain {build['plain_ms']:.4f} ms; bound {build['bound_ms']:.4f} "
        f"ms ({build['bound_by']}: bands in, X out); the build moves "
        f"{build['moved_bytes']} bytes, "
        f"{build['moved_bytes'] / (4 * (elems + 3 * rows * n)):.2f}x the "
        f"bound's; library torch.linalg.inv {build['library_ms']:.4f} ms; "
        f"X in bf16 {build['bf16_ms']:.4f} ms in a graph (bound "
        f"{build['bf16_bound_ms']:.4f} ms)")

    field = alpha[0, 0]
    ops = {dtype: sweep_operator(field, scale["dt"] / 2, scale["dx"],
                                 eps=EPS, dtype=dtype)
           for dtype in (torch.float32, torch.bfloat16)}
    u = torch.rand((64, *field.shape), device=device)
    outs = {dtype: apply_sweep(op, u) for dtype, op in ops.items()}
    exact = tridiag_solve(*sweep_bands(field, scale["dt"] / 2, scale["dx"],
                                       -1), u)
    check("f32 operator sweep vs K1's solve", max_err(outs[torch.float32],
                                                       exact), KERNEL_TOL)
    check_rel(f"bf16 operator sweep ({gemm_route(torch.bfloat16, device)}) "
              "vs the float32 one", rel_err(outs[torch.bfloat16],
                                            outs[torch.float32]),
              AMP_OUT_TOL)
    # one sweep's apply by each GEMM route: the device's time in a CUDA
    # graph and a call's by CUDA events (host included)
    routes = {"f32": (torch.float32, contextlib.nullcontext),
              "bmm_out_dtype": (torch.bfloat16, contextlib.nullcontext),
              "bf16_rounded_f32": (torch.bfloat16, kernels.plain_versions)}
    build["sweep_apply"] = {}
    for B in (64, 1024):
        u = torch.rand((B, *field.shape), device=device)
        for route, (dtype, ctx) in routes.items():
            with ctx():
                if gemm_route(dtype, device) != route:
                    raise AssertionError(f"route {route}: "
                                         f"{gemm_route(dtype, device)}")
                ms = graph_ms(lambda: [lambda: apply_sweep(ops[dtype], u)],
                              walks=20)
                call = time_ms(lambda: apply_sweep(ops[dtype], u))
            build["sweep_apply"][f"{route}_B{B}"] = {"ms": ms,
                                                     "call_ms": call}
            log(f"[amp-kernels] one x-sweep apply (3, 32, 32) B={B} by "
                f"{route}: {ms:.4f} ms in a CUDA graph, {call:.4f} ms a "
                "call (CUDA events)")
    return build


def tridiag_inverse_operator_plain(a, b, c):
    with kernels.plain_versions():
        return tridiag_inverse_operator(a, b, c)


def phase_amp(device):
    """The AMP grade and SVHN: the flagship served at B in {1, 64, 1024}
    and trained at B = 64 (rates at 64 and 256); mnist served and trained
    at B = 128; SVHN per-sweep (K1, K3) served at B in {1, 256} and
    trained at B = 256 through ``serve_family`` and ``train_family``, and
    its hoisted grades the same way; the serve CLI with --amp and the
    train CLI with --amp --bf16-moments (svhn) on cuda."""
    out = {}
    rng = np.random.default_rng(SEED + 15)
    out["flagship_serve"] = timed(
        "flagship AMP serving", amp_serve, "amp-serve", device,
        lambda: flagship(device), (3, 32, 32), (1, 64, 1024), 6,
        {1: 30, 64: 20, 1024: 5}, SEED + 16)
    images, labels, _, _ = make_synthetic("cifar10")
    data = (torch.from_numpy(images).to(device),
            torch.from_numpy(labels).to(device))

    def cifar_inputs(B):
        return (torch.from_numpy(spiked_images(rng, B)).to(device),
                torch.from_numpy(rng.integers(0, 10, B)).to(device))

    def flagship_rate(rate):
        return flagship(device,
                        **({} if rate is None else {"dropout_rate": rate}))

    out["flagship_train"] = timed(
        "flagship AMP training", amp_train, "amp-train", flagship_rate,
        TRAIN, data, 64, (64, 256), cifar_inputs, 6,
        ZERO_IN_EXACT_ARITHMETIC, rng)

    out["mnist_serve"] = timed(
        "mnist AMP serving", amp_serve, "amp-mnist-serve", device,
        lambda: grayscale_model(device), (1, 28, 28), (128,), 2, {128: 20},
        SEED + 17)
    images, labels, _, _ = make_synthetic("mnist", train_per_class=64)
    data = (torch.from_numpy(images).to(device),
            torch.from_numpy(labels).to(device))

    def gray_inputs(B):
        return (torch.from_numpy(rng.random((B, 1, 28, 28)).astype(
                    np.float32)).to(device),
                torch.from_numpy(rng.integers(0, 10, B)).to(device))

    out["mnist_train"] = timed(
        "mnist AMP training", amp_train, "amp-mnist-train",
        lambda rate: grayscale_model(device, dropout_rate=rate), GRAY_TRAIN,
        data, 128, (128,), gray_inputs, 2, (), rng)

    out["svhn_serve"] = timed(
        "svhn serving", serve_family, "svhn-serve", device,
        lambda config: svhn_model(device), (3, 32, 32), (1, 256),
        {"per_sweep": {"K1": 30}}, {1: 30, 256: 20}, SEED + 18)
    images, labels, _, _ = make_synthetic("svhn", train_per_class=64)
    data = (torch.from_numpy(images).to(device),
            torch.from_numpy(labels).to(device))

    def svhn_inputs(B):
        return (torch.from_numpy(rng.random((B, 3, 32, 32)).astype(
                    np.float32)).to(device),
                torch.from_numpy(rng.integers(0, 10, B)).to(device))

    out["svhn_train"] = timed(
        "svhn training", train_family, "svhn-train",
        lambda config, rate: svhn_model(device, rate), SVHN_TRAIN, data,
        {"per_sweep": {"K1": 30, "K3": 30}}, 256, svhn_inputs, (256,),
        (256,), rng, SVHN_ZERO)
    out["svhn_amp_serve"] = timed(
        "svhn AMP serving", amp_serve, "svhn-amp-serve", device,
        lambda: svhn_model(device), (3, 32, 32), (1, 256), 2,
        {1: 30, 256: 20}, SEED + 19)
    out["svhn_amp_train"] = timed(
        "svhn AMP training", amp_train, "svhn-amp-train",
        lambda rate: svhn_model(device, rate), SVHN_TRAIN, data, 256,
        (256,), svhn_inputs, 2, SVHN_ZERO, rng)

    cli_later("amp", "cnn_pde_tpu_torch.serve", "svhn", "--amp",
              ok=lambda s: s["amp_cached_layers"] == 1
              and len(s["predictions"]) == 8)
    route = gemm_route(torch.bfloat16, device)
    cli_later("amp", "cnn_pde_tpu_torch.train", "svhn", "--synthetic",
              "--epochs", "1", "--steps", "5", "--batch-size", "16", "--amp",
              "--bf16-moments",
              ok=lambda s: s["amp_layers"] == 1 and s["gemm_route"] == route
              and s["device"].startswith(device.type)
              and np.isfinite(s["last_loss"]))
    return out


# ---- the explicit-stencil families: emotion and Tiny-ImageNet --------------

EMOTION_TRAIN = PRESETS["emotion"]["train"]
TINY_TRAIN = PRESETS["tiny_imagenet"]["train"]
# biases that feed a train-mode BatchNorm in the emotion head
EMOTION_ZERO = {f"classifier.{i}.bias" for i in (1, 5, 9)}
# the FTCS layer's six weights, one coefficient field's parameters: held
# as one vector (a weight whose gradient cancels to near 0 has no float32
# digits of its own to compare; each one's own error is logged)
FTCS_WEIGHTS = tuple(f"pde.{k}_w{i}" for k in ("alpha", "beta")
                     for i in (1, 2, 3))
# ResidualDiffusion's beta_base, which the explicit forward never reads
TINY_ZERO = {"diff.beta_base"}
# batches: emotion served at these and trained at the preset's 64;
# Tiny-ImageNet served at these, trained at the preset's 32 and at 128
EMOTION_SERVE = (1, 64, 1024)
EMOTION_BATCH = 64
TINY_SERVE = (1, 32, 256)
TINY_TRAIN_BATCHES = (32, 128)


def emotion_model(device, dropout_rate=None):
    """The emotion classifier with init from a seeded generator (the FTCS
    weights' init constants, CFL-unstable: values grow about 1e6x over the
    10 steps)."""
    model = build_model("emotion", device=device,
                        generator=torch.Generator().manual_seed(SEED),
                        **({} if dropout_rate is None
                           else {"dropout_rate": dropout_rate}))
    USED_DEVICES.add(next(model.parameters()).device)
    return model


def tiny_model(device, dropout_rate=None, **kwargs):
    """The Tiny-ImageNet classifier with init from a seeded generator, its
    front end's fields and every BatchNorm's affine parameters and
    statistics moved off their init by seeded draws."""
    model = build_model("tiny_imagenet", device=device,
                        generator=torch.Generator().manual_seed(SEED),
                        **kwargs, **({} if dropout_rate is None
                                     else {"dropout_rate": dropout_rate}))
    USED_DEVICES.add(next(model.parameters()).device)
    rng = np.random.default_rng(SEED + 21)

    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=device)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(t(1 + 0.1 * rng.standard_normal(n)))
                m.bias.copy_(t(0.1 * rng.standard_normal(n)))
                m.running_mean.copy_(t(0.1 * rng.standard_normal(n)))
                m.running_var.copy_(t(1 + 0.1 * np.abs(
                    rng.standard_normal(n))))
        if model.use_pde:
            model.diff.alpha_base.copy_(t([0.03, 0.08, 0.12]))
            model.diff.beta_base.copy_(t([0.04, 0.06, 0.09]))
            model.diff.channel_scaling.copy_(t(
                1 + 0.1 * rng.standard_normal(3)))
    return model


def float64_logits(model, x):
    """``model``'s eval logits in float64 on the plain versions (a copy)."""
    with kernels.plain_versions(), torch.inference_mode():
        return copy.deepcopy(model).double().eval()(x.double())


def grad_l2(got, ref):
    """‖got − ref‖ / ‖ref‖ over every gradient taken as one vector."""
    a = torch.cat([g.double().flatten() for g in got[1].values()])
    b = torch.cat([ref[1][n].double().flatten() for n in got[1]])
    return float((a - b).norm() / b.norm())


def against_float64(tag, label, make_model, xs, ys, smoothing, zero_names,
                    vectors=(), limit=GRAD_TOL):
    """One train-mode step of ``make_model(0.0)`` (dropout off) against the
    same step in float64 on the plain versions, the float32 run's ReLU and
    max-pool decisions replayed: (worst, where, loss and gradients)."""
    masks = {}
    got = train_grads(make_model(0.0), xs, ys, smoothing, masks)
    with kernels.plain_versions():
        ref = train_grads(make_model(0.0).double(), xs.double(), ys,
                          smoothing, masks)
    worst, where = compare_grads(
        f"[{tag}] {label} loss and every gradient vs the float64 step", got,
        ref, limit, zero_names, limit is not None, vectors)
    return worst, where, got, ref


def step_rates(tag, label, step, data, B, rng, reps=10):
    """images/s of a train ``step`` at B on a draw from ``data`` (CUDA
    events) and the device's busy share of a step."""
    device = data[0].device
    idx = torch.from_numpy(rng.integers(0, data[0].shape[0], B))
    xb, yb = data[0][idx.to(device)], data[1][idx.to(device)]
    ms = time_ms(lambda: step(xb, yb), groups=3, per_group=reps)
    log(f"[{tag}] {label} B={B}: {1e3 * B / ms:.1f} images/s ({ms:.3f} ms "
        f"a step, CUDA events, median of 3 groups of {reps} steps after "
        "warm-up)")
    busy = device_busy(lambda: step(xb, yb), BUSY_REPS, device)
    log_busy(tag, f"{label} B={B}", busy, "step")
    out = {f"B{B}": 1e3 * B / ms}
    if busy is not None:
        out.update({f"B{B}_busy": busy[0],
                    f"B{B}_device_us_per_step": busy[0] * busy[1],
                    f"B{B}_launch_calls_per_step": busy[4]})
    return out


def serve_rates(tag, label, predict, images, reps, device):
    """``request_rate`` at each B of ``images`` and the busy share at the
    largest B."""
    out = {f"B{B}": request_rate(tag, label, predict, x, reps[B])
           for B, x in images.items()}
    big = max(images)
    busy = device_busy(lambda: predict(images[big]), BUSY_REPS, device)
    log_busy(tag, f"{label} B={big}", busy, "request")
    if busy is not None:
        out[f"B{big}_busy"] = busy[0]
        out[f"B{big}_launch_calls_per_request"] = busy[4]
    return out


def train_falling(tag, label, make_model, values, data, batch, steps=50):
    """``steps`` ``make_train_step`` steps of ``make_model(None)`` at
    ``batch`` on ``data`` with a falling loss; returns the step (for the
    rates) and the first and last loss."""
    step = make_train_step(make_model(None), values,
                           max(data[0].shape[0] // batch, 1),
                           torch.Generator(data[0].device).manual_seed(SEED))
    run = train_steps(step, data, steps, batch, seed=SEED)
    log(f"[{tag}] {label}: {steps} steps at B={batch}, loss {run[0]:.4f} -> "
        f"{run[-1]:.4f} (means of the first and last 5: "
        f"{np.mean(run[:5]):.4f} -> {np.mean(run[-5:]):.4f})")
    if not (all(np.isfinite(run)) and np.mean(run[-5:]) < np.mean(run[:5])):
        raise AssertionError(f"{tag} {label}: loss did not fall: {run}")
    return step, (run[0], run[-1])


def phase_emotion(device):
    """Emotion at full width (48 x 48): served at B in {1, 64, 1024} with
    logits within 1e-4 of their largest entry against the same model in
    float64 and no kernel launched; trained at B = 64 with the loss and
    every gradient within 1e-4 of its largest entry against the float64
    step (the six FTCS weights as one vector, each one's own error
    logged); 50 steps on synthetic data with a falling loss; images/s and
    the busy share; both CLIs on cuda."""
    tag, out = "emotion", {}
    rng = np.random.default_rng(SEED + 22)
    model = emotion_model(device)
    predict = make_eager_predict_fn(model)
    images = {B: torch.from_numpy(rng.random((B, 1, 48, 48)).astype(
        np.float32)).to(device) for B in EMOTION_SERVE}
    reset_counts()
    logits = {B: predict(x) for B, x in images.items()}
    sync(device)
    if counts() != only():
        raise AssertionError(f"emotion launched a kernel: {counts()}")
    for B, x in images.items():
        if logits[B].shape != (B, 7) or not torch.isfinite(logits[B]).all():
            raise AssertionError(f"emotion B={B}: bad logits")
        check_rel(f"[{tag}] B={B} logits vs float64 (largest "
                  f"{logits[B].abs().max().item():.4g})",
                  rel_err(logits[B], float64_logits(model, x)), LOGIT_TOL)
    out["serve"] = serve_rates(tag, "serve", predict, images,
                               dict(zip(EMOTION_SERVE, (30, 20, 5))), device)

    images, labels, _, _ = make_synthetic("emotion", train_per_class=64)
    data = (torch.from_numpy(images).to(device),
            torch.from_numpy(labels).to(device))
    idx = torch.from_numpy(rng.permutation(images.shape[0])[:EMOTION_BATCH])
    worst, where, got, ref = against_float64(
        tag, f"B={EMOTION_BATCH}", lambda rate: emotion_model(device, rate),
        data[0][idx.to(device)], data[1][idx.to(device)], EMOTION_TRAIN["label_smoothing"], EMOTION_ZERO,
        (FTCS_WEIGHTS,))
    log(f"  each FTCS weight's own gradient error vs float64: " + "; ".join(
        f"{n[4:]} {rel_err(got[1][n], ref[1][n]):.3e} (of its "
        f"{ref[1][n].item():.4g})" for n in FTCS_WEIGHTS))
    out["grad_vs_float64"] = worst
    step, out["loss_50_steps"] = train_falling(
        tag, "train", lambda rate: emotion_model(device, rate),
        EMOTION_TRAIN, data, EMOTION_BATCH)
    out["train"] = step_rates(tag, "train", step, data, EMOTION_BATCH, rng)
    cli_later(tag, "cnn_pde_tpu_torch.serve", "emotion",
              ok=lambda s: len(s["predictions"]) == 8
              and not s["amp_cached_layers"])
    check_train_cli(tag, "emotion")
    return out


@contextlib.contextmanager
def tf32_guard_bypassed():
    """The control for the exact grade: the port's convolutions without
    their TF32 guard (``layers.no_tf32`` a no-op), under cuDNN's TF32 flag
    as the process has it (torch's default, on, in this phase)."""
    guard = layers_module.no_tf32
    layers_module.no_tf32 = contextlib.nullcontext
    try:
        yield
    finally:
        layers_module.no_tf32 = guard


def bf16_steps(x, y):
    """max |x − y| in bf16 steps of the largest entry: units in the last
    place of bf16 (8 significant bits) at the larger of the two largest
    magnitudes."""
    m = torch.maximum(x.abs().max(), y.abs().max()).float()
    ulp = torch.ldexp(torch.ones_like(m), torch.frexp(m)[1] - 8)
    return float((x.float() - y.float()).abs().max() / ulp)


def record_io(model, names, store):
    """Forward hooks that keep, for each module of ``names`` in ``model``,
    its input, its output and, once the backward has run, its output's
    cotangent in ``store[name]``; returns the handles."""
    modules = dict(model.named_modules())

    def hook(name):
        def keep(mod, inp, out):
            store[name] = [inp[0].detach(), out.detach(), None]
            if out.requires_grad:
                out.register_hook(
                    lambda g: store[name].__setitem__(2, g.detach()))
        return keep
    return [modules[n].register_forward_hook(hook(n)) for n in names]


def replay(module, x, g):
    """``module`` run on ``x`` and given the output cotangent ``g``: its
    output, the input's gradient and each parameter's gradient."""
    module.zero_grad(set_to_none=True)
    xs = x.clone().requires_grad_()
    y = module(xs)
    y.backward(g)
    return y.detach(), xs.grad, {
        n: torch.zeros_like(p) if p.grad is None else p.grad
        for n, p in module.named_parameters()}


def replay_against_plain(tag, label, module, x, g, out_tol):
    """``replay`` of ``module`` on its card route against its plain versions
    on the same input and cotangent: the output within ``out_tol`` of its
    largest entry (None, for a bf16 convolution: on the bf16 grid and
    within one bf16 step of it, 2^-8 to 2^-7 by where it lies in its
    binade), the input's and
    every parameter's gradient within AMP_GRAD_TOL of its largest entry.
    Returns the worst (output, gradient) readings relative to the largest
    entry."""
    got = replay(module, x, g)
    with kernels.plain_versions():
        plain = replay(module, x, g)
    if out_tol is None and not torch.equal(
            got[0], got[0].to(torch.bfloat16).float()):
        raise AssertionError(f"{label}: output off the bf16 grid")
    out_err, steps = rel_err(got[0], plain[0]), bf16_steps(got[0], plain[0])
    if not (steps <= 1.0 if out_tol is None else out_err <= out_tol):
        raise AssertionError(f"{label} output: {out_err} of the largest "
                             f"entry, {steps} bf16 steps")
    grads = {"input": (got[1], plain[1])}
    grads.update({n: (a, plain[2][n]) for n, a in got[2].items()})
    errs = {n: (rel_err(a, b), bf16_steps(a, b)) for n, (a, b) in
            grads.items()}
    log(f"  [{tag}] {label} vs its plain versions, of the largest entry "
        f"(bf16 steps of it): output {out_err:.3e} ({steps:g}); " + "; ".join(
            f"{n} gradient {e:.3e} ({st:g})" for n, (e, st) in errs.items()))
    for n, (e, _) in errs.items():
        if not e <= AMP_GRAD_TOL:
            raise AssertionError(f"{label} {n} gradient: {e} > "
                                 f"{AMP_GRAD_TOL}")
    return out_err, max(e for e, _ in errs.values())


def amp_against_plain(tag, label, make_amp, make_exact, images, batch,
                      smoothing, replayed, out_tol, zero_names):
    """The AMP model ``make_amp(rate)`` against its plain versions: the
    train-mode loss at ``batch`` within AMP_OUT_TOL; each module of
    ``replayed``, run again on the input and output cotangent that the
    plain step gave it, held by ``replay_against_plain``; the grade
    measurably away from the exact grade ``make_exact(rate)`` (logits and
    gradients over 1e-3); ``zero_names`` as for ``compare_grads``.

    The model's eval logits (at each B of ``images``) and its gradients
    are logged against AMP_OUT_TOL and AMP_GRAD_TOL, not held: the two
    pipelines round a float32 value near a bf16 midpoint apart now and
    then, later convolutions carry that step, and the logits then read
    about one bf16 step (2^-8) of their largest entry apart, on either
    side of 4e-3 by the draw (3.1e-3 to 4.1e-3 on an H100); the gradients,
    which train-mode BatchNorm cancels down to the bf16 cotangents'
    rounding, further.  Each convolution, replayed, is what is held."""
    out = {}
    predict = make_eager_predict_fn(make_amp(None))
    exact_predict = make_eager_predict_fn(make_exact(None))
    for B, x in images.items():
        got = predict(x)
        if got.shape != (B, 200) or not torch.isfinite(got).all():
            raise AssertionError(f"{label} B={B}: bad logits")
        with kernels.plain_versions():
            plain = predict(x)
        err = out[f"logits_B{B}"] = rel_err(got, plain)
        log(f"  [{tag}] {label} B={B} logits vs its plain versions: "
            f"{err:.3e} of the largest entry, "
            f"{'within' if err <= AMP_OUT_TOL else 'OVER'} the issue's "
            f"{AMP_OUT_TOL:.0e} (logged, not held)")
        away = rel_err(got, exact_predict(x))
        log(f"  {label} B={B} logits vs the exact grade: {away:.3e} of the "
            "largest entry")
        if not away > 1e-3:
            raise AssertionError(f"{label}: logits at the exact grade's")
    xb, yb = batch
    masks, io = {}, {}
    got = train_grads(make_amp(0.0), xb, yb, smoothing, masks)
    plain_model = make_amp(0.0)
    hooks = record_io(plain_model, replayed, io)
    try:
        with kernels.plain_versions():
            plain = train_grads(plain_model, xb, yb, smoothing, masks)
    finally:
        for h in hooks:
            h.remove()
    exact = train_grads(make_exact(0.0), xb, yb, smoothing, masks)
    out["loss"] = check_rel(
        f"[{tag}] {label} B={xb.shape[0]} train-mode loss vs its plain "
        "versions", rel_err(got[0], plain[0]), AMP_OUT_TOL)
    worst, where = compare_grads(
        f"{label} B={xb.shape[0]} every gradient of the model vs its plain "
        f"versions (logged, not held; the issue's {AMP_GRAD_TOL:.0e})", got,
        plain, None, zero_names, False)
    out.update({"grad_l2_vs_plain": grad_l2(got, plain),
                "worst_grad_vs_plain": worst,
                "grad_l2_plain_vs_exact": grad_l2(plain, exact),
                "grad_l2_vs_exact": grad_l2(got, exact)})
    log(f"  {label} B={xb.shape[0]} gradients (L2 over all): vs its plain "
        f"versions {out['grad_l2_vs_plain']:.3e}; vs the exact grade "
        f"{out['grad_l2_vs_exact']:.3e}; the plain versions vs the exact "
        f"grade {out['grad_l2_plain_vs_exact']:.3e}")
    if not out["grad_l2_vs_exact"] > 1e-3:
        raise AssertionError(f"{label}: gradients at the exact grade's")
    modules = dict(plain_model.named_modules())
    worst = (0.0, 0.0)
    for name in replayed:
        x, _, g = io[name]
        errs = replay_against_plain(tag, f"{label} {name}", modules[name],
                                    x, g, out_tol)
        worst = tuple(map(max, worst, errs))
    out["replay_worst_output"], out["replay_worst_grad"] = worst
    return out


def phase_tiny(device):
    """Tiny-ImageNet at full width (64 x 64, ResNet-18, 200 classes), with
    cuDNN's TF32 flag at torch's default (on), so that the port's own guard
    is what keeps the exact grade off TF32: the exact grade served at B in
    {1, 32, 256} (logits within 1e-4 of float64) and its train step at
    B = 32 and 128 (loss and every gradient within 1e-4 of its largest
    entry against the float64 step, the ReLU and max-pool decisions
    replayed); the control, the same with the guard bypassed, which must
    miss a limit; 50 steps with a falling loss, images/s and the busy
    share; ``pde_implicit=True`` (2 K1 a forward, 2 K1 + 2 K3 a step,
    against the plain versions); the AMP grade against its plain
    versions (``amp_against_plain``: logits and loss within 4e-3, each of
    the 20 convolutions replayed on the plain step's input and cotangent,
    its output within one bf16 step and its gradients within 6e-3 of the
    largest entry; away from the exact grade), and with ``pde_implicit``
    (2 K1 a forward and a step, no K3; the front end replayed, 4e-3 and
    6e-3); both CLIs."""
    tag, out = "tiny", {}
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        return _phase_tiny(tag, out, device)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _phase_tiny(tag, out, device):
    log(f"[{tag}] cuDNN TF32 flag {torch.backends.cudnn.allow_tf32} (torch's "
        "default) for this phase")
    rng = np.random.default_rng(SEED + 23)
    model = tiny_model(device)
    predict = make_eager_predict_fn(model)
    images = {B: torch.from_numpy(rng.random((B, 3, 64, 64)).astype(
        np.float32)).to(device) for B in TINY_SERVE}
    reps = dict(zip(TINY_SERVE, (30, 20, 5)))
    reset_counts()
    logits = {B: predict(x) for B, x in images.items()}
    sync(device)
    if counts() != only():
        raise AssertionError(f"tiny exact grade launched a kernel: "
                             f"{counts()}")
    ref = {B: float64_logits(model, x) for B, x in images.items()}
    for B in images:
        if logits[B].shape != (B, 200) or not torch.isfinite(
                logits[B]).all():
            raise AssertionError(f"tiny B={B}: bad logits")
        check(f"[{tag}] exact B={B} logits vs float64",
              max_err(logits[B], ref[B]), LOGIT_TOL)
    with tf32_guard_bypassed():
        control = {B: predict(x) for B, x in images.items()}
    control_logits = max(max_err(control[B], ref[B]) for B in images)
    log(f"  control (TF32 guard bypassed, TF32 on): logits vs float64 "
        f"{control_logits:.3e} (limit {LOGIT_TOL:.0e})")
    out["serve"] = serve_rates(tag, "exact serve", predict, images, reps,
                               device)

    images, labels, _, _ = make_synthetic("tiny_imagenet")
    data = (torch.from_numpy(images).to(device),
            torch.from_numpy(labels).to(device))
    smoothing = TINY_TRAIN["label_smoothing"]

    def make(rate, **kw):
        return tiny_model(device, rate, **kw)

    def batch(B):
        idx = torch.from_numpy(rng.integers(0, images.shape[0], B))
        return data[0][idx.to(device)], data[1][idx.to(device)]

    readings = {}
    small, big = TINY_TRAIN_BATCHES
    for B in TINY_TRAIN_BATCHES:
        xs, ys = batch(B)
        readings[B] = against_float64(tag, f"exact B={B}", make, xs, ys,
                                      smoothing, TINY_ZERO)[0]
        if B == small:
            with tf32_guard_bypassed():
                worst = against_float64(
                    tag, f"control (TF32 guard bypassed, TF32 on; limit "
                    f"{GRAD_TOL:.0e}) B={B}", make, xs, ys, smoothing,
                    TINY_ZERO, limit=None)[0]
            out["tf32_control"] = {"logits": control_logits, "grads": worst}
            if control_logits <= LOGIT_TOL and worst <= GRAD_TOL:
                raise AssertionError("the TF32 control passed every limit: "
                                     "the checks cannot see TF32")
    out["grad_vs_float64"] = readings
    step, out["loss_50_steps"] = train_falling(
        tag, "exact train", make, TINY_TRAIN, data, small)
    out["train"] = step_rates(tag, "exact train", step, data, small, rng)
    out["train"].update(step_rates(tag, "exact train", step, data, big,
                                   rng))

    # pde_implicit: K1 a sweep forward, K3 a sweep backward
    out["implicit_serve"] = serve_family(
        f"{tag}-implicit", device,
        lambda config: make(None, pde_implicit=True), (3, 64, 64),
        TINY_SERVE, {"implicit": {"K1": 2}}, reps, SEED + 24, classes=200)
    out["implicit_train"] = train_family(
        f"{tag}-implicit", lambda config, rate: make(rate, pde_implicit=True),
        TINY_TRAIN, data, {"implicit": {"K1": 2, "K3": 2}}, small, batch,
        (small,), (small,), rng)

    # the AMP grade: bf16 convolutions, checked against its plain versions
    # and conv by conv
    xs = {B: torch.from_numpy(rng.random((B, 3, 64, 64)).astype(
        np.float32)).to(device) for B in TINY_SERVE[1:]}
    convs = [n for n, m in make(None).named_modules()
             if isinstance(m, layers_module.Conv2d)]
    out["amp"] = amp_against_plain(
        tag, "AMP", lambda rate: enable_amp_checked(make(rate)), make, xs,
        batch(small), smoothing, convs, None, TINY_ZERO)
    step, out["amp"]["loss_50_steps"] = train_falling(
        f"{tag}-amp", "train", lambda rate: enable_amp_checked(make(rate)),
        TINY_TRAIN, data, small)
    out["amp"]["train"] = step_rates(f"{tag}-amp", "train", step, data,
                                     small, rng)
    out["amp"]["serve"] = serve_rates(
        f"{tag}-amp", "serve", make_eager_predict_fn(enable_amp_checked(
            make(None))), xs, {B: reps[B] for B in xs}, device)
    # AMP with pde_implicit: the front end's sweeps on bf16 operators built
    # at the call, one K1 each, no K3; against its plain versions, the
    # front end replayed
    implicit = enable_amp_checked(make(None, pde_implicit=True))
    step = make_train_step(implicit, TINY_TRAIN, data[0].shape[0] // small,
                           torch.Generator(device).manual_seed(SEED))
    xb, yb = batch(small)
    step(xb, yb)
    reset_counts()
    make_eager_predict_fn(implicit)(xb)
    sync(device)
    forward = counts()
    reset_counts()
    step(xb, yb)
    sync(device)
    train = counts()
    log(f"[{tag}] AMP pde_implicit: launches a forward {forward}, a train "
        f"step {train}")
    if forward != only(K1=2) or train != only(K1=2):
        raise AssertionError("AMP pde_implicit: expected 2 K1 a forward "
                             "and a step, no K3")
    out["amp_implicit"] = amp_against_plain(
        tag, "AMP pde_implicit", lambda rate: enable_amp_checked(
            make(rate, pde_implicit=True)),
        lambda rate: make(rate, pde_implicit=True),
        {small: xs[small]}, (xb, yb), smoothing, ["diff"], AMP_OUT_TOL, ())

    cli_later(tag, "cnn_pde_tpu_torch.serve", "tiny_imagenet", "--amp",
              ok=lambda s: s["amp_cached_layers"] == 0
              and len(s["predictions"]) == 8)
    cli_later(tag, "cnn_pde_tpu_torch.train", "tiny_imagenet", "--synthetic",
              "--epochs", "1", "--steps", "20",
              ok=lambda s: s["steps"] == 20 and s["device"].startswith("cuda")
              and np.isfinite(s["last_loss"]))
    return out


def enable_amp_checked(model):
    """``enable_amp`` on a model with no ADI layer (0): every port Conv2d
    in bf16, the front end's solves on the bf16 operator route and the
    global solver default left alone."""
    if enable_amp(model) != 0 or tridiag_module._DEFAULT_IMPL != "auto":
        raise AssertionError("enable_amp on tiny_imagenet")
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    if len(convs) != 20 or any(m.compute_dtype != torch.bfloat16
                               for m in convs):
        raise AssertionError("enable_amp left a convolution out of bf16")
    if model.use_pde and model.diff.solve_impl != "matinv_bf16":
        raise AssertionError("enable_amp left the front end's solves")
    return model


def phase_stencil(device):
    """The explicit-stencil families: emotion, then Tiny-ImageNet."""
    return {"emotion": timed("emotion", phase_emotion, device),
            "tiny_imagenet": timed("tiny_imagenet", phase_tiny, device)}


# ---- the CIFAR-10 hybrid (A11) and the Trainer ------------------------------

HYBRID_TRAIN = PRESETS["cifar10_hybrid"]["train"]
HYBRID_ALPHAS = HYBRID_TRAIN["regularizer"]
HYBRID_SERVE = (1, 64, 1024)
HYBRID_TRAIN_BATCHES = (64, 256)
HYBRID_GRADES = {"exact": torch.float32, "bf16": torch.bfloat16}
# a forward: 16 + 10 Lie sweeps of the two diffusion layers, one K1 each;
# the hoisted (AMP) grade builds each layer's two operator stacks, 4 K1
HYBRID_SWEEPS = 26
HYBRID_BUILDS = 4
# biases that feed a train-mode BatchNorm, and the feature BN's bias,
# summed to zero over the batch through the BN1d head
HYBRID_ZERO = {f"classifier.classifier.{i}.bias"
               for i in (0, 4, 8, 12)} | {"feature_bn.bias"}
# one K product, exact grade, against float64: a float32 sum of 3,072
# terms is within a few 1e-7 of its largest term; TF32's 10-bit mantissa
# is about 1e-3
KPROD_TOL = 1e-5
# the bf16 grade's sound runs beside the card's: the plain versions with
# each K product's float32 sum cut into this many pieces
HYBRID_SOUND_PARTS = (2, 4, 8)
# the bf16 grades' loss and model gradients against their plain versions,
# of each one's largest entry: the sound runs read 0.89-2.05e-02 and the
# card 1.05-2.42e-02 (B = 64 and 256, bf16 and AMP), the control whose
# products return bf16 4.03-8.54e-02
HYBRID_BF16_GRAD_TOL = 3e-2
PEAK_BF16 = 989e12   # dense bf16 FLOP/s of an H100 SXM (data sheet)


# a hybrid of each (device, grade, dropout rate), built once in the phase
# (drawing its three 3072 x 3072 K on the host takes about a second) and
# copied for each caller
HYBRID_MODELS = {}


def hybrid_model(device, grade="bf16", dropout_rate=None):
    """The hybrid from a seeded generator in ``grade`` ('exact': float32
    K products, 'bf16': the model's default, 'amp': bf16 and
    ``enable_amp``), its diffusion fields replaced by seeded trained-looking
    ones and every BatchNorm's affine parameters and statistics moved off
    their init by seeded draws: a copy of HYBRID_MODELS' one."""
    key = (str(device), grade, dropout_rate)
    if key not in HYBRID_MODELS:
        HYBRID_MODELS[key] = _hybrid_model(device, grade, dropout_rate)
    return copy.deepcopy(HYBRID_MODELS[key])


def _hybrid_model(device, grade, dropout_rate):
    model = build_model("cifar10_hybrid", device=device,
                        generator=torch.Generator().manual_seed(SEED),
                        ruthotto_dtype=HYBRID_GRADES.get(grade,
                                                         torch.bfloat16),
                        **({} if dropout_rate is None
                           else {"dropout_rate": dropout_rate}))
    USED_DEVICES.add(next(model.parameters()).device)
    rng = np.random.default_rng(SEED + 31)

    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=device)
    with torch.no_grad():
        for i in (1, 2):
            layer = getattr(model.feature_extractor, f"diffusion{i}")
            for key, value in fields(rng, device).items():
                getattr(layer, key).copy_(value)
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                n = m.num_features
                m.weight.copy_(t(1 + 0.1 * rng.standard_normal(n)))
                m.bias.copy_(t(0.1 * rng.standard_normal(n)))
                m.running_mean.copy_(t(0.1 * rng.standard_normal(n)))
                m.running_var.copy_(t(1 + 0.1 * np.abs(
                    rng.standard_normal(n))))
    if grade == "amp":
        if enable_amp(model) != 2:
            raise AssertionError("enable_amp on the hybrid: 2 ADI layers")
    return model


@contextlib.contextmanager
def bf16_product_outputs():
    """The control for the bf16 grade's checks: every bf16 K product
    returns bf16 (``bmm`` on bf16 operands without ``out_dtype``), a
    worse grade than the JAX one, which the checks must refuse."""
    gemm = ruthotto_module._gemm_bf16
    ruthotto_module._gemm_bf16 = lambda a, b: torch.bmm(
        a[None], b[None])[0].float()
    try:
        yield
    finally:
        ruthotto_module._gemm_bf16 = gemm


def k_product_calls(x, k, g, transpose=False):
    """One K product forward (out = x·kᵀ), and its forward and backward
    (the gradients of x and k for the output cotangent ``g``), as
    calls."""
    def fwd():
        return ruthotto_module._KProduct.apply(x, k, transpose)

    def bwd():
        xs = x.detach().requires_grad_()
        ks = k.detach().requires_grad_()
        out = ruthotto_module._KProduct.apply(xs, ks, transpose)
        return torch.autograd.grad(out, (xs, ks), g)
    return fwd, bwd


def phase_hybrid_products(device, peak_bytes, peak_flops):
    """The hybrid's K products alone at B = 64 (x (64, 3072), K = I +
    0.01·N(0, 1)), with both TF32 flags on: the exact grade's forward and
    backward within KPROD_TOL of float64 and a control with the guard
    bypassed that must miss it; the bf16 grade's against its plain
    version (float32 output within KPROD_TOL, the bf16 gradients within
    one bf16 step) and a control whose products return bf16 that must
    miss; then the device time in a CUDA graph of one product forward,
    and of its forward and backward, beside the bound (FLOPs at the
    grade's peak, or bytes at the memory rate) and the plain version."""
    tag, out = "hybrid-products", {}
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        log(f"[{tag}] TF32 on for matmuls and cuDNN in this phase")
        gen = torch.Generator().manual_seed(SEED + 32)
        D, B = 3072, 64
        x = torch.randn(B, D, generator=gen).to(device)
        k = (torch.eye(D) + 0.01 * torch.randn(D, D, generator=gen)).to(
            device)
        g = torch.randn(B, D, generator=gen).to(device)
        ref_out = (x.double() @ k.double().t())
        ref_gx = g.double() @ k.double()
        ref_gk = g.double().t() @ x.double()

        def exact_errs():
            fwd, bwd = k_product_calls(x, k, g)
            gx, gk = bwd()
            return (rel_err(fwd(), ref_out), rel_err(gx, ref_gx),
                    rel_err(gk, ref_gk))

        errs = exact_errs()
        for label, err in zip(("output", "x gradient", "K gradient"), errs):
            check_rel(f"[{tag}] exact K product {label} vs float64 (TF32 "
                      "flags on)", err, KPROD_TOL)
        with tf32_guard_bypassed():
            control = exact_errs()
        log(f"  control (the guard bypassed, TF32 on): "
            + "; ".join(f"{e:.3e}" for e in control)
            + f" (limit {KPROD_TOL:.0e})")
        if max(control) <= KPROD_TOL:
            raise AssertionError("the TF32 control passed: the check "
                                 "cannot see TF32")
        out["exact_vs_float64"] = max(errs)
        out["tf32_control"] = max(control)

        kb = k.to(torch.bfloat16)

        def bf16_run():
            fwd, bwd = k_product_calls(x, kb, g)
            return (fwd(), *bwd())

        got = bf16_run()
        with kernels.plain_versions():
            plain = bf16_run()
        readings = (rel_err(got[0], plain[0]), bf16_steps(got[1], plain[1]),
                    bf16_steps(got[2], plain[2]))
        check_rel(f"[{tag}] bf16 K product output vs its plain version",
                  readings[0], KPROD_TOL)
        for label, steps in zip(("x gradient", "K gradient"), readings[1:]):
            log(f"  bf16 K product {label} vs its plain version: {steps:g} "
                "bf16 steps of its largest entry (limit 1)")
            if not steps <= 1.0:
                raise AssertionError(f"bf16 K product {label}: {steps}")
        with bf16_product_outputs():
            control = rel_err(bf16_run()[0], plain[0])
        log(f"  control (products returning bf16): output {control:.3e} "
            f"(limit {KPROD_TOL:.0e})")
        if control <= KPROD_TOL:
            raise AssertionError("the bf16-output control passed")
        out["bf16_vs_plain"] = readings[0]
        out["bf16_output_control"] = control

        flops = 2 * B * D * D
        for grade, kk, peak in (("exact", k, peak_flops),
                                ("bf16", kb, PEAK_BF16)):
            fwd, fwd_bwd = k_product_calls(x, kk, g)
            item = 4 if kk.dtype == torch.float32 else 2
            # the forward reads x and K and writes the output; forward and
            # backward read x, K and g and write the output and the two
            # gradients (K's at K's dtype): 1 and 3 products of 2·B·D²
            by_fwd = 4 * B * D + item * D * D + 4 * B * D
            by_both = 3 * 4 * B * D + 2 * item * D * D + 4 * B * D
            row = {}
            for part, call, nbytes, nflops in (
                    ("fwd", fwd, by_fwd, flops),
                    ("fwd_bwd", fwd_bwd, by_both, 3 * flops)):
                ms = graph_ms(lambda call=call: [call], walks=20)
                bound_ms, by = bound(nbytes, nflops, peak_bytes, peak)
                with kernels.plain_versions():
                    plain_ms = graph_ms(lambda call=call: [call], walks=20)
                row[part] = {"ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound_ms, "bound_by": by}
                log(f"[{tag}] {grade} K product {part} at B={B}: {ms:.4f} "
                    f"ms (CUDA graph), plain version {plain_ms:.4f} ms, "
                    f"bound {bound_ms:.4f} ms ({by}; {nflops / 1e9:.2f} "
                    f"GFLOP, {nbytes / 1e6:.1f} MB)")
            out[grade] = row
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def hybrid_serve(tag, device, rng):
    """The eager predict of the hybrid in the exact grade, the bf16
    grade and the AMP grade (operators cached), one request at each B of
    HYBRID_SERVE: launch counts (26 K1 a forward, or 4 K1 for the cache
    and none a request), logits against the plain versions (exact: 1e-4
    of the largest entry, and against float64; bf16 and AMP: 4e-3), the
    bf16-output control's reading, then images/s and the busy share."""
    images = {B: torch.from_numpy(rng.random((B, 3, 32, 32)).astype(
        np.float32)).to(device) for B in HYBRID_SERVE}
    reps = dict(zip(HYBRID_SERVE, (30, 20, 5)))
    out = {}
    for grade in ("exact", "bf16", "amp"):
        model = hybrid_model(device, grade)
        reset_counts()
        cached = cache_hoisted_operators(model) if grade == "amp" else 0
        sync(device)
        cache = counts()
        predict = make_eager_predict_fn(model)
        reset_counts()
        logits = {B: predict(x) for B, x in images.items()}
        sync(device)
        got = counts()
        log(f"[{tag}] {grade}: cache launches {cache}, request launches "
            f"{got} over {len(images)} forwards")
        per = 0 if grade == "amp" else HYBRID_SWEEPS
        if got != only(K1=per * len(images)) or cache != only(
                K1=HYBRID_BUILDS if grade == "amp" else 0) or (
                cached != (2 if grade == "amp" else 0)):
            raise AssertionError(f"hybrid {grade}: launches")
        with kernels.plain_versions():
            plain = {B: predict(x) for B, x in images.items()}
        tol = LOGIT_TOL if grade == "exact" else AMP_OUT_TOL
        readings = {}
        for B, x in images.items():
            if logits[B].shape != (B, 10) or not torch.isfinite(
                    logits[B]).all():
                raise AssertionError(f"hybrid {grade} B={B}: bad logits")
            readings[B] = check_rel(
                f"[{tag}] {grade} B={B} logits vs its plain versions",
                rel_err(logits[B], plain[B]), tol)
            if grade == "exact":
                check_rel(f"[{tag}] exact B={B} logits vs float64",
                          rel_err(logits[B], float64_logits(model, x)), tol)
        if grade == "bf16":
            with bf16_product_outputs():
                control = max(rel_err(predict(x), plain[B])
                              for B, x in images.items())
            log(f"  control (products returning bf16): logits "
                f"{control:.3e} (limit {AMP_OUT_TOL:.0e})")
            out["bf16_output_control_logits"] = control
        out[grade] = {"launches_per_forward": got["K1"] // len(images),
                      "cache_launches": cache["K1"],
                      "logits_vs_plain": max(readings.values())}
        out[grade].update(serve_rates(tag, f"{grade} serve", predict, images,
                                      reps, device))
        clear_operator_cache(model)
    return out


def hybrid_grads(make, xs, ys, masks, plain=False, double=False,
                 calls=None):
    """``train_grads`` of ``make(0.0)`` (dropout off) with the preset's
    smoothing and regulariser, on the plain versions or in float64;
    ``calls``: a dict that takes each SymmetricLayer call's module, input
    and output cotangent, by '<module name>#<call>'."""
    model = make(0.0)
    if double:
        model, xs = model.double(), xs.double()
    hooks = []
    if calls is not None:
        for name, m in model.named_modules():
            if isinstance(m, SymmetricLayer):
                hooks.append(m.register_forward_hook(
                    _keep_call(calls, name)))
    try:
        with (kernels.plain_versions() if plain or double
              else contextlib.nullcontext()):
            return train_grads(model, xs, ys,
                               HYBRID_TRAIN["label_smoothing"], masks,
                               HYBRID_ALPHAS)
    finally:
        for h in hooks:
            h.remove()


def _keep_call(calls, name):
    def keep(mod, inp, out):
        key = f"{name}#{sum(k.startswith(name + '#') for k in calls) + 1}"
        calls[key] = [mod, inp[0].detach(), None]
        out.register_hook(lambda g: calls[key].__setitem__(2, g.detach()))
    return keep


def replay_masked(mod, x, g, mask, flips=None):
    """``replay`` of a SymmetricLayer with its activation's decisions
    recorded into ``mask`` (an empty list) or replayed from it; a replay
    appends to ``flips`` the decisions its own pre-activation takes the
    other way, as (their number, the largest |pre-activation| among them
    over its largest entry)."""
    record = not mask

    def hook(m, inp, out):
        if record:
            mask.append((out > 0).to(out.dtype))
            return None
        pre = inp[0].detach()
        other = (pre > 0) != (mask[0] > 0)
        flips.append((int(other.sum()), float(
            pre.abs()[other].max() / pre.abs().max()) if other.any()
            else 0.0))
        return inp[0] * mask[0]
    h = mod.act.register_forward_hook(hook)
    try:
        return replay(mod, x, g)
    finally:
        h.remove()


def replay_calls(tag, label, calls):
    """Each SymmetricLayer call of a bf16 train step, replayed on the input
    and output cotangent the plain step gave it, on the card's route and
    on the plain versions (the card run's ReLU decisions replayed): its
    output within one bf16 step element by element and AMP_LAYER_RMS_TOL
    in the RMS (a route that rounds its products' outputs to bf16 moves
    every element, about 2^-9/sqrt(3) in the RMS); the gradients of its
    input and of K, bf16-rounded values in the JAX semantics, within one
    and two bf16 steps of their largest entry (K's a call is a bf16 sum of
    the two products' rounded terms); the norm's within AMP_GRAD_TOL.  A
    call whose output the loss does not read (the Hamiltonian block's
    last F_Z: its Z is not returned) has no cotangent and is not
    replayed.  Where the plain route's pre-activation would take a ReLU
    decision the other way (a value within rounding of 0), the number of
    such decisions is logged, with the input gradient's reading had the
    plain route kept its own decisions: a flipped decision moves a whole
    entry of the cotangent.  Returns the worst (output steps, RMS, input
    steps, K steps, norm gradient) and the flipped decisions' count."""
    worst, flipped = [0.0] * 5, 0
    for key, (mod, x, g) in calls.items():
        if g is None:
            log(f"  [{tag}] {label} {key}: its output does not reach the "
                "loss; not replayed")
            continue
        mask, flips = [], []
        got = replay_masked(mod, x, g, mask)
        with kernels.plain_versions():
            plain = replay_masked(mod, x, g, mask, flips)
        rms = float((got[0].double() - plain[0].double()).norm()
                    / plain[0].double().norm())
        norm = max(rel_err(got[2][n], plain[2][n])
                   for n in ("norm.weight", "norm.bias"))
        reading = (bf16_steps(got[0], plain[0]), rms,
                   bf16_steps(got[1], plain[1]),
                   bf16_steps(got[2]["K.weight"], plain[2]["K.weight"]), norm)
        log(f"  [{tag}] {label} {key} replayed vs its plain versions: "
            f"output {reading[0]:g} bf16 steps, {rms:.3e} in the RMS; "
            f"gradients: input {reading[2]:g} and K {reading[3]:g} bf16 "
            f"steps ({rel_err(got[1], plain[1]):.3e} and "
            f"{rel_err(got[2]['K.weight'], plain[2]['K.weight']):.3e} of "
            f"the largest entry), norm {norm:.3e}")
        n, size = flips[0]
        if n:
            with kernels.plain_versions():
                own = replay(mod, x, g)
            own_norm = max(rel_err(got[2][k], own[2][k])
                           for k in ("norm.weight", "norm.bias"))
            log(f"    ReLU decisions the plain route takes the other way: "
                f"{n} (largest |pre-activation| among them {size:.3e} of "
                f"its largest); with the plain route's own decisions the "
                f"input gradient reads {bf16_steps(got[1], own[1]):g} bf16 "
                f"steps ({rel_err(got[1], own[1]):.3e}), the norm's "
                f"{own_norm:.3e}")
            flipped += n
        worst = [max(w, r) for w, r in zip(worst, reading)]
    return worst, flipped


def replay_held(worst):
    """Whether ``replay_calls``' worst readings are within their limits."""
    steps, rms, gx, gk, norm = worst
    return (steps <= 1.0 and rms <= AMP_LAYER_RMS_TOL and gx <= 1.0
            and gk <= 2.0 and norm <= AMP_GRAD_TOL)


@contextlib.contextmanager
def reordered_products(parts):
    """Every K product's float32 sum in another order: its contraction cut
    into ``parts`` pieces, each summed apart, the pieces then added.  The
    same exact products as the route it wraps, so a run under it is as
    sound as one without."""
    product = ruthotto_module._product

    def split(a, b):
        n = a.shape[-1]
        edges = [round(i * n / parts) for i in range(parts + 1)]
        out = product(a[..., :edges[1]], b[:edges[1]])
        for lo, hi in zip(edges[1:-1], edges[2:]):
            out = out + product(a[..., lo:hi], b[lo:hi])
        return out
    ruthotto_module._product = split
    try:
        yield
    finally:
        ruthotto_module._product = product


def bf16_model_grads(tag, label, make, xs, ys, masks, run, plain):
    """The bf16 grade's loss and model gradients (``run``, the card's)
    against its plain versions, with the card run's ReLU and max-pool
    decisions, held at HYBRID_BF16_GRAD_TOL beside what the grade itself
    determines: the sound runs, the plain versions with their K products
    summed in other orders (HYBRID_SOUND_PARTS), must hold it too; the
    control whose products return bf16 must miss it.  Returns the
    readings."""
    def reading(what, got):
        return compare_grads(f"[{tag}] {label} {what} vs the plain "
                             "versions, loss and every gradient", got, plain,
                             None, HYBRID_ZERO, rel_check=False)[0]
    out = {"card": reading("the card's route", run), "sound": []}
    for parts in HYBRID_SOUND_PARTS:
        with reordered_products(parts):
            out["sound"].append(reading(
                f"plain versions with each K product summed in {parts} "
                "pieces", hybrid_grads(make, xs, ys, masks, plain=True)))
    with bf16_product_outputs():
        out["control"] = reading("control (products returning bf16)",
                                 hybrid_grads(make, xs, ys, masks))
    log(f"  [{tag}] {label} model gradients: the card {out['card']:.3e}, "
        f"the sound runs {max(out['sound']):.3e} at most, the control "
        f"{out['control']:.3e} (limit {HYBRID_BF16_GRAD_TOL:.0e}: the card "
        "and the sound runs within, the control over)")
    if not max(out["card"], *out["sound"]) <= HYBRID_BF16_GRAD_TOL:
        raise AssertionError(f"{label} model gradients: {out}")
    if not out["control"] > HYBRID_BF16_GRAD_TOL:
        raise AssertionError(f"{label}: the bf16-output control passed "
                             f"the model-gradient limit: {out}")
    return out


def hybrid_train(tag, device, rng):
    """The hybrid's train step (``make_train_step``, the preset's
    augmentation, dropout, regulariser and grouped AdamW) in the exact,
    bf16 and AMP grades: launch counts of one step at B = 64 (26 K1 + 26
    K3 per-sweep, 4 K1 hoisted); the loss and every gradient of a
    train-mode step (dropout off, the ReLU and max-pool decisions of the
    card's run replayed) at each B of HYBRID_TRAIN_BATCHES: exact within
    1e-4 of the largest entry of the plain versions' and float64's; bf16
    and AMP: the loss within 4e-3 of its plain versions', the model's
    gradients within HYBRID_BF16_GRAD_TOL, beside the sound runs' and the
    control's (``bf16_model_grads``), and each SymmetricLayer call
    replayed on the plain step's input and cotangent (``replay_calls``,
    held; the bf16-output control must miss a limit there); 50 steps with
    a falling loss; images/s and the busy share at each B."""
    images, labels, _, _ = make_synthetic("cifar10")
    data = (torch.from_numpy(images).to(device),
            torch.from_numpy(labels).to(device))
    out = {}
    for grade in ("exact", "bf16", "amp"):
        def make(rate, grade=grade):
            return hybrid_model(device, grade, rate)
        step = make_train_step(make(None), HYBRID_TRAIN,
                               max(data[0].shape[0] // 64, 1),
                               torch.Generator(device).manual_seed(SEED))
        x, y = data[0][:64], data[1][:64]
        step(x, y)
        sync(device)
        reset_counts()
        loss, _ = step(x, y)
        sync(device)
        got = counts()
        per = (only(K1=HYBRID_BUILDS) if grade == "amp"
               else only(K1=HYBRID_SWEEPS, K3=HYBRID_SWEEPS))
        log(f"[{tag}] {grade}: launches in one train step at B=64: {got}")
        if got != per or not torch.isfinite(loss):
            raise AssertionError(f"hybrid {grade} train step: {got} {loss}")
        out[grade] = {"launches_per_train_step": got}
        for B in HYBRID_TRAIN_BATCHES:
            xs = torch.from_numpy(rng.random((B, 3, 32, 32)).astype(
                np.float32)).to(device)
            ys = torch.from_numpy(rng.integers(0, 10, B)).to(device)
            masks = {}
            run = hybrid_grads(make, xs, ys, masks)
            plain = hybrid_grads(make, xs, ys, masks, plain=True)
            if grade == "exact":
                out[grade][f"B{B}_vs_plain"] = compare_grads(
                    f"[{tag}] exact B={B} loss and every gradient vs the "
                    "plain versions", run, plain, GRAD_TOL, HYBRID_ZERO)[0]
                out[grade][f"B{B}_vs_float64"] = compare_grads(
                    f"[{tag}] exact B={B} loss and every gradient vs "
                    "float64", run, hybrid_grads(make, xs, ys, masks,
                                                 double=True),
                    GRAD_TOL, HYBRID_ZERO)[0]
                continue
            out[grade][f"B{B}_loss_vs_plain"] = check_rel(
                f"[{tag}] {grade} B={B} loss vs its plain versions",
                rel_err(run[0], plain[0]), AMP_OUT_TOL)
            out[grade][f"B{B}_grads"] = bf16_model_grads(
                tag, f"{grade} B={B}", make, xs, ys, masks, run, plain)
            calls = {}
            hybrid_grads(make, xs, ys, masks, plain=True, calls=calls)
            worst, flipped = replay_calls(tag, f"{grade} B={B}", calls)
            out[grade][f"B{B}_replayed"] = dict(zip(
                ("output_steps", "output_rms", "input_grad_steps",
                 "k_grad_steps", "norm_grad"), worst))
            out[grade][f"B{B}_replayed"]["relu_flips"] = flipped
            if not replay_held(worst):
                raise AssertionError(f"{grade} B={B} replayed calls: "
                                     f"{worst}")
            if grade == "bf16" and B == HYBRID_TRAIN_BATCHES[0]:
                with bf16_product_outputs():
                    control, _ = replay_calls(tag, "control (products "
                                              "returning bf16)", calls)
                out["bf16_output_control_replayed"] = control
                if replay_held(control):
                    raise AssertionError(
                        "the bf16-output control passed the replay limits")
        step, out[grade]["loss_50_steps"] = train_falling(
            tag, f"{grade} train", make, HYBRID_TRAIN, data, 64)
        for B in HYBRID_TRAIN_BATCHES:
            out[grade].update(step_rates(tag, f"{grade} train", step, data,
                                         B, rng))
    return out


def phase_hybrid(device, peak_bytes, peak_flops):
    """The CIFAR-10 hybrid at full width: its K products, serving and
    training in the three grades, and the serve CLI with --preset
    cifar10_hybrid --amp (queued; phase_clis runs its train CLI too)."""
    tag = "hybrid"
    rng = np.random.default_rng(SEED + 33)
    out = {"products": timed("hybrid products", phase_hybrid_products,
                             device, peak_bytes, peak_flops)}
    out["serve"] = timed("hybrid serving", hybrid_serve, tag, device, rng)
    out["train"] = timed("hybrid training", hybrid_train, tag, device, rng)
    HYBRID_MODELS.clear()
    cli_later(tag, "cnn_pde_tpu_torch.serve", "cifar10_hybrid", "--amp",
              ok=lambda s: s["amp_cached_layers"] == 2
              and len(s["predictions"]) == 8)
    return out


# ---- the device epoch: the Trainer's step in a CUDA graph (A12) ------------

EPOCH_STEPS = 50          # steps of the compared epoch
# steps of the timed epoch (the eager one is 10-80 ms a step) and of the
# profiled one (a profile of many thousands of kernels takes seconds to
# read)
EPOCH_TIMED_STEPS = {"graph": EPOCH_STEPS, "eager": 10}
EPOCH_PROFILE_STEPS = 5
# each weight tensor after the captured epoch against the eager run's, of
# its largest entry: the same operations in the same order, so bit for bit
# is expected (and logged)
EPOCH_TOL = 1e-6


def epoch_dataset(name, B, seed):
    """Seeded images in [0, 1] and labels of dataset ``name``: EPOCH_STEPS
    batches of B to train on and 1.5·B + 3 to evaluate (the last eval
    batch padded), with the dataset's normalisation."""
    channels, size, classes = SYNTHETIC_SPECS[name]
    rng = np.random.default_rng(seed)
    n, n_test = EPOCH_STEPS * B, B + B // 2 + 3

    def images(k):
        return rng.random((k, channels, size, size), dtype=np.float32)
    mean, std = NORMALIZATION[name]
    return ArrayDataset(images(n), rng.integers(0, classes, n),
                        images(n_test), rng.integers(0, classes, n_test),
                        mean=mean, std=std, num_classes=classes)


def epoch_case(tag, label, make_model, values, name, B, expect, accum=1,
               cudnn_deterministic=False):
    """The Trainer with ``device_epoch`` (the step captured in a CUDA graph)
    beside the same Trainer run eagerly, from the same seeded model
    ``make_model()`` on ``epoch_dataset(name, B)``: the first epoch of
    EPOCH_STEPS steps (its first WARMUP_ROUNDS·k eager, the capture, then
    replays) ends on the eager run's weights within EPOCH_TOL of each
    tensor's largest entry; the graph's eval predictions equal the host
    eval's on the same weights; the second epoch (EPOCH_TIMED_STEPS) timed
    by CUDA events; a third, of EPOCH_PROFILE_STEPS steps, profiled (busy
    share, launch calls a step).
    ``expect``: the kernels the step launches (counted at warm-up and
    capture).  ``cudnn_deterministic``: torch's default cuDNN algorithms
    sum the convolution backward in no fixed order, so that two eager runs
    differ; the captured run is held at those algorithms against the
    eager runs' own spread (``default_cudnn_case``), and then bit for bit
    with cuDNN's deterministic algorithms.  Returns the readings."""
    data = epoch_dataset(name, B, SEED + 40)
    device = torch.device("cuda", 0)
    if cudnn_deterministic:
        spread = default_cudnn_case(tag, label, make_model, values, data, B)
    previous = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = previous or cudnn_deterministic
    try:
        out = _epoch_case(tag, label, make_model, values, data, B, expect,
                          accum, device)
    finally:
        torch.backends.cudnn.deterministic = previous
    if cudnn_deterministic:
        out["default_cudnn"] = spread
    return out


DEFAULT_CUDNN_STEPS = WARMUP_ROUNDS + 1  # the warm-up's, then one replay
DEFAULT_CUDNN_EAGER_RUNS = 4


def default_cudnn_case(tag, label, make_model, values, data, B):
    """At torch's default cuDNN algorithms: DEFAULT_CUDNN_EAGER_RUNS eager
    Trainer epochs of DEFAULT_CUDNN_STEPS steps from the same seeded model
    and the device epoch's (its first WARMUP_ROUNDS steps eager, the rest
    replays of the captured step).  The eager runs' spread is the largest
    difference of any tensor between two of them, of its largest entry;
    the captured run's weights are held against the first eager run's
    within twice that spread (at least EPOCH_TOL).  Returns the
    readings."""

    def run(device_epoch):
        config = TrainConfig.from_preset(
            values, epochs=1, batch_size=B, seed=SEED,
            max_steps_per_epoch=DEFAULT_CUDNN_STEPS,
            device_epoch=device_epoch, log_every=10**9)
        trainer = Trainer(make_model(), config, values)
        state = trainer.init_state(DEFAULT_CUDNN_STEPS)
        trainer.train_epoch(state, data, 0, verbose=False)
        if device_epoch and trainer._runner.graphs is None:
            raise AssertionError(f"{label}: no CUDA graph captured")
        return state.model.state_dict()

    def worst(a, b):
        return max((rel_err(a[k], b[k]), k) for k in a)

    eager = [run(False) for _ in range(DEFAULT_CUDNN_EAGER_RUNS)]
    captured = run(True)
    spread = max(worst(a, b) for i, a in enumerate(eager)
                 for b in eager[i + 1:])
    err = worst(captured, eager[0])
    limit = max(2 * spread[0], EPOCH_TOL)
    log(f"[{tag}] {label} B={B}: torch's default cuDNN algorithms, "
        f"{DEFAULT_CUDNN_STEPS} steps ({WARMUP_ROUNDS} eager, then replays "
        f"of the captured step) against eager: spread of "
        f"{DEFAULT_CUDNN_EAGER_RUNS} eager runs {spread[0]:.3e} "
        f"({spread[1]}); captured vs eager {err[0]:.3e} ({err[1]})")
    check_rel(f"{label} captured vs eager at the default cuDNN algorithms "
              f"(worst: {err[1]}; limit twice the eager spread)", err[0],
              limit)
    return {"steps": DEFAULT_CUDNN_STEPS, "eager_spread": spread[0],
            "eager_spread_where": spread[1], "captured_err": err[0],
            "captured_where": err[1], "limit": limit}


def _epoch_case(tag, label, make_model, values, data, B, expect, accum,
                device):

    def trainer(device_epoch):
        config = TrainConfig.from_preset(
            values, epochs=3, batch_size=B, grad_accum=accum, seed=SEED,
            max_steps_per_epoch=EPOCH_STEPS, device_epoch=device_epoch,
            log_every=10**9)
        t = Trainer(make_model(), config, values)
        return t, t.init_state(EPOCH_STEPS)

    (graph, gs), (eager, es) = trainer(True), trainer(False)
    reset_counts()
    t0 = time.perf_counter()
    first = graph.train_epoch(gs, data, 0, verbose=False)
    capture_s = time.perf_counter() - t0
    captured = counts()
    if not all(captured[k] for k in expect) or any(
            n for k, n in captured.items() if k not in expect):
        raise AssertionError(f"{label}: launches {captured}, expected "
                             f"{expect}")
    runner = graph._runner
    if runner.graphs is None or len(runner.graphs) != (2 if accum > 1
                                                       else 1):
        raise AssertionError(f"{label}: no CUDA graph captured")
    reference = eager.train_epoch(es, data, 0, verbose=False)
    worst, where, equal = 0.0, None, 0
    eager_sd = es.model.state_dict()
    for key, t in gs.model.state_dict().items():
        ref = eager_sd[key]
        if torch.equal(t, ref):
            equal += 1
            continue
        err = rel_err(t, ref)
        if err >= worst:
            worst, where = err, key
    total = len(eager_sd)
    log(f"[{tag}] {label} B={B}: the captured epoch ({EPOCH_STEPS} steps, "
        f"warm-up and capture {capture_s:.2f} s, launches at warm-up and "
        f"capture {captured}) against the eager one: {equal} of {total} "
        f"tensors bit for bit" + ("" if where is None else
                                  f", worst {where} {worst:.3e}")
        + f"; mean loss {first['loss']!r} / {reference['loss']!r}")
    if where is not None:
        check_rel(f"{label} weights after the captured epoch vs eager "
                  f"(worst: {where})", worst, EPOCH_TOL)
    if not np.isfinite(first["loss"]):
        raise AssertionError(f"{label}: loss {first['loss']}")
    on_device = graph.evaluate(gs, data)
    host = eager.evaluate(gs, data)
    if not (np.array_equal(on_device["predictions"], host["predictions"])
            and len(host["predictions"]) == data.test_images.shape[0]
            and on_device["acc"] == host["acc"]):
        raise AssertionError(f"{label}: on-device eval predictions differ "
                             "from the host eval's")
    log(f"[{tag}] {label} B={B}: on-device eval (captured forward, "
        f"{data.test_images.shape[0]} images padded to batches of {B}) "
        f"equals the host eval: accuracy {on_device['acc']:.2f}%")

    out = {"bitwise_tensors": equal, "tensors": total,
           "worst_rel_err": worst, "capture_s": capture_s}
    for mode, trainer_, state in (("graph", graph, gs),
                                  ("eager", eager, es)):
        timed = EPOCH_TIMED_STEPS[mode]
        trainer_.config.max_steps_per_epoch = timed
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        trainer_.train_epoch(state, data, 1, verbose=False)
        stop.record()
        stop.synchronize()
        ms = start.elapsed_time(stop) / timed
        trainer_.config.max_steps_per_epoch = EPOCH_PROFILE_STEPS
        busy = device_busy(lambda: trainer_.train_epoch(
            state, data, 2, verbose=False), 1, device, warm=False)
        out[mode] = {"step_ms": ms, "images_per_s": 1e3 * B / ms}
        if busy is None:
            log(f"[{tag}] {label} B={B} {mode}: {1e3 * B / ms:.1f} images/s "
                f"({ms:.3f} ms a step, CUDA events over an epoch of "
                f"{timed}); busy share not measured (the profiler recorded "
                "no kernel)")
            continue
        per = {"busy": busy[0],
               "device_us_per_step": busy[0] * busy[1] / EPOCH_PROFILE_STEPS,
               "kernel_launch_calls_per_step": busy[4] / EPOCH_PROFILE_STEPS,
               "driver_launch_calls_per_step": busy[5] / EPOCH_PROFILE_STEPS,
               "graph_launches_per_step": busy[6] / EPOCH_PROFILE_STEPS}
        out[mode].update(per)
        log(f"[{tag}] {label} B={B} {mode}: {1e3 * B / ms:.1f} images/s "
            f"({ms:.3f} ms a step, CUDA events over an epoch of "
            f"{timed}); profiled epoch of {EPOCH_PROFILE_STEPS} steps:"
            f" device busy {100 * busy[0]:.1f}%, device time "
            f"{per['device_us_per_step']:.0f} us a step, launch calls a "
            f"step: {per['kernel_launch_calls_per_step']:g} "
            f"cudaLaunchKernel, {per['driver_launch_calls_per_step']:g} "
            f"cuLaunchKernel, {per['graph_launches_per_step']:g} "
            f"cudaGraphLaunch; top kernels: {busy[2]}; top host ops: "
            f"{busy[3]}")
    return out


def write_cifar10_fixture(root, per_batch=64, n_test=100):
    """The CIFAR-10 python pickles (cifar-10-batches-py/data_batch_1..5,
    test_batch) of seeded uint8 images under ``root``."""
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base, exist_ok=True)
    rng = np.random.default_rng(SEED + 41)
    for name, n in [(f"data_batch_{i}", per_batch) for i in range(1, 6)] \
            + [("test_batch", n_test)]:
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072),
                                               dtype=np.uint8),
                         b"labels": [int(v) for v in
                                     rng.integers(0, 10, n)]}, f)


def phase_device_epoch(device):
    """The device epoch (``TrainConfig.device_epoch``) of every family,
    ``epoch_case`` each: the flagship per-sweep and fused (K2 in its eval)
    at B = 64 and 256, mnist per-sweep and fused (K6 in its eval) at 128
    and fused with grad_accum 2 (two captured bodies), svhn at 256,
    emotion at 64, tiny_imagenet at 32 (at torch's default cuDNN
    algorithms against the eager runs' spread, then with the deterministic
    ones bit for bit, ``epoch_case``) and the hybrid (bf16 products) at 64; then
    the train CLI with --device-epoch --data-dir on a CIFAR-10 pickle
    fixture (queued)."""
    tag, out = "device-epoch", {}
    cases = [
        ("flagship per_sweep", lambda: flagship(device), TRAIN, "cifar10",
         (64, 256), ("K1", "K3")),
        ("flagship fused", lambda: flagship(device, fused=True,
                                            fused_pde=True),
         TRAIN, "cifar10", (64, 256), ("K4", "K5")),
        ("mnist per_sweep", lambda: grayscale_model(device), GRAY_TRAIN,
         "mnist", (128,), ("K1", "K3")),
        ("mnist fused", lambda: grayscale_model(
            device, fused_inference=True, fused=True), GRAY_TRAIN, "mnist",
         (128,), ("K7", "K8")),
        ("svhn per_sweep", lambda: svhn_model(device), SVHN_TRAIN, "svhn",
         (256,), ("K1", "K3")),
        ("emotion", lambda: emotion_model(device), EMOTION_TRAIN, "emotion",
         (64,), ()),
        ("tiny_imagenet", lambda: tiny_model(device), TINY_TRAIN,
         "tiny_imagenet", (32,), (), True),
        ("hybrid bf16", lambda: hybrid_model(device), HYBRID_TRAIN,
         "cifar10", (64,), ("K1", "K3")),
    ]
    for label, make, values, name, batches, expect, *deterministic in cases:
        for B in batches:
            out[f"{label} B{B}".replace(" ", "_")] = epoch_case(
                tag, label, make, values, name, B, expect,
                cudnn_deterministic=bool(deterministic))
    out["mnist_fused_accum2_B128"] = epoch_case(
        tag, "mnist fused grad_accum=2", lambda: grayscale_model(
            device, fused_inference=True, fused=True), GRAY_TRAIN, "mnist",
        128, ("K7", "K8"), accum=2)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "device_epoch_data")
    shutil.rmtree(root, ignore_errors=True)
    write_cifar10_fixture(root)
    cli_later(tag, "cnn_pde_tpu_torch.train", "cifar10_noconv",
              "--device-epoch", "--data-dir", root, "--epochs", "2",
              "--steps", "3", "--batch-size", "64", "--quiet",
              ok=lambda s: s["data"] == "real" and s["device_epoch"]
              and s["steps"] == 6 and s["device"].startswith("cuda")
              and np.isfinite(s["last_loss"]))
    return out


# ---- phase 10c: serving (ROADMAP.md A13) ----------------------------------

A13_BUCKETS = (1, 64, 1024)
A13_REQUESTS = (1, 7, 64, 300, 1024)
A13_RATE_BATCHES = (1, 64, 1024)
# requests a round by predict and B (host clock, 3 rounds in turns)
A13_REPS = {"captured": {1: 200, 64: 100, 1024: 20},
            "eager": {1: 20, 64: 10, 1024: 4}}
# a captured predict against the eager one, of the largest entry: the same
# kernels on the same padded batch (bit for bit logged)
CAPTURED_TOL = 1e-6
# a composed matrix against the same basis on the plain versions, of its
# largest entry (KERNEL_TOL: the basis is the kernels' own evolution)
BASIS_TOL = KERNEL_TOL
# linearized logits against the sequential eager predict: float32
# reassociation over D-term sums (LOGIT_TOL, absolute); bf16 storage
# (rtol and atol, tests/test_linearize.py); W8A8 (of the largest entry)
LIN_BF16_TOL = 2e-2
LIN_INT8_TOL = 2e-2
LIN_BATCHES = (1, 16, 64, 256, 1024)
LIN_REPS = {1: 200, 16: 200, 64: 100, 256: 40, 1024: 20}
LIN_GRADES = (("f32", None), ("bf16", torch.bfloat16), ("int8", "int8"))
EXPORT_BATCH = 8
EXPORT_TOL = 1e-6   # a loaded program's logits against the predict's
HTTP_BUCKETS = (1, 8, 64)
HTTP_MICROBATCH = 64
HTTP_CLIENTS, HTTP_REQUESTS = 8, 20
HTTP_TOL = 1e-6     # a response against its request's eager logits
RELOAD_FIELDS_SEED = SEED + 50  # the flagship fields a reload serves
A13_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "serving")


def hoisted_cached(model, grade):
    """``model`` on the hoisted path at ``grade`` with its operators
    cached (6 K1 launches for the flagship, outside any counted run)."""
    cache_hoisted_operators(amp_switch(model, grade))
    return model


def cached(model):
    """``model`` with its hoisted operators cached (outside any counted
    run)."""
    cache_hoisted_operators(model)
    return model


def seeded_batch(rng, n, shape, device):
    return torch.from_numpy(rng.random((n, *shape)).astype(
        np.float32)).to(device)


def rates_in_turns(fns, x, reps):
    """{label: images/s} of each predict in ``fns`` on ``x``: three rounds
    of ``reps[label]`` requests, the predicts in turns, the median (host
    clock, after one warm-up request each)."""
    runs = {label: [] for label in fns}
    for fn in fns.values():
        fn(x)
    torch.cuda.synchronize()
    for _ in range(3):
        for label, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(reps[label]):
                fn(x)
            torch.cuda.synchronize()
            runs[label].append(x.shape[0] * reps[label]
                               / (time.perf_counter() - t0))
    return {label: statistics.median(r) for label, r in runs.items()}


def captured_case(tag, label, make, shape, per, rng, device, classes=10,
                  rate_batches=A13_RATE_BATCHES):
    """``make_predict_fn`` (one CUDA graph a bucket) against the eager
    predict of the same model, buckets A13_BUCKETS, one request of each
    size in A13_REQUESTS: the launches at warm-up and capture (WARMUP_ROUNDS
    + 1 forwards a bucket, ``per`` a forward) and none from Python when the
    same requests replay; logits within CAPTURED_TOL of their largest
    entry (bit for bit logged); the model's predicts of probabilities and
    labels made after it share its graphs (no capture, no launch from
    Python), probabilities within CAPTURED_TOL and labels equal to eager;
    images/s of both in turns at ``rate_batches``; busy share and launch
    calls a request of both at the largest."""
    model = make()
    eager = make_eager_predict_fn(model, buckets=A13_BUCKETS)
    predict = make_predict_fn(model, buckets=A13_BUCKETS)
    xs = {n: seeded_batch(rng, n, shape, device) for n in A13_REQUESTS}
    reset_counts()
    t0 = time.perf_counter()
    got = {n: predict(x) for n, x in xs.items()}
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    captured = counts()
    forwards = (WARMUP_ROUNDS + 1) * len(A13_BUCKETS)
    if captured != only(**{k: v * forwards for k, v in per.items()}) or \
            sorted(predict.graphs) != list(A13_BUCKETS):
        raise AssertionError(f"{label}: launches {captured} and graphs "
                             f"{sorted(predict.graphs)}, expected {per} a "
                             f"forward over {forwards} forwards")
    graphs = dict(predict.graphs)
    reset_counts()
    again = {n: predict(x) for n, x in xs.items()}
    others = {}
    for output in ("probs", "labels"):
        fn = make_predict_fn(model, output=output, buckets=A13_BUCKETS)
        others[output] = {n: fn(x) for n, x in xs.items()}
    torch.cuda.synchronize()
    if counts() != only() or len(predict.graphs) != len(graphs) or any(
            predict.graphs[b] is not e for b, e in graphs.items()):
        raise AssertionError(f"{label}: replays launched {counts()} from "
                             f"Python, graphs {sorted(predict.graphs)}")
    ref = {n: eager(x) for n, x in xs.items()}
    bitwise = []
    for n in A13_REQUESTS:
        if got[n].shape != (n, classes) or not torch.isfinite(got[n]).all():
            raise AssertionError(f"{label} n={n}: bad logits")
        bitwise.append(torch.equal(got[n], ref[n])
                       and torch.equal(again[n], ref[n]))
        check_rel(f"{label} request of {n} (bucket "
                  f"{next(b for b in A13_BUCKETS if b >= n)}) captured vs "
                  f"eager{', bit for bit' if bitwise[-1] else ''}",
                  max(rel_err(got[n], ref[n]), rel_err(again[n], ref[n])),
                  CAPTURED_TOL)
        probs = torch.softmax(ref[n], dim=-1)
        if rel_err(others["probs"][n], probs) > CAPTURED_TOL or \
                not torch.equal(others["labels"][n], ref[n].argmax(-1)):
            raise AssertionError(
                f"{label} n={n}: the shared graphs' probabilities "
                f"({rel_err(others['probs'][n], probs):.3e}) or labels "
                "differ from eager")
    log(f"[{tag}] {label}: {len(predict.graphs)} graphs captured in "
        f"{capture_s:.2f} s (launches at warm-up and capture {captured}, "
        f"none from Python a replay; the probs and labels predicts "
        f"replayed them); {sum(bitwise)} of {len(bitwise)} requests bit "
        "for bit")
    out = {"launches_at_capture": captured, "capture_s": capture_s,
           "bitwise_requests": sum(bitwise), "requests": len(bitwise)}
    fns = {"captured": predict, "eager": eager}
    if not rate_batches:
        return out
    for B in rate_batches:
        rates = rates_in_turns(fns, xs[B], {k: A13_REPS[k][B] for k in fns})
        for mode, rate in rates.items():
            out.setdefault(mode, {})[f"B{B}"] = rate
        log(f"[{tag}] {label} B={B}: captured {rates['captured']:.1f}, "
            f"eager {rates['eager']:.1f} images/s (host clock, median of 3 "
            f"rounds in turns), {rates['captured'] / rates['eager']:.2f}x")
    big = max(rate_batches)
    for mode, fn in fns.items():
        busy = device_busy(lambda: fn(xs[big]), BUSY_REPS, device)
        log_busy(tag, f"{label} {mode} B={big}", busy, "request")
        if busy is not None:
            out[mode].update({
                f"B{big}_busy": busy[0],
                f"B{big}_device_us_per_request": busy[0] * busy[1],
                f"B{big}_launch_calls_per_request": busy[4] + busy[5],
                f"B{big}_graph_launches_per_request": busy[6]})
    return out


def linear_caches(model):
    return [lay.linear_cache for lay in iter_linear_pde_layers(model)
            if getattr(lay, "linear_cache", None) is not None]


def linearize_case(tag, label, make, shape, basis, rng, device,
                   timed_rates):
    """``linearize_pde_layers`` on ``make()``: the basis evolution's
    launches (``basis``: each linear layer's forward once at B = D), each
    composed matrix within BASIS_TOL of its largest entry against the same
    basis on the plain versions; then each grade of LIN_GRADES served by
    a captured predict, its logits at LIN_BATCHES against the sequential
    eager predict (f32 LOGIT_TOL; bf16 LIN_BF16_TOL rtol and atol; int8
    LIN_INT8_TOL of the largest entry, and labels equal on a batch of 16)
    and, with ``timed_rates``, its images/s at each B (host clock, median
    of 3 rounds of LIN_REPS[B])."""
    model = make()
    seq = make_eager_predict_fn(model)
    xs = {B: seeded_batch(rng, B, shape, device) for B in LIN_BATCHES}
    ref = {B: seq(x) for B, x in xs.items()}
    reset_counts()
    t0 = time.perf_counter()
    n = linearize_pde_layers(model, xs[1])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    got = counts()
    if got != only(**basis):
        raise AssertionError(f"{label}: basis launches {got}, expected "
                             f"{basis}")
    mats = linear_caches(model)
    clear_linear_cache(model)
    with kernels.plain_versions():
        linearize_pde_layers(model, xs[1])
    out = {"layers": n, "basis_launches": got, "build_s": build_s,
           "matrix_err": 0.0}
    for i, (m, p) in enumerate(zip(mats, linear_caches(model))):
        out["matrix_err"] = max(out["matrix_err"], check_rel(
            f"{label} layer {i} composed ({m.shape[0]}, {m.shape[1]}) "
            "matrix vs the plain versions' basis", rel_err(m, p),
            BASIS_TOL))
    log(f"[{tag}] {label}: {n} layers linearized in {build_s:.2f} s, "
        f"basis launches {got}")
    for grade, dtype in LIN_GRADES:
        clear_linear_cache(model)
        linearize_pde_layers(model, xs[1], dtype=dtype)
        predict = make_predict_fn(model)
        logits = {B: predict(x) for B, x in xs.items()}
        for B in LIN_BATCHES:
            if logits[B].shape != ref[B].shape or not torch.isfinite(
                    logits[B]).all():
                raise AssertionError(f"{label} {grade} B={B}: bad logits")
            if grade == "f32":
                check(f"{label} {grade} B={B} vs sequential",
                      max_err(logits[B], ref[B]), LOGIT_TOL)
            elif grade == "bf16":
                excess = float(((logits[B] - ref[B]).abs() - LIN_BF16_TOL
                                * ref[B].abs()).max())
                check(f"{label} {grade} B={B} vs sequential (beyond "
                      f"rtol {LIN_BF16_TOL:.0e})", max(excess, 0.0),
                      LIN_BF16_TOL)
            else:
                check_rel(f"{label} {grade} B={B} vs sequential",
                          rel_err(logits[B], ref[B]), LIN_INT8_TOL)
        if grade == "int8":
            x16 = xs[16]
            want, have = ref[16].argmax(-1), predict(x16).argmax(-1)
            top2 = ref[16].topk(2, dim=-1).values
            log(f"  {label} int8 labels on 16 images: {have.tolist()} "
                f"(sequential {want.tolist()}; smallest top-2 margin "
                f"{float((top2[:, 0] - top2[:, 1]).min()):.3e})")
            if not torch.equal(want, have):
                raise AssertionError(f"{label}: int8 labels differ")
        if timed_rates:
            out[grade] = {}
            for B in LIN_BATCHES:
                rate = rates_in_turns({grade: predict}, xs[B],
                                      {grade: LIN_REPS[B]})[grade]
                out[grade][f"B{B}"] = rate
                log(f"[{tag}] {label} {grade} B={B}: {rate:.1f} images/s "
                    "(captured, host clock, median of 3 rounds of "
                    f"{LIN_REPS[B]})")
    return out


def grade_table(tag, label, rates):
    """The fastest of bf16 and int8 at each B, and the smallest B from which
    int8 wins at every larger B (None: it never does)."""
    wins = {B: rates["int8"][f"B{B}"] > rates["bf16"][f"B{B}"]
            for B in LIN_BATCHES}
    from_b = next((B for B in LIN_BATCHES
                   if all(wins[b] for b in LIN_BATCHES if b >= B)), None)
    log(f"[{tag}] {label} grade by batch: " + ", ".join(
        f"B={B} {'int8' if wins[B] else 'bf16'} "
        f"({rates['int8'][f'B{B}'] / rates['bf16'][f'B{B}']:.2f}x)"
        for B in LIN_BATCHES) + f"; int8 wins from B={from_b}")
    return {"int8_wins": {f"B{B}": w for B, w in wins.items()},
            "int8_from": from_b}


EXPORT_CODE = """
import json, sys
import numpy as np, torch
from cnn_pde_tpu_torch.ops import fused_channel, fused_grayscale, tridiag
from cnn_pde_tpu_torch.serve import load_exported
root, labels = sys.argv[1], sys.argv[2].split(",")
x = torch.from_numpy(np.load(root + "/x.npy")).cuda()
launches = {}
for label in labels:
    fn = load_exported(root + "/" + label + ".pt2")
    before = (tridiag.tridiag_solve.launches,
              fused_channel.fused_channel_diffusion_fwd.launches)
    np.save(root + "/" + label + "_out.npy", fn(x).cpu().numpy())
    launches[label] = {
        "K1": tridiag.tridiag_solve.launches - before[0],
        "K2": fused_channel.fused_channel_diffusion_fwd.launches - before[1]}
bad = [k for k in sys.modules if k.split(".")[0] in ("jax", "cnn_pde_tpu")]
print(json.dumps({"launches": launches, "foreign": bad}))
"""


def export_case(tag, device, rng):
    """``export_model`` of the flagship per-sweep, fused and int8-linearized
    on cuda at B = EXPORT_BATCH, beside the in-process (captured)
    predict's logits; the programs are loaded and checked by
    ``export_loader_job``, queued for phase 12."""
    shutil.rmtree(A13_DIR, ignore_errors=True)
    os.makedirs(A13_DIR)
    x = seeded_batch(rng, EXPORT_BATCH, (3, 32, 32), device)
    np.save(os.path.join(A13_DIR, "x.npy"), x.cpu().numpy())

    def int8(model):
        linearize_pde_layers(model, x, dtype="int8")
        return model
    cases = {"per_sweep": lambda: flagship(device),
             "fused": lambda: flagship(device, fused=True),
             "int8": lambda: int8(flagship(device))}
    out = {}
    for label, make in cases.items():
        model = make()
        t0 = time.perf_counter()
        blob = export_model(model, x, os.path.join(A13_DIR, f"{label}.pt2"))
        out[label] = {"export_s": time.perf_counter() - t0,
                      "bytes": len(blob)}
        np.save(os.path.join(A13_DIR, f"{label}_want.npy"),
                make_predict_fn(model)(x).cpu().numpy())
        log(f"[{tag}] exported {label}: {len(blob)} bytes in "
            f"{out[label]['export_s']:.2f} s")
    CLI_JOBS.append(lambda: export_loader_job(tag, out))
    CLI_JOBS[-1].__name__ = "exported programs in a fresh process"
    return out


def export_loader_job(tag, out):
    """The exported programs loaded in one fresh ``python3 -c`` process
    that imports only ``cnn_pde_tpu_torch``: each one's logits within
    EXPORT_TOL of the largest entry of the in-process predict's, and its
    kernel launches counted there (51 K1 per-sweep, 3 K2 fused, none
    int8)."""
    proc = subprocess.run(
        [sys.executable, "-c", EXPORT_CODE, A13_DIR, ",".join(out)],
        capture_output=True, text=True, timeout=300, check=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    if report["foreign"]:
        raise AssertionError(f"the loading process imported "
                             f"{report['foreign']}")
    expect = {"per_sweep": {"K1": 51, "K2": 0}, "fused": {"K1": 0, "K2": 3},
              "int8": {"K1": 0, "K2": 0}}
    lines = []
    for label, entry in out.items():
        got, want = (torch.from_numpy(np.load(os.path.join(
            A13_DIR, f"{label}_{kind}.npy"))) for kind in ("out", "want"))
        entry["launches_in_loader"] = report["launches"][label]
        entry["err"] = rel_err(got, want)
        entry["bitwise"] = bool(torch.equal(got, want))
        lines.append(f"[{tag}] export {label} loaded in a fresh process vs "
                     f"the predict: max err {entry['err']:.3e} of its "
                     f"largest entry (tolerance {EXPORT_TOL:.0e}"
                     f"{', bit for bit' if entry['bitwise'] else ''}); "
                     f"launches there {report['launches'][label]}")
        if entry["err"] > EXPORT_TOL or \
                report["launches"][label] != expect[label]:
            raise AssertionError(lines[-1] + f", expected {expect[label]}")
    return lines


def http_post(base, path, x=None):
    """POST ``x`` (a float32 array, as .npy) or nothing to ``base + path``;
    the .npy or JSON reply."""
    import io
    import urllib.request
    body = b""
    if x is not None:
        buf = io.BytesIO()
        np.save(buf, x)
        body = buf.getvalue()
    req = urllib.request.Request(
        base + path, data=body, method="POST",
        headers={"Content-Type": "application/x-npy",
                 "Accept": "application/x-npy"})
    with urllib.request.urlopen(req, timeout=120) as r:
        data = r.read()
    if x is None:
        return json.loads(data)
    return np.load(io.BytesIO(data), allow_pickle=False)


def http_case(tag, device, rng):
    """``serve_http`` on the captured flagship predicts the serve CLI
    makes (``serve_cli.warmed_predict_fns``: labels, probs and logits,
    every bucket of HTTP_BUCKETS warmed, one graph a bucket shared by the
    three), logits by default, micro-batched (HTTP_MICROBATCH rows,
    pipeline 2): HTTP_CLIENTS threads of HTTP_REQUESTS requests of 1-16
    images each, every response within HTTP_TOL of its request's eager
    logits; then the same requests again, round and round, across a
    reload to other weights through the CLI's reload path (a fresh model,
    its predicts warmed before the swap): every response matches the old
    or the new weights' eager logits, and every request sent after the
    reload returned the new; /metrics' coalescing logged."""
    import threading

    from cnn_pde_tpu_torch.serve_cli import warmed_predict_fns
    from cnn_pde_tpu_torch.serve_http import serve_http

    warm = rng.random((8, 3, 32, 32), dtype=np.float32)

    def warmed(model):
        return warmed_predict_fns(model, HTTP_BUCKETS, warm)

    images = {(c, j): rng.random((int(rng.integers(1, 17)), 3, 32, 32),
                                 dtype=np.float32)
              for c in range(HTTP_CLIENTS) for j in range(HTTP_REQUESTS)}
    srv = serve_http(warmed(flagship(device)), port=0, background=True,
                     default_output="logits", microbatch=HTTP_MICROBATCH,
                     microbatch_pipeline=2,
                     reload_fn=lambda: warmed(flagship(
                         device, fields_seed=RELOAD_FIELDS_SEED)))
    base = f"http://{srv.host}:{srv.port}"
    replies, errors = [], []
    stop = threading.Event()
    reloaded = {}

    def client(c, rounds):
        k = 0
        while k < rounds * HTTP_REQUESTS and not stop.is_set():
            j = k % HTTP_REQUESTS
            after = "s" in reloaded
            try:
                replies.append((c, j, http_post(base, "/predict",
                                                images[(c, j)]),
                                rounds > 1, after))
            except Exception as e:  # every failure fails the phase
                errors.append(e)
                return
            k += 1

    def run(rounds, during=None):
        threads = [threading.Thread(target=client, args=(c, rounds))
                   for c in range(HTTP_CLIENTS)]
        for t in threads:
            t.start()
        if during is not None:
            during()
        for t in threads:
            t.join(timeout=600)
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"HTTP clients failed: {errors[:3]}")

    def reload_under_load():
        time.sleep(0.2)
        t0 = time.perf_counter()
        answer = http_post(base, "/reload")
        reloaded["s"] = time.perf_counter() - t0
        if not answer["ok"]:
            raise AssertionError(f"reload: {answer}")
        time.sleep(0.5)
        stop.set()

    try:
        t0 = time.perf_counter()
        run(1)
        load_s = time.perf_counter() - t0
        before = http_metrics(base)
        run(10**6, reload_under_load)
        after = http_metrics(base)
    finally:
        srv.shutdown()
    old = make_eager_predict_fn(flagship(device))
    new = make_eager_predict_fn(flagship(device,
                                         fields_seed=RELOAD_FIELDS_SEED))
    refs = {}
    worst = {"old": 0.0, "new": 0.0}
    seen = {"old": 0, "new": 0}
    for c, j, reply, across, sent_after in replies:
        if (c, j) not in refs:
            x = torch.from_numpy(images[(c, j)]).to(device)
            refs[(c, j)] = (old(x).cpu(), new(x).cpu())
        errs = {"old": rel_err(torch.from_numpy(reply), refs[(c, j)][0])}
        if across:
            errs["new"] = rel_err(torch.from_numpy(reply), refs[(c, j)][1])
        side = min(errs, key=errs.get)
        if errs[side] > HTTP_TOL or (sent_after and side != "new"):
            raise AssertionError(
                f"HTTP client {c} request {j} ({images[(c, j)].shape[0]} "
                f"images, {'across the reload' if across else 'before it'}"
                f"{', sent after it returned' if sent_after else ''}): "
                f"{errs} of the largest entry from the eager logits of "
                "each weights")
        worst[side] = max(worst[side], errs[side])
        seen[side] += 1
    if not seen["new"]:
        raise AssertionError("no response came from the reloaded weights")
    log(f"[{tag}] HTTP: {HTTP_CLIENTS} clients x {HTTP_REQUESTS} requests "
        f"of 1-16 images in {load_s:.2f} s, then "
        f"{len(replies) - HTTP_CLIENTS * HTTP_REQUESTS} across a reload "
        f"that took {reloaded['s']:.2f} s: {seen['old']} responses on the "
        f"old weights (worst {worst['old']:.3e}), {seen['new']} on the new "
        f"(worst {worst['new']:.3e}) of the largest entry (limit "
        f"{HTTP_TOL:.0e}); /metrics before the reload {before}, after "
        f"{after}")
    return {"responses": seen, "worst": worst, "reload_s": reloaded["s"],
            "load_s": load_s, "metrics_before_reload": before,
            "metrics_after_reload": after}


def http_metrics(base):
    import urllib.request
    with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
        return json.loads(r.read())


def http_cli_job():
    """The serve CLI with --http 0 on cuda: it answers /healthz and one
    /predict, then is terminated."""
    import threading
    import urllib.request
    cmd = [sys.executable, "-u", "-m", "cnn_pde_tpu_torch.serve", "--preset",
           "cifar10_noconv", "--http", "0", "--buckets", "1,8",
           "--microbatch", "8", "--output", "logits"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    killer = threading.Timer(300, proc.kill)
    killer.start()
    try:
        line = proc.stdout.readline()
        if not line.startswith("serving on http://"):
            raise AssertionError(f"serve --http: {line!r} "
                                 f"{proc.stderr.read()[-2000:]}")
        base = line.split()[2]
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        x = np.random.default_rng(SEED + 60).random(
            (3, 3, 32, 32)).astype(np.float32)
        logits = http_post(base, "/predict", x)
        if not health["ok"] or logits.shape != (3, 10) or not np.isfinite(
                logits).all():
            raise AssertionError(f"serve --http: {health}, {logits.shape}")
    finally:
        killer.cancel()
        proc.terminate()
        proc.wait(timeout=60)
    return [f"[serving] python -m cnn_pde_tpu_torch.serve {' '.join(cmd[4:])} "
            f"(default device cuda): /healthz {health}, /predict of 3 images "
            f"-> {logits.shape} logits, then terminated"]


def phase_serving(device):
    """Serving, ROADMAP.md A13: the captured predict (``captured_case``) of
    the flagship per-sweep, fused, and hoisted f32 and bf16 (cached) and
    mnist per-sweep and fused; linearized serving (``linearize_case``) of
    the flagship per-sweep (the basis on K1) and fused (on K2 at B = 3,072)
    and mnist fused (on K6 at B = 784), the grade-by-batch rates of the
    flagship and mnist; export (``export_case``); HTTP
    (``http_case``); and three serve CLI runs queued for phase 12."""
    tag, out = "serving", {}
    rng = np.random.default_rng(SEED + 70)
    cases = {
        "flagship per_sweep": (lambda: flagship(device), (3, 32, 32),
                               {"K1": 51}),
        "flagship fused": (lambda: flagship(device, fused=True),
                           (3, 32, 32), {"K2": 3}),
        "flagship hoisted f32": (lambda: hoisted_cached(flagship(device),
                                                        "f32"),
                                 (3, 32, 32), {}),
        "flagship hoisted bf16": (lambda: hoisted_cached(flagship(device),
                                                         "bf16"),
                                  (3, 32, 32), {}),
        "mnist per_sweep": (lambda: grayscale_model(device), (1, 28, 28),
                            {"K1": 30}),
        "mnist fused": (lambda: grayscale_model(device,
                                                fused_inference=True),
                        (1, 28, 28), {"K6": 1}),
    }
    out["captured"] = {}
    for label, (make, shape, per) in cases.items():
        out["captured"][label.replace(" ", "_")] = captured_case(
            tag, label, make, shape, per, rng, device)
        torch.cuda.empty_cache()
    # one configuration of each other family, held the same way (no rates)
    families = {
        "svhn hoisted bf16": (lambda: hoisted_cached(svhn_model(device),
                                                     "bf16"),
                              (3, 32, 32), {}, 10),
        "emotion": (lambda: emotion_model(device), (1, 48, 48), {}, 7),
        "tiny_imagenet": (lambda: tiny_model(device), (3, 64, 64), {}, 200),
        "tiny_imagenet amp": (lambda: enable_amp_checked(tiny_model(device)),
                              (3, 64, 64), {}, 200),
        "hybrid exact": (lambda: hybrid_model(device, "exact"),
                         (3, 32, 32), {"K1": 26}, 10),
        "hybrid bf16": (lambda: hybrid_model(device, "bf16"), (3, 32, 32),
                        {"K1": 26}, 10),
        "hybrid amp (cached)": (lambda: cached(hybrid_model(device, "amp")),
                                (3, 32, 32), {}, 10),
    }
    for label, (make, shape, per, classes) in families.items():
        out["captured"][label.replace(" ", "_")] = captured_case(
            tag, label, make, shape, per, rng, device, classes=classes,
            rate_batches=())
        torch.cuda.empty_cache()
    out["linearized"] = {
        "flagship_per_sweep": linearize_case(
            tag, "flagship per_sweep", lambda: flagship(device),
            (3, 32, 32), {"K1": 51}, rng, device, True),
        "flagship_fused": linearize_case(
            tag, "flagship fused", lambda: flagship(device, fused=True),
            (3, 32, 32), {"K2": 3}, rng, device, False),
        "mnist_fused": linearize_case(
            tag, "mnist fused", lambda: grayscale_model(
                device, fused_inference=True), (1, 28, 28), {"K6": 1}, rng,
            device, True)}
    out["grade_table"] = {
        "flagship": grade_table(tag, "flagship (D = 3072)",
                                out["linearized"]["flagship_per_sweep"]),
        "mnist": grade_table(tag, "mnist (D = 784)",
                             out["linearized"]["mnist_fused"])}
    torch.cuda.empty_cache()
    out["export"] = export_case(tag, device, rng)
    out["http"] = http_case(tag, device, rng)
    cli_later(tag, "cnn_pde_tpu_torch.serve", "cifar10_noconv",
              "--linearize", "auto", "--buckets", "1,64,1024",
              ok=lambda s: s["linearized_layers"] == 3
              and s["linearize_grade"] == "auto"
              and len(s["predictions"]) == 8)
    path = os.path.join(A13_DIR, "cli.pt2")
    cli_later(tag, "cnn_pde_tpu_torch.serve", "cifar10_noconv",
              "--export", path,
              ok=lambda s: s["exported"] == path
              and os.path.getsize(path) > 0 and len(s["predictions"]) == 8)
    http_cli_job.__name__ = "cnn_pde_tpu_torch.serve --http"
    CLI_JOBS.append(http_cli_job)
    return out


def trainer_cli(*args, popen=False):
    """The train CLI with ``args`` on the default device (cuda), unbuffered:
    its summary line, or (``popen``) the running process."""
    cmd = [sys.executable, "-u", "-m", "cnn_pde_tpu_torch.train", *args]
    cwd = os.path.dirname(os.path.abspath(__file__))
    if popen:
        return subprocess.Popen(cmd, cwd=cwd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    cli = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                         timeout=300, check=True)
    return json.loads(cli.stdout.strip().splitlines()[-1])


def phase_clis():
    """The Trainer's jobs (``trainer_jobs``) and every queued CLI run,
    CLI_WORKERS at a time: each job its own thread and its processes its
    own, all on the card; then each job's log lines and wall time in
    that order.  Returns the Trainer's readings."""
    tag, out = "trainer", {}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "trainer")
    shutil.rmtree(root, ignore_errors=True)
    try:
        # the Trainer's chains of processes first; more processes at once
        # than this slowed each to 3-4 times its time alone
        jobs = trainer_jobs(tag, out, root) + CLI_JOBS
        with concurrent.futures.ThreadPoolExecutor(CLI_WORKERS) as pool:
            futures = [pool.submit(clocked, job) for job in jobs]
        for future in futures:
            for line in future.result():
                log(line)
        resumed_equal(tag, out, root)
        return out
    finally:
        # the hybrid's checkpoints hold about 0.5 GB each
        shutil.rmtree(root, ignore_errors=True)


def clocked(job):
    """``job()``'s log lines and its wall time."""
    t0 = time.perf_counter()
    lines = job()
    return lines + [f"[time] {job.__name__}: "
                    f"{time.perf_counter() - t0:.1f} s"]


def trainer_jobs(tag, out, root):
    """``Trainer.fit`` through the train CLI on the card, three jobs: the
    hybrid at B = 64 for 2 epochs of 3 steps with a checkpoint every epoch
    and a metrics file; the same run stopped by SIGTERM during epoch 1
    (GracefulPreemption: it finishes the epoch, evaluates, saves 'last'
    and exits), then resumed with --resume (``resumed_equal`` holds its
    final weights against the first run's); emotion with its early
    stopping on, then the serve CLI from that checkpoint directory."""
    # the synthetic CIFAR-10 set's 200 images make 3 steps an epoch at 64
    common = ["--preset", "cifar10_hybrid", "--synthetic", "--epochs", "2",
              "--steps", "3", "--batch-size", "64", "--checkpoint-every", "1"]
    whole, killed = os.path.join(root, "whole"), os.path.join(root, "killed")

    def uninterrupted():
        summary = trainer_cli(*common, "--checkpoint-dir", whole,
                              "--metrics-out", os.path.join(whole, "m.jsonl"),
                              "--quiet")
        with open(os.path.join(whole, "m.jsonl")) as f:
            records = [json.loads(s) for s in f]
        if summary["epochs"] != 2 or summary["steps"] != 6 \
                or len(records) != 2:
            raise AssertionError(f"trainer run: {summary}")
        return [f"[{tag}] uninterrupted: {summary}; metrics records "
                f"{records}"]

    def preempted_and_resumed():
        proc = trainer_cli(*common, "--checkpoint-dir", killed, popen=True)
        try:
            for line in proc.stdout:
                if line.startswith("Epoch 1, Batch 0"):
                    proc.send_signal(signal.SIGTERM)
                    break
            stdout, stderr = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode != 0:
            raise AssertionError(f"the SIGTERM'd run failed: "
                                 f"{stderr[-2000:]}")
        first = json.loads(stdout.strip().splitlines()[-1])
        if not first.get("preempted") or first["epochs"] != 1:
            raise AssertionError(f"the SIGTERM'd run did not stop after "
                                 f"epoch 1: {first}")
        second = trainer_cli(*common, "--checkpoint-dir", killed, "--resume",
                             "--quiet")
        return [f"[{tag}] SIGTERM during epoch 1: {first}",
                f"[{tag}] --resume: {second}"]

    def early_stopped_and_served():
        emotion = os.path.join(root, "emotion")
        summary = trainer_cli("--preset", "emotion", "--synthetic",
                              "--epochs", "60", "--steps", "1",
                              "--checkpoint-dir", emotion,
                              "--checkpoint-every", "5", "--quiet")
        out["emotion_epochs"] = summary["epochs"]
        served = run_cli("cnn_pde_tpu_torch.serve", "emotion",
                         "--checkpoint-dir", emotion, "--tag", "last")
        if not served["restored"] or len(served["predictions"]) != 8:
            raise AssertionError(f"serve from the checkpoint: {served}")
        return [f"[{tag}] emotion (eval every 5 epochs, early stop after 10 "
                f"evals without a better accuracy): {summary}",
                f"[{tag}] serve --checkpoint-dir (last): {served}"]
    return [uninterrupted, preempted_and_resumed, early_stopped_and_served]


def resumed_equal(tag, out, root):
    """The resumed run's final weights, BatchNorm statistics and step
    against the uninterrupted run's, bit for bit."""
    a, b = (torch.load(os.path.join(root, run, "last.ckpt"),
                       weights_only=True) for run in ("whole", "killed"))
    diff = max(float((a["model"][n].double() - b["model"][n].double()).abs()
                     .max()) for n in a["model"])
    equal = a["step"] == b["step"] == 6 and all(
        torch.equal(a["model"][n], b["model"][n]) for n in a["model"])
    log(f"[{tag}] resumed vs uninterrupted: steps {a['step']} and "
        f"{b['step']}, largest weight difference {diff:.3e}, bit for bit "
        f"{equal}")
    if not equal:
        raise AssertionError("the resumed run's weights differ")
    out["resume_bitwise"] = equal


def phase_times(device, peak_bytes, peak_flops):
    result = times_fused(device, peak_bytes, peak_flops)
    result.update(times_thomas(device, peak_bytes, peak_flops))
    return result


def raw_fused(args, kw, u, g, res, y):
    """K2, K4 and K5 as callables that launch straight through their C entry
    points on outputs (and K5's partials scratch) allocated once, with the
    arguments and the launch plan the wrappers pass: K2 and K4 on u, K5 on
    the cotangent g, K4's residuals res and output y.  As ``raw_thomas``:
    for ``graph_ms``, on the stream current when they are made."""
    B, C, H, W = u.shape
    S = kw["ts"].shape[0]
    sms = torch.cuda.get_device_properties(u.device).multi_processor_count
    dtf = _dt_factors(kw["dt"], kw["dx"], kw["dy"], kw["splitting"])
    tail = (S, int(kw["splitting"] == "strang"), *dtf, kw["eps"],
            kw["cmax"], kernels.stream_handle(u.device))
    ptrs = [t.data_ptr() for t in (*args, kw["ts"])]
    fplan = plan_tiles(B, C, H, W, sms)
    bplan = bwd_plan(B, C, H, W, sms)
    fwd = bind_fused("fused_channel", "fused_channel_diffusion",
                     FWD_ARGTYPES, "fused_channel_layout", (C, H, W), fplan)
    bwd = bind_fused("fused_channel_vjp", "fused_channel_diffusion_bwd",
                     BWD_ARGTYPES, "fused_channel_bwd_layout", (C, H, W),
                     bplan)
    flayout = (fplan.grid, fplan.nbuf, fplan.staged)
    blayout = (bplan.grid, bplan.nbuf, bplan.staged)
    out, res_out, gu = (torch.empty_like(u), torch.empty_like(res),
                        torch.empty_like(u))
    grads = [torch.empty_like(a) for a in args]
    # held here, not only by address: freed, the memory would go to the
    # next tensor the caller allocates
    partials = torch.empty((bplan.grid, 4 * C * H * W + C * C),
                           device=u.device)

    def launch(name, fn, *ptr_args):
        code = fn(*ptr_args)
        kernels.raise_on_error(name, code)

    def k2():
        launch("K2", fwd, u.data_ptr(), out.data_ptr(), *ptrs, None, B, C, H,
               W, *flayout, *tail)
        return out

    def k4():
        launch("K4", fwd, u.data_ptr(), out.data_ptr(), *ptrs,
               res_out.data_ptr(), B, C, H, W, *flayout, *tail)
        return out, res_out

    def k5():
        launch("K5", bwd, g.data_ptr(), res.data_ptr(), y.data_ptr(), *ptrs,
               gu.data_ptr(), *(t.data_ptr() for t in grads),
               partials.data_ptr(), B, C, H, W, *blayout, *tail)
        return (gu, *grads)
    return k2, k4, k5


def times_fused(device, peak_bytes, peak_flops):
    """K2 at B = 1, 64 and 512 and K4 and K5 at B = 64 and 512, on the
    8-step Strang branch (3, 32, 32): device time by raw launches back to
    back in a CUDA graph (``graph_ms``; each launch's outputs held against
    the wrapper's), CUDA events around wrapper calls (host included), the
    plain version and the bound.  Returns each kernel's B = 512 figures,
    with the others under ``at_B1`` and ``at_B64``."""
    rng = np.random.default_rng(SEED + 3)
    C, H, W = 3, 32, 32
    band = C * H * W
    f = fields(rng, device)
    args = [f[k] for k in FIELD_KEYS]
    scale = SCALES[1]  # the 8-step branch, the longest
    S = scale["num_steps"]
    ts = torch.tensor(_substep_times_np(scale["dt"], S), dtype=torch.float32,
                      device=device)
    kw = dict(dt=scale["dt"], dx=scale["dx"], dy=scale["dy"], ts=ts,
              splitting="strang", eps=EPS, cmax=CMAX)
    out = {}
    for B in (1, 64, 512):
        elems = B * band
        u = torch.rand((B, C, H, W), device=device)
        g = torch.randn((B, C, H, W), device=device)
        y, res = fused_channel_fwd_res(u, *args, **kw)
        raw = raw_fused(args, kw, u, g, res, y)
        for name, got, want in (
                ("K2", raw[0](), fused_channel_diffusion_fwd(u, *args, **kw)),
                ("K4", raw[1](), (y, res)),
                ("K5", raw[2](), fused_channel_bwd(g, res, y, *args, **kw))):
            torch.cuda.synchronize()
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name} B={B}: raw launch and wrapper "
                                     "differ")
        # Per element of the state, step and image: mixing 2C, and per sweep
        # (three for Strang) elimination and back-substitution, 5.  Once per
        # (c, h, w), step and sweep, the same for every image: the
        # coefficient (fma, two clamps, ·dtf: 5), b (2) and the c* chain (3).
        k2_bound = bound(
            4 * (2 * elems + 4 * band + C * C + 3 * S),
            elems * S * (2 * C + 5 * 3) + band * S * 3 * 10,
            peak_bytes, peak_flops)
        # K2's work, and the S residual states written once more.
        k4_bound = bound(
            4 * ((2 + S) * elems + 4 * band + C * C + 3 * S),
            elems * S * (2 * C + 5 * 3) + band * S * 3 * 10,
            peak_bytes, peak_flops)
        # Reads g, the output and the S residuals, writes grad u; reads the
        # four fields and the mixing, writes their gradients.  Per element,
        # step and image: the recompute (mixing 2C, two sweeps 5 each), three
        # adjoint sweeps (solve 5, grad_r and its batch sum 7), the mixing
        # adjoint (2C for grad_mix, 2C for mixᵀ·cot): 6C + 46.  Once per
        # (c, h, w) and step: coefficient, bands and c* for the five solves
        # (10 each) and the clamp gate and accumulation of three (5 each).
        k5_bound = bound(
            4 * ((3 + S) * elems + 8 * band + 2 * C * C + 3 * S),
            elems * S * (6 * C + 46) + band * S * 65,
            peak_bytes, peak_flops)
        rows = [("K2", 0, lambda: fused_channel_diffusion_fwd(u, *args, **kw),
                 lambda: fused_channel_diffusion_plain(u, *args, **kw),
                 k2_bound)]
        if B > 1:
            rows += [
                ("K4", 1, lambda: fused_channel_fwd_res(u, *args, **kw),
                 lambda: fused_channel_fwd_res_plain(u, *args, **kw),
                 k4_bound),
                ("K5", 2, lambda: fused_channel_bwd(g, res, y, *args, **kw),
                 lambda: fused_channel_bwd_plain(g, res, y, *args, **kw),
                 k5_bound)]
        at = f"8-step Strang branch B={B} (3,32,32)"
        for name, i, call, plain, (b_ms, b_by) in rows:
            entry = dict(
                at=at,
                ms=graph_ms(lambda i=i: [raw_fused(args, kw, u, g, res,
                                                   y)[i]], walks=20),
                call_ms=time_ms(call),
                plain_ms=time_ms(plain, groups=5, per_group=1),
                bound_ms=b_ms, bound_by=b_by)
            log(f"[times] {name} {at}: kernel {entry['ms']:.4f} ms (a CUDA "
                f"graph of back-to-back launches), call "
                f"{entry['call_ms']:.4f} ms (events around wrapper calls, "
                f"host included), plain {entry['plain_ms']:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}); library: none (no PyTorch call "
                "computes the layer)")
            if B == 512:
                out.setdefault(name, {}).update(entry)
            else:
                out.setdefault(name, {})[f"at_B{B}"] = entry
    return out


COLD_BYTES = 128e6   # inputs rotated through, above the 50 MB L2 twice


def raw_thomas(fns, bands, dim, u, g, x):
    """K1 and K3 as callables that launch straight through the C entry
    points ``fns`` = (thomas_solve, thomas_adjoint, chunked) on outputs
    allocated once, with the arguments the wrappers pass; ``chunked``: the
    interface that takes the chunk (and K3 its partials scratch), sized by
    the wrappers' plan.  A wrapper call spends longer on the host than
    these kernels spend on the card, and at B = 64 and 128 so can a raw
    launch, so CUDA events around back-to-back calls time the host; in a
    CUDA graph (``graph_ms``) the raw launches run back to back on the
    card.  A callable launches on the stream current when it was made."""
    solve, adjoint, chunked = fns
    batch, p, n, q = _line_shape("raw", *bands, u, dim)
    out, lam = torch.empty_like(u), torch.empty_like(g)
    grads = [torch.empty_like(bands[0]) for _ in range(3)]
    stream = kernels.stream_handle(u.device)
    ptrs = [t.data_ptr() for t in bands]
    k1_extra, k3_extra, partials = [], [], []
    if chunked:
        sms = torch.cuda.get_device_properties(u.device).multi_processor_count
        k1_extra = [tridiag_plan(batch, p, n, q, sms)[0]]
        chunk, chunks, _ = tridiag_plan(batch, p, n, q, sms, 2)
        # k3 holds the scratch itself, not only its address: freed, its
        # memory would go to the next tensor the caller allocates
        k3_extra = [chunk]
        partials = [torch.empty((chunks, 3, *bands[0].shape),
                                device=u.device)]

    def k1():
        code = solve(*ptrs, u.data_ptr(), out.data_ptr(), batch, p, n, q,
                     *k1_extra, stream)
        kernels.raise_on_error("thomas_solve", code)
        return out

    def k3():
        code = adjoint(*ptrs, g.data_ptr(), x.data_ptr(), lam.data_ptr(),
                       *(t.data_ptr() for t in grads + partials), batch, p,
                       n, q, *k3_extra, stream)
        kernels.raise_on_error("thomas_adjoint", code)
        return (lam, *grads)
    return k1, k3


def this_thomas():
    """This checkout's K1 and K3 entry points, as the wrappers bind them."""
    return (bind_thomas("thomas_solve", _ARGTYPES),
            bind_thomas("thomas_adjoint", _ADJOINT_ARGTYPES), True)


def graph_ms(make, walks=100, groups=10):
    """Mean time of one call in the replay of a CUDA graph of ``walks``
    walks through the calls ``make()`` returns, by CUDA events, median over
    ``groups`` replays: back-to-back launches with no host time between
    them.  ``make`` binds its calls to the current stream, so it is called
    again inside the capture."""
    for call in make():
        call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        calls = make()
        for _ in range(walks):
            for call in calls:
                call()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / (walks * len(calls)))
    return statistics.median(times)


def cold_sets(inputs):
    """Copies of ``inputs`` that total at least COLD_BYTES, so that a walk
    through them reads every input after it has left the L2."""
    size = sum(t.numel() * t.element_size() for t in inputs)
    return [tuple(t.clone() for t in inputs)
            for _ in range(max(2, int(np.ceil(COLD_BYTES / size))))]


def dense_system(bands, rhs, dim):
    """The library yardstick's operands: T (lines, N, N), dense from the
    bands, and the right-hand sides (lines, N, batch), the batch as
    columns; a line is one (p, q) of the bands."""
    a, b, c = (t.movedim(dim, -1).reshape(-1, t.shape[dim]) for t in bands)
    T = (torch.diag_embed(b) + torch.diag_embed(a[:, 1:], -1)
         + torch.diag_embed(c[:, :-1], 1))
    D = rhs.movedim(dim, -1).reshape(rhs.shape[0], *T.shape[:2])
    return T.contiguous(), D.permute(1, 2, 0).contiguous()


def thomas_shapes(device):
    """(label, bands, dim, batch) of the main path's K1 and K3 launches:
    the flagship's x- and y-sweeps (5-step branch, (3, 32, 32)) at B = 64
    and 512, and the mnist layer's smoothed sweeps (28, 28) at B = 128
    and 1024."""
    rng = np.random.default_rng(SEED + 12)
    f = fields(rng, device)
    scale = SCALES[0]
    alpha = _coeff_at(f["alpha_base"], f["alpha_time_coeff"], 0.0, EPS, CMAX)
    gf = gray_fields(rng, device, "mnist")
    dt, steps, _ = GRAY_LAYERS["mnist"]
    t_last = float(_substep_times_np(dt, steps)[-1, 2])
    shapes = []
    for B in (64, 512):
        for dim, label in ((-1, "x"), (-2, "y")):
            shapes.append((f"flagship {label}-sweep B={B} (3,32,32)",
                           sweep_bands(alpha, scale["dt"] / 2, scale["dx"],
                                       dim), dim, B))
    for B in (128, 1024):
        for dim, key, dtf, label in ((-1, "alpha", dt / 2, "x"),
                                     (-2, "beta", dt, "y")):
            field = _coeff_at(gf[f"{key}_base"], gf[f"{key}_time_coeff"],
                              t_last, EPS)
            shapes.append((f"mnist smoothed {label}-sweep B={B} (28,28)",
                           sweep_bands(smooth3(field, dim), dtf, 1.0, dim),
                           dim, B))
    return shapes


def times_thomas(device, peak_bytes, peak_flops):
    """K1 and K3 at each shape of ``thomas_shapes``, launched back to back
    through their C entry points (``raw_thomas``) in a CUDA graph timed by
    CUDA events around its replay (``graph_ms``): L2-warm (the same inputs,
    100 launches) and cold (5 walks through ``cold_sets``), with the
    wrapper's call time (events around
    wrapper calls, host included), beside the plain version, the least
    time the card could take (device memory, whatever the L2 does) and
    the library yardstick, one torch.linalg.solve on the dense system with
    the batch as columns (for K3 the λ solve on Tᵀ; the band sums are not
    in it).  The port never calls the library.  Returns the K1 and K3
    rows, headed by the flagship x-sweep at B = 512 with every shape under
    ``shapes``."""
    rows = {"K1": [], "K3": []}
    fns = this_thomas()
    for at, bands, dim, B in thomas_shapes(device):
        shape = tuple(bands[0].shape)
        band = int(np.prod(shape))
        elems = B * band
        u = torch.rand((B, *shape), device=device)
        g = torch.randn((B, *shape), device=device)
        x = tridiag_solve(*bands, u, dim)
        cold = cold_sets((u, g, x))
        T, D = dense_system(bands, u, dim)
        Tt, G = T.transpose(-1, -2).contiguous(), dense_system(bands, g, dim)[1]
        # K1 reads d and writes x once, reads the bands once; per element
        # the Thomas recurrence's 5 flops, per band element its c* chain (3).
        k1_bound = bound(4 * (2 * elems + 3 * band), 5 * elems + 3 * band,
                         peak_bytes, peak_flops)
        # K3 reads g and x and writes λ once, reads the bands and writes
        # their gradients once; per element the adjoint recurrence (5) and
        # the three band products summed over the batch (6).
        k3_bound = bound(4 * (3 * elems + 6 * band), 11 * elems + 3 * band,
                         peak_bytes, peak_flops)
        for i, (key, call, plain, lib, (b_ms, b_by)) in enumerate((
                ("K1", lambda: tridiag_solve(*bands, u, dim),
                 lambda: tridiag_solve_plain(*bands, u, dim),
                 lambda: torch.linalg.solve(T, D), k1_bound),
                ("K3", lambda: tridiag_adjoint(*bands, g, x, dim),
                 lambda: tridiag_adjoint_plain(*bands, g, x, dim),
                 lambda: torch.linalg.solve(Tt, G), k3_bound))):
            entry = dict(
                at=at,
                ms=graph_ms(lambda i=i: [
                    raw_thomas(fns, bands, dim, u, g, x)[i]]),
                cold_ms=graph_ms(lambda i=i: [
                    raw_thomas(fns, bands, dim, *inputs)[i]
                    for inputs in cold], walks=5),
                call_ms=time_ms(call),
                plain_ms=time_ms(plain, groups=10, per_group=2),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(lib, groups=10, per_group=20))
            rows[key].append(entry)
            log(f"[times] {key} {at}: kernel {entry['ms']:.4f} ms L2-warm, "
                f"{entry['cold_ms']:.4f} ms cold (a CUDA graph of "
                "back-to-back launches); "
                f"call {entry['call_ms']:.4f} ms (wrapper, host included); "
                f"plain {entry['plain_ms']:.4f} ms; bound {b_ms:.4f} ms "
                f"({b_by}, device memory); library torch.linalg.solve "
                f"{entry['library_ms']:.4f} ms"
                + (" (the λ solve on Tᵀ alone, no band sums)"
                   if key == "K3" else ""))
    head = "flagship x-sweep B=512 (3,32,32)"
    return {key: dict(next(e for e in entries if e["at"] == head),
                      shapes=entries)
            for key, entries in rows.items()}


def raw_gray(args, kw, u, g, res, y):
    """K6, K7 and K8 as callables that launch straight through their C entry
    points on outputs and scratch (the factor table, K8's partials)
    allocated once, with the arguments and the launch plan the wrappers
    pass: K6 and K7 on u, K8 on the cotangent g, K7's residuals res and
    output y.  As ``raw_thomas``: for ``graph_ms``, on the stream current
    when they are made."""
    B, H, W = u.shape
    S = kw["ts"].shape[0]
    sms = torch.cuda.get_device_properties(u.device).multi_processor_count
    dtf = _dt_factors(kw["dt"], kw["dx"], kw["dy"], "strang")
    tail = (*dtf, kw["eps"], kernels.stream_handle(u.device))
    ptrs = [t.data_ptr() for t in (*args, kw["ts"])]
    fplan = plan_grayscale(B, H, W, sms)
    bplan = plan_grayscale(B, H, W, sms, backward=True)
    fwd = bind_gray("fused_grayscale", "fused_grayscale_diffusion",
                    GRAY_ARGTYPES, "fused_grayscale_layout", (H, W), fplan)
    bwd = bind_gray("fused_grayscale_vjp", "fused_grayscale_diffusion_bwd",
                    GRAY_BWD_ARGTYPES, "fused_grayscale_bwd_layout", (H, W),
                    bplan)
    out, res_out, gu = (torch.empty_like(u), torch.empty_like(res),
                        torch.empty_like(u))
    grads = [torch.empty_like(a) for a in args]
    # held here, not only by address (see raw_fused)
    ftable = factor_table(fplan, S, u.device)
    btable = factor_table(bplan, S, u.device)
    partials = torch.empty((bplan.grid, 4 * H * W), device=u.device)

    def launch(name, fn, *ptr_args):
        kernels.raise_on_error(name, fn(*ptr_args))

    def k6():
        launch("K6", fwd, u.data_ptr(), out.data_ptr(), *ptrs, None,
               ftable.data_ptr(), B, H, W, fplan.grid, S, *tail)
        return out

    def k7():
        launch("K7", fwd, u.data_ptr(), out.data_ptr(), *ptrs,
               res_out.data_ptr(), ftable.data_ptr(), B, H, W, fplan.grid,
               S, *tail)
        return out, res_out

    def k8():
        launch("K8", bwd, g.data_ptr(), res.data_ptr(), y.data_ptr(), *ptrs,
               gu.data_ptr(), *(t.data_ptr() for t in grads),
               btable.data_ptr(), partials.data_ptr(), B, H, W, bplan.grid,
               S, *tail)
        return (gu, *grads)
    return k6, k7, k8


def times_grayscale(device, peak_bytes, peak_flops):
    """K6 at B = 1, 128 and 1024 and K7 and K8 at B = 128 and 1024 on the
    mnist layer (10 Strang steps, 28 x 28), and K6 on the fashion_mnist
    layer (4 steps) at B = 1, 128 and 1024: device time by raw launches back
    to back in a CUDA graph (``graph_ms``; each launch's outputs held
    against the wrapper's), CUDA events around wrapper calls (host
    included), the plain version and the bound.  Returns each kernel's
    mnist B = 1024 figures, with the others under ``at_B1``, ``at_B128``
    and ``fashion_mnist_at_B<B>``."""
    rng = np.random.default_rng(SEED + 10)
    out = {}
    for preset in ("mnist", "fashion_mnist"):
        f = gray_fields(rng, device, preset)
        args = [f[k] for k in GRAY_KEYS]
        kw = gray_kwargs(preset, device)
        S = kw["ts"].shape[0]
        field = 28 * 28
        for B in (1, 128, 1024):
            elems = B * field
            u = torch.rand((B, 28, 28), device=device)
            g = torch.randn_like(u)
            y, res = fused_grayscale_fwd_res(u, *args, **kw)
            raw = raw_gray(args, kw, u, g, res, y)
            for name, got, want in (
                    ("K6", raw[0](),
                     fused_grayscale_diffusion_fwd(u, *args, **kw)),
                    ("K7", raw[1](), (y, res)),
                    ("K8", raw[2](),
                     fused_grayscale_bwd(g, res, y, *args, **kw))):
                torch.cuda.synchronize()
                want = want if isinstance(want, tuple) else (want,)
                got = got if isinstance(got, tuple) else (got,)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{name} {preset} B={B}: raw launch "
                                         "and wrapper differ")
            # K6 reads u, the four fields and ts and writes the output once.
            # Per element, step and image: three sweeps of elimination and
            # back-substitution, 5 each.  Once per (h, w), step and sweep,
            # the same for every image: the coefficient (fma, max: 2), its
            # 3-tap smoothing (5), ·dtf (1), b (2) and the c* chain (3): 13.
            k6_bound = bound(4 * (2 * elems + 4 * field + 3 * S),
                             elems * S * 15 + field * S * 3 * 13,
                             peak_bytes, peak_flops)
            # K7: K6's work and the S residual states written once more.
            k7_bound = bound(4 * ((2 + S) * elems + 4 * field + 3 * S),
                             elems * S * 15 + field * S * 3 * 13,
                             peak_bytes, peak_flops)
            # K8 reads g, the output and the S residuals and writes grad u,
            # reads the four fields and writes their gradients.  Per
            # element, step and image: two recompute sweeps (5 each), three
            # adjoint solves (5 each) and three grad_r folds with their
            # batch sum (7 each): 46.  Once per (h, w) and step: the bands
            # of the five solves (13 each) and, for the three adjoints,
            # ·dtf, the smooth3 adjoint, the gate and the two accumulations
            # (10 each): 95.
            k8_bound = bound(4 * ((3 + S) * elems + 8 * field + 3 * S),
                             elems * S * 46 + field * S * 95,
                             peak_bytes, peak_flops)
            rows = [("K6", 0, lambda: fused_grayscale_diffusion_fwd(
                        u, *args, **kw),
                     lambda: fused_grayscale_diffusion_plain(u, *args, **kw),
                     k6_bound, 10)]
            if preset == "mnist" and B > 1:
                rows += [
                    ("K7", 1, lambda: fused_grayscale_fwd_res(u, *args, **kw),
                     lambda: fused_grayscale_fwd_res_plain(u, *args, **kw),
                     k7_bound, 10),
                    ("K8", 2, lambda: fused_grayscale_bwd(g, res, y, *args,
                                                          **kw),
                     lambda: fused_grayscale_bwd_plain(g, res, y, *args,
                                                       **kw),
                     k8_bound, 5)]
            at = f"{preset} layer, {S} steps, B={B} (28,28)"
            for name, i, call, plain, (b_ms, b_by), plain_groups in rows:
                entry = dict(
                    at=at,
                    ms=graph_ms(lambda i=i: [raw_gray(args, kw, u, g, res,
                                                      y)[i]], walks=20),
                    call_ms=time_ms(call),
                    plain_ms=time_ms(plain, groups=plain_groups,
                                     per_group=1),
                    bound_ms=b_ms, bound_by=b_by)
                log(f"[times] {name} {at}: kernel {entry['ms']:.4f} ms (a "
                    f"CUDA graph of back-to-back launches), call "
                    f"{entry['call_ms']:.4f} ms (events around wrapper "
                    f"calls, host included), plain {entry['plain_ms']:.4f} "
                    f"ms, bound {b_ms:.4f} ms ({b_by}); library: none (no "
                    "PyTorch call computes the layer)")
                if preset == "fashion_mnist":
                    out.setdefault(name, {})[f"fashion_mnist_at_B{B}"] = entry
                elif B == 1024:
                    out.setdefault(name, {}).update(entry)
                else:
                    out.setdefault(name, {})[f"at_B{B}"] = entry
    return out


KERNELS = [
    ("K1", "tridiag_solve", "cnn_pde_tpu_torch/csrc/thomas.cu",
     "cnn_pde_tpu/ops/pallas_thomas.py:70"),
    ("K2", "fused_channel_diffusion_fwd",
     "cnn_pde_tpu_torch/csrc/fused_channel.cu",
     "cnn_pde_tpu/ops/pallas_fused_channel.py:102"),
    ("K3", "tridiag_adjoint", "cnn_pde_tpu_torch/csrc/thomas.cu",
     "cnn_pde_tpu/ops/pallas_thomas.py:109"),
    ("K4", "fused_channel_fwd_res", "cnn_pde_tpu_torch/csrc/fused_channel.cu",
     "cnn_pde_tpu/ops/pallas_fused_channel_vjp.py:195"),
    ("K5", "fused_channel_bwd", "cnn_pde_tpu_torch/csrc/fused_channel_vjp.cu",
     "cnn_pde_tpu/ops/pallas_fused_channel_vjp.py:233"),
    ("K6", "fused_grayscale_diffusion_fwd",
     "cnn_pde_tpu_torch/csrc/fused_grayscale.cu",
     "cnn_pde_tpu/ops/pallas_fused_adi.py:119"),
    ("K7", "fused_grayscale_fwd_res",
     "cnn_pde_tpu_torch/csrc/fused_grayscale.cu",
     "cnn_pde_tpu/ops/pallas_fused_adi_vjp.py:196"),
    ("K8", "fused_grayscale_bwd",
     "cnn_pde_tpu_torch/csrc/fused_grayscale_vjp.cu",
     "cnn_pde_tpu/ops/pallas_fused_adi_vjp.py:228"),
]


# the kernels registered as torch.library ops (the ones an eval forward
# reaches, so that torch.export can trace it)
OPS = {"K1": "cnn_pde_tpu_torch::thomas_solve",
       "K2": "cnn_pde_tpu_torch::fused_channel_fwd",
       "K6": "cnn_pde_tpu_torch::fused_grayscale_fwd"}


def timed(label, fn, *args):
    """``fn(*args)``, logging its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[time] {label}: {time.perf_counter() - t0:.1f} s")
    return out


def main():
    name, card = phase_device()
    torch.manual_seed(SEED)
    peak_bytes, peak_flops = card_peaks(name)
    device = torch.device("cuda", 0)
    timed("build", phase_build)
    errs = timed("kernels", phase_kernels, device)
    gray_errs = timed("grayscale kernels", phase_gray_kernels, device)
    errs["K1"] = max(errs["K1"], gray_errs.pop("K1"))
    k3 = gray_errs.pop("K3")
    errs["K3"] = (max(errs["K3"][0], k3[0]), max(errs["K3"][1], k3[1]))
    errs.update(gray_errs)
    operator_build = timed("operator build", phase_amp_kernels, device,
                           peak_bytes, peak_flops)
    serve_launches, serve_rates = timed("flagship serving", phase_slice,
                                        device)
    timed("flagship profile", phase_profile, device)
    train_launches, train_rates, losses = timed("flagship training",
                                                phase_train, device)
    ((gray_serve, gray_serve_rates), (gray_train, gray_train_rates,
                                      gray_losses), fashion_serve,
     fashion_train) = timed("grayscale family", phase_grayscale, device)
    amp = timed("AMP grade and SVHN", phase_amp, device)
    stencil = timed("emotion and Tiny-ImageNet", phase_stencil, device)
    tiny = stencil["tiny_imagenet"]
    hybrid = timed("hybrid", phase_hybrid, device, peak_bytes, peak_flops)
    hybrid_steps = {grade: hybrid["train"][grade]["launches_per_train_step"]
                    for grade in ("bf16", "amp")}
    device_epoch = timed("device epoch", phase_device_epoch, device)
    serving = timed("serving", phase_serving, device)
    times = timed("kernel times", phase_times, device, peak_bytes,
                  peak_flops)
    times.update(timed("grayscale kernel times", times_grayscale, device,
                       peak_bytes, peak_flops))
    trainer = timed("CLIs and trainer", phase_clis)
    log(f"[memory] peak allocated {torch.cuda.max_memory_allocated() / 2**20:.1f}"
        " MiB")
    # launches: K1 and K2 over the flagship's serving run (3 forwards a
    # configuration), K3-K5 over one flagship train step, K6 over the mnist
    # serving run (3 forwards), K7 and K8 over one mnist train step; the
    # per-forward and per-step counts of both families beside
    launches = {"K1": serve_launches["per_sweep"]["K1"],
                "K2": serve_launches["fused"]["K2"],
                "K3": train_launches["per_sweep"]["K3"],
                "K4": train_launches["fused"]["K4"],
                "K5": train_launches["fused"]["K5"],
                "K6": gray_serve["fused"]["K6"],
                "K7": gray_train["fused"]["K7"],
                "K8": gray_train["fused"]["K8"]}
    per = {"K1": {"launches_per_forward": 51,
                  "launches_per_train_step": train_launches["per_sweep"]["K1"],
                  "mnist_launches_per_forward": 30,
                  "mnist_launches_per_train_step":
                      gray_train["per_sweep"]["K1"],
                  "svhn_launches_per_train_step":
                      amp["svhn_train"][0]["per_sweep"]["K1"],
                  "tiny_imagenet_implicit_launches_per_forward":
                      tiny["implicit_serve"][0]["implicit"]["K1"] // 3,
                  "tiny_imagenet_implicit_launches_per_train_step":
                      tiny["implicit_train"][0]["implicit"]["K1"],
                  "hybrid_launches_per_forward":
                      hybrid["serve"]["bf16"]["launches_per_forward"],
                  "hybrid_launches_per_train_step":
                      hybrid_steps["bf16"]["K1"],
                  "hoisted_launches_per_train_step": {
                      "flagship": amp["flagship_train"]["bf16"][0]["K1"],
                      "mnist": amp["mnist_train"]["bf16"][0]["K1"],
                      "svhn": amp["svhn_amp_train"]["bf16"][0]["K1"],
                      "hybrid": hybrid_steps["amp"]["K1"]},
                  "hoisted_launches_per_cache": {
                      "flagship": amp["flagship_serve"]["bf16"][0]["K1"],
                      "mnist": amp["mnist_serve"]["bf16"][0]["K1"],
                      "svhn": amp["svhn_amp_serve"]["bf16"][0]["K1"],
                      "hybrid": hybrid["serve"]["amp"]["cache_launches"]},
                  "operator_build": operator_build},
           "K2": {"launches_per_forward": 3},
           "K3": {"launches_per_train_step": 51,
                  "mnist_launches_per_train_step":
                      gray_train["per_sweep"]["K3"],
                  "svhn_launches_per_train_step":
                      amp["svhn_train"][0]["per_sweep"]["K3"],
                  "tiny_imagenet_implicit_launches_per_train_step":
                      tiny["implicit_train"][0]["implicit"]["K3"],
                  "hybrid_launches_per_train_step":
                      hybrid_steps["bf16"]["K3"]},
           "K4": {"launches_per_train_step": 3},
           "K5": {"launches_per_train_step": 3},
           "K6": {"mnist_launches_per_forward": 1},
           "K7": {"mnist_launches_per_train_step": 1},
           "K8": {"mnist_launches_per_train_step": 1}}
    # this slice's paths: a captured predict's launches at warm-up and
    # capture (three forwards a bucket, three buckets), and the
    # linearize basis (each layer's forward once at B = D)
    captured = serving["captured"]
    linearized = serving["linearized"]
    per["K1"]["captured_serve_launches"] = {
        "flagship": captured["flagship_per_sweep"]["launches_at_capture"]
        ["K1"], "mnist": captured["mnist_per_sweep"]["launches_at_capture"]
        ["K1"]}
    per["K1"]["linearize_basis_launches"] = linearized[
        "flagship_per_sweep"]["basis_launches"]["K1"]
    per["K2"]["captured_serve_launches"] = captured["flagship_fused"][
        "launches_at_capture"]["K2"]
    per["K2"]["linearize_basis_launches"] = linearized["flagship_fused"][
        "basis_launches"]["K2"]
    per["K6"]["captured_serve_launches"] = captured["mnist_fused"][
        "launches_at_capture"]["K6"]
    per["K6"]["linearize_basis_launches"] = linearized["mnist_fused"][
        "basis_launches"]["K6"]
    rows = []
    for key, fn, source, replaces in KERNELS:
        err = errs[key]
        row = {"name": f"{fn} ({key})", "route": "cuda", "source": source,
               "replaces": replaces, "op": OPS.get(key),
               "launches": launches[key],
               "max_abs_err": err[0] if isinstance(err, tuple) else err}
        if isinstance(err, tuple):
            row["max_rel_err_grads"] = err[1]
        row.update(times[key])
        row.setdefault("library_ms", None)
        row.update(per[key])
        rows.append(row)
    result = {"kernels": rows, "serve_images_per_s": serve_rates,
              "train_images_per_s": train_rates,
              "train_loss_50_steps": losses,
              "mnist_serve_images_per_s": gray_serve_rates,
              "mnist_train_images_per_s": gray_train_rates,
              "mnist_train_loss_50_steps": gray_losses,
              "fashion_mnist_serve_images_per_s": fashion_serve[1],
              "fashion_mnist_train_images_per_s": fashion_train[1],
              "fashion_mnist_train_loss_50_steps": fashion_train[2],
              "svhn_serve_images_per_s": amp["svhn_serve"][1],
              "svhn_train_images_per_s": amp["svhn_train"][1],
              "svhn_train_loss_50_steps": amp["svhn_train"][2],
              "emotion": stencil["emotion"],
              "tiny_imagenet": {key: value for key, value in tiny.items()
                                if key not in ("implicit_serve",
                                               "implicit_train")},
              "tiny_imagenet_implicit_serve_images_per_s":
                  tiny["implicit_serve"][1],
              "tiny_imagenet_implicit_train_images_per_s":
                  tiny["implicit_train"][1],
              "hybrid": hybrid, "trainer": trainer,
              "device_epoch": device_epoch,
              "serving": serving,
              "amp_gemm_route": gemm_route(torch.bfloat16, device),
              "amp": {key: {grade: value[1]
                            for grade, value in amp[key].items()}
                      for key in ("flagship_serve", "flagship_train",
                                  "mnist_serve", "mnist_train",
                                  "svhn_amp_serve", "svhn_amp_train")}}
    log(f"card: {card}")
    log(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": len(USED_DEVICES)}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
