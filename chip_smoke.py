#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one GPU and hold its kernels
against their plain versions.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. device: the card's name and power limit from nvidia-smi; TF32 off;
2. build: K1 (csrc/thomas.cu) and K2 (csrc/fused_channel.cu) with nvcc;
3. each kernel against its plain PyTorch version on the card, at the
   flagship's shapes (K1: x- and y-sweeps of the three branch scales at
   B in {1, 7, 512}, plus lines of 1, 2 and 3; K2: the three branches,
   Strang and Lie, at B in {1, 7, 512});
4. the slice: ``make_predict_fn`` on the CIFAR-10 flagship (weights from a
   seed) in the per-sweep and the fused configuration at B in {1, 64, 1024},
   logits held against the same model on its plain versions, launch counts
   read around that run, then images/s; then the serve CLI on cuda;
5. the device's busy share of a served forward (torch.profiler);
6. times at B = 512: each kernel and its plain version (CUDA events, median
   of 20 groups), beside the least time the card could take;
7. the ``kernels`` JSON line, then the contract line.

Exits non-zero without a result when CUDA is unavailable.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from cnn_pde_tpu_torch.models import build_model
from cnn_pde_tpu_torch.models.cifar10_noconv import MultiScaleExtractor
from cnn_pde_tpu_torch.ops import kernels
from cnn_pde_tpu_torch.ops.adi import _neumann_b
from cnn_pde_tpu_torch.ops.fused_channel import (
    fused_channel_diffusion_fwd, fused_channel_diffusion_plain)
from cnn_pde_tpu_torch.ops.tridiag import tridiag_solve, tridiag_solve_plain
from cnn_pde_tpu_torch.pde.diffusion import _coeff_at, _substep_times_np
from cnn_pde_tpu_torch.serve import make_predict_fn

SEED = 0
EPS = 1e-6
CMAX = 10.0
KERNEL_TOL = 1e-5   # same recurrence (K1) or same system (K2), fma order
LOGIT_TOL = 1e-4    # the JAX package's full-model bound
SCALES = MultiScaleExtractor.SCALES
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


def fields(rng, device, C=3, S=32):
    """Trained-looking coefficient fields: bases 1 ± 0.5, time coefficients
    5·N(0, 1), mixing I + 0.05·N(0, 1)."""
    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=device)
    return {
        "alpha_base": t(1.0 + 0.5 * rng.standard_normal((C, S, S))),
        "alpha_time_coeff": t(5.0 * rng.standard_normal((C, S, S))),
        "beta_base": t(1.0 + 0.5 * rng.standard_normal((C, S, S))),
        "beta_time_coeff": t(5.0 * rng.standard_normal((C, S, S))),
        "channel_mixing": t(np.eye(C) + 0.05 * rng.standard_normal((C, C))),
    }


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


def reset_counts():
    tridiag_solve.launches = 0
    fused_channel_diffusion_fwd.launches = 0


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


def phase_build():
    t0 = time.perf_counter()
    paths = kernels.build()
    log(f"[build] nvcc {' '.join(kernels.NVCC_FLAGS)}: "
        f"{', '.join(p.name for p in paths.values())} in "
        f"{time.perf_counter() - t0:.1f} s")


def phase_kernels(device):
    rng = np.random.default_rng(SEED)
    log("[kernels] K1 tridiag_solve against tridiag_solve_plain")
    k1_err = 0.0
    for scale in SCALES:
        f = fields(rng, device)
        ts = _substep_times_np(scale["dt"], scale["num_steps"])
        alpha = _coeff_at(f["alpha_base"], f["alpha_time_coeff"],
                          float(ts[-1, 2]), EPS, CMAX)
        beta = _coeff_at(f["beta_base"], f["beta_time_coeff"],
                         float(ts[-1, 1]), EPS, CMAX)
        for B in (1, 7, 512):
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
    for n in (1, 2, 3):
        for dim, shape in ((-1, (3, 5, n)), (-2, (3, n, 5))):
            r = torch.rand(shape, device=device) * 2.0
            bands = (-r, (_neumann_b(r, dim) + EPS).contiguous(), -r)
            u = torch.rand((7, *shape), device=device)
            out = tridiag_solve(*bands, u, dim)
            torch.cuda.synchronize()
            k1_err = max(k1_err, check(
                f"N={n} dim={dim}", max_err(out, tridiag_solve_plain(
                    *bands, u, dim)), KERNEL_TOL))

    log("[kernels] K2 fused_channel_diffusion_fwd against its plain version")
    k2_err = 0.0
    for scale in SCALES:
        f = fields(rng, device)
        args = [f[k] for k in ("alpha_base", "alpha_time_coeff", "beta_base",
                               "beta_time_coeff", "channel_mixing")]
        ts = torch.tensor(_substep_times_np(scale["dt"], scale["num_steps"]),
                          dtype=torch.float32, device=device)
        for splitting in ("strang", "lie"):
            kw = dict(dt=scale["dt"], dx=scale["dx"], dy=scale["dy"], ts=ts,
                      splitting=splitting, eps=EPS, cmax=CMAX)
            for B in (1, 7, 512):
                u = torch.rand((B, 3, 32, 32), device=device)
                out = fused_channel_diffusion_fwd(u, *args, **kw)
                torch.cuda.synchronize()
                ref = fused_channel_diffusion_plain(u, *args, **kw)
                k2_err = max(k2_err, check(
                    f"steps={scale['num_steps']} dx={scale['dx']} "
                    f"{splitting} B={B}", max_err(out, ref), KERNEL_TOL))
    return k1_err, k2_err


def flagship(device, fused):
    """The flagship with init from a seeded generator and its PDE fields
    replaced by seeded trained-looking ones, so the clamps and the time
    bookkeeping are exercised."""
    model = build_model("cifar10_noconv", device=device,
                        generator=torch.Generator().manual_seed(SEED),
                        fused_inference=fused)
    rng = np.random.default_rng(SEED + 1)
    with torch.no_grad():
        for i in (1, 2, 3):
            pde = getattr(model.feature_extractor, f"pde{i}")
            for key, value in fields(rng, device).items():
                getattr(pde, key).copy_(value)
    return model


def phase_slice(device):
    rng = np.random.default_rng(SEED + 2)
    batches = (1, 64, 1024)
    images = {B: rng.random((B, 3, 32, 32)).astype(np.float32)
              for B in batches}
    expected = {"per_sweep": (51, 0), "fused": (0, 3)}
    launches, rates = {}, {}
    for config, (k1_per, k2_per) in expected.items():
        predict = make_predict_fn(flagship(device, config == "fused"),
                                  output="logits")
        reset_counts()
        logits = {B: predict(images[B]) for B in batches}
        torch.cuda.synchronize()
        counts = (tridiag_solve.launches, fused_channel_diffusion_fwd.launches)
        log(f"[slice] {config}: K1 launches {counts[0]}, K2 launches "
            f"{counts[1]} over {len(batches)} forwards")
        if counts != (k1_per * len(batches), k2_per * len(batches)):
            raise AssertionError(f"{config}: expected {k1_per} K1 and "
                                 f"{k2_per} K2 launches a forward")
        launches[config] = counts
        with kernels.plain_versions():
            plain = {B: predict(images[B]) for B in batches}
        for B in batches:
            out = logits[B]
            if out.shape != (B, 10) or not torch.isfinite(out).all():
                raise AssertionError(f"{config} B={B}: bad logits {out.shape}")
            check(f"{config} B={B} logits vs plain versions",
                  max_err(out, plain[B]), LOGIT_TOL)
            if not torch.equal(out.argmax(-1), plain[B].argmax(-1)):
                raise AssertionError(f"{config} B={B}: labels differ")
        for B in batches:
            x = torch.from_numpy(images[B]).to(device)
            reps = {1: 30, 64: 20, 1024: 5}[B]
            predict(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                predict(x)
            torch.cuda.synchronize()
            rate = B * reps / (time.perf_counter() - t0)
            rates[f"{config}_B{B}"] = rate
            log(f"[slice] {config} B={B}: {rate:.1f} images/s "
                f"(host clock, {reps} requests after one warm-up)")
    cli = subprocess.run(
        [sys.executable, "-m", "cnn_pde_tpu_torch.serve", "--preset",
         "cifar10_noconv"], capture_output=True, text=True, timeout=300,
        check=True, cwd=os.path.dirname(os.path.abspath(__file__)))
    summary = json.loads(cli.stdout.strip().splitlines()[-1])
    if len(summary["predictions"]) != 8:
        raise AssertionError(f"serve CLI on cuda: {summary}")
    log(f"[slice] python -m cnn_pde_tpu_torch.serve (default device cuda): "
        f"{summary}")
    return launches, rates


def phase_profile(device):
    """Device busy share of a served forward: the time of the device's own
    events (kernels and copies, not the PyTorch ops that launched them),
    summed by torch.profiler over the host-clock wall time of 5 requests."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 4)
    for config in ("per_sweep", "fused"):
        predict = make_predict_fn(flagship(device, config == "fused"))
        for B in (1, 1024):
            x = torch.from_numpy(
                rng.random((B, 3, 32, 32)).astype(np.float32)).to(device)
            predict(x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(5):
                    predict(x)
                torch.cuda.synchronize()
                wall_us = 1e6 * (time.perf_counter() - t0)
            by_name = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    by_name[e.name] = (by_name.get(e.name, 0.0)
                                       + e.time_range.elapsed_us())
            device_us = sum(by_name.values())
            if device_us <= 0:
                log(f"[profile] {config} B={B}: device time not measured "
                    "(the profiler recorded no kernel)")
                continue
            top = sorted(by_name.items(), key=lambda r: -r[1])[:3]
            log(f"[profile] {config} B={B}: device busy "
                f"{100 * device_us / wall_us:.1f}% of {wall_us / 5:.0f} us "
                "a request (profiler on); top kernels: " + "; ".join(
                    f"{k[:48]} {100 * t / device_us:.0f}%" for k, t in top))


def phase_times(device, peak_bytes, peak_flops):
    rng = np.random.default_rng(SEED + 3)
    B, C, H, W = 512, 3, 32, 32
    elems = B * C * H * W
    u = torch.rand((B, C, H, W), device=device)
    f = fields(rng, device)
    scale = SCALES[0]
    alpha = _coeff_at(f["alpha_base"], f["alpha_time_coeff"], 0.0, EPS, CMAX)
    times = {}
    for dim, label in ((-1, "x"), (-2, "y")):
        bands = sweep_bands(alpha, scale["dt"] / 2, scale["dx"], dim)
        times[label] = (time_ms(lambda: tridiag_solve(*bands, u, dim)),
                        time_ms(lambda: tridiag_solve_plain(*bands, u, dim),
                                groups=20, per_group=2))
    # Work counted once where it is the same for every image: the c* chain
    # of the batch-free bands (3 flops a band element).  Per element of d:
    # elimination (3) and back-substitution (2).
    band = C * H * W
    k1_bound, k1_by = bound(4 * (2 * elems + 3 * band),
                            5 * elems + 3 * band, peak_bytes, peak_flops)
    for label, (ms, plain_ms) in times.items():
        log(f"[times] K1 {label}-sweep B={B} (3,32,32): kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {k1_bound:.4f} ms ({k1_by}); "
            "library: none (no PyTorch call solves a batched tridiagonal "
            "system)")

    scale = SCALES[1]  # the 8-step branch, the longest
    S = scale["num_steps"]
    ts = torch.tensor(_substep_times_np(scale["dt"], S), dtype=torch.float32,
                      device=device)
    args = [f[k] for k in ("alpha_base", "alpha_time_coeff", "beta_base",
                           "beta_time_coeff", "channel_mixing")]
    kw = dict(dt=scale["dt"], dx=scale["dx"], dy=scale["dy"], ts=ts,
              splitting="strang", eps=EPS, cmax=CMAX)
    k2_ms = time_ms(lambda: fused_channel_diffusion_fwd(u, *args, **kw))
    k2_plain = time_ms(lambda: fused_channel_diffusion_plain(u, *args, **kw),
                       groups=20, per_group=1)
    # Per element of the state, step and image: mixing 2C, and per sweep
    # (three for Strang) elimination and back-substitution, 5.  Once per
    # (c, h, w), step and sweep, the same for every image: the coefficient
    # (fma, two clamps, ·dtf: 5), b (2) and the c* chain (3).
    sweeps = 3
    k2_bound, k2_by = bound(
        4 * (2 * elems + 4 * band + C * C + 3 * S),
        elems * S * (2 * C + 5 * sweeps) + band * S * sweeps * 10,
        peak_bytes, peak_flops)
    log(f"[times] K2 8-step Strang branch B={B}: kernel {k2_ms:.4f} ms, "
        f"plain {k2_plain:.4f} ms, bound {k2_bound:.4f} ms ({k2_by}); "
        "library: none (no PyTorch call computes the layer)")
    return {
        "k1": (times["x"][0], times["x"][1], k1_bound, k1_by,
               times["y"][0]),
        "k2": (k2_ms, k2_plain, k2_bound, k2_by),
    }


def main():
    name, card = phase_device()
    torch.manual_seed(SEED)
    peak_bytes, peak_flops = card_peaks(name)
    device = torch.device("cuda", 0)
    phase_build()
    k1_err, k2_err = phase_kernels(device)
    launches, rates = phase_slice(device)
    phase_profile(device)
    t = phase_times(device, peak_bytes, peak_flops)
    k1_ms, k1_plain, k1_bound, k1_by, k1_y_ms = t["k1"]
    k2_ms, k2_plain, k2_bound, k2_by = t["k2"]
    log(f"[memory] peak allocated {torch.cuda.max_memory_allocated() / 2**20:.1f}"
        " MiB")
    result = {"kernels": [
        {"name": "tridiag_solve (K1)", "route": "cuda",
         "source": "cnn_pde_tpu_torch/csrc/thomas.cu",
         "replaces": "cnn_pde_tpu/ops/pallas_thomas.py:70",
         "launches": launches["per_sweep"][0], "launches_per_forward": 51,
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
         "at": "x-sweep B=512 (3,32,32)", "y_sweep_ms": k1_y_ms},
        {"name": "fused_channel_diffusion_fwd (K2)", "route": "cuda",
         "source": "cnn_pde_tpu_torch/csrc/fused_channel.cu",
         "replaces": "cnn_pde_tpu/ops/pallas_fused_channel.py:102",
         "launches": launches["fused"][1], "launches_per_forward": 3,
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
         "at": "8-step Strang branch B=512 (3,32,32)"},
    ], "images_per_s": rates}
    log(f"card: {card}")
    log(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
