#!/usr/bin/env python3
"""Time the eager paths that call the kernels' registered ops in this
checkout against other checkouts on one GPU, in turns.

    python3 eager_ab.py --other DIR [--other DIR ...]

Each turn is a subprocess started in its checkout, which imports that
checkout's package and ``chip_smoke.py`` (``TIMER``); the order is the
others, this, this, the others in reverse, each labelled by its
directory's name.  A turn builds its checkout's kernels, then times:

* ``k1_call_us``: the host time of one K1 call through ``tridiag_solve``
  (the autograd Function, then the op or the launch) on the flagship's
  x-sweep at B = 1, under ``torch.no_grad()`` and
  ``torch.inference_mode()``: the mean over 2,000 calls made back to
  back, synchronised once at the end (the kernel takes about 7 µs on an
  H100, so the host's time is what is read);
* the flagship's eager predict (``make_eager_predict_fn``, or
  ``make_predict_fn`` in a checkout that predates it, where it was
  eager), per-sweep and fused (``chip_smoke.flagship``), at B = 1, 64 and
  1024: images/s by host clock, ``REPS[B]`` requests after one warm-up,
  the median of 3 rounds (chip_smoke.py phase 4's measure);
* its eager train step (``make_train_step``, the preset's settings),
  per-sweep and fused, at B = 64 and 256: images/s by CUDA events, the
  median of 3 groups of 10 steps after warm-up (phase 6's measure).

Prints one line a turn, then one JSON line of every turn.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

REPS = {1: 30, 64: 20, 1024: 5}

# run in each checkout, with that checkout on sys.path
TIMER = r"""
import json, statistics, sys, time
import numpy as np
import torch
import chip_smoke as cs
from cnn_pde_tpu_torch import serve
from cnn_pde_tpu_torch.data.synthetic import make_synthetic
from cnn_pde_tpu_torch.ops.tridiag import tridiag_solve
from cnn_pde_tpu_torch.train import make_train_step

REPS = {int(k): v for k, v in json.loads(sys.argv[1]).items()}
device = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
out = {}

rng = np.random.default_rng(cs.SEED)
field = cs.fields(rng, device)["alpha_base"].abs() + 0.1
a, b, c = cs.sweep_bands(field, 0.1, 1.0, -1)
u = torch.rand((1, 3, 32, 32), device=device)
for mode, ctx in (("no_grad", torch.no_grad),
                  ("inference_mode", torch.inference_mode)):
    with ctx():
        for _ in range(200):
            tridiag_solve(a, b, c, u, dim=-1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            tridiag_solve(a, b, c, u, dim=-1)
        torch.cuda.synchronize()
        out[f"k1_call_us_{mode}"] = (time.perf_counter() - t0) / 2000 * 1e6

make_eager = getattr(serve, "make_eager_predict_fn", serve.make_predict_fn)
rng = np.random.default_rng(cs.SEED + 2)
for config in ("per_sweep", "fused"):
    predict = make_eager(cs.flagship(device, config == "fused"),
                         output="logits")
    for B, reps in REPS.items():
        x = torch.from_numpy(rng.random((B, 3, 32, 32)).astype(
            np.float32)).to(device)
        predict(x)
        torch.cuda.synchronize()
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(reps):
                predict(x)
            torch.cuda.synchronize()
            rates.append(B * reps / (time.perf_counter() - t0))
        out[f"serve_{config}_B{B}"] = statistics.median(rates)

images, labels, _, _ = make_synthetic("cifar10")
data = (torch.from_numpy(images).to(device),
        torch.from_numpy(labels).to(device))
for config in ("per_sweep", "fused"):
    model = cs.flagship(device, fused_pde=config == "fused")
    step = make_train_step(model, cs.TRAIN, max(data[0].shape[0] // 64, 1),
                           torch.Generator(device).manual_seed(cs.SEED))
    for B in (64, 256):
        idx = torch.from_numpy(rng.integers(0, data[0].shape[0], B))
        xb, yb = data[0][idx.to(device)], data[1][idx.to(device)]
        ms = cs.time_ms(lambda: step(xb, yb), groups=3, per_group=10)
        out[f"train_{config}_B{B}"] = 1e3 * B / ms
print(json.dumps(out))
"""


def turn(root: Path):
    """One turn in ``root``: its timings."""
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run(
        [sys.executable, "-c", TIMER, json.dumps(REPS)], cwd=root, env=env,
        capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{root}: exit {proc.returncode}\n"
                         f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", type=Path, action="append", default=[],
                        help="another checkout's root (more than once)")
    args = parser.parse_args()
    this = Path(__file__).resolve().parent
    others = [p.resolve() for p in args.other]
    order = [*others, this, this, *reversed(others)]
    turns = []
    for root in order:
        label = "this" if root == this else root.name
        times = turn(root)
        turns.append({"checkout": label, **times})
        print(f"{label}: " + ", ".join(f"{k} {v:.2f}"
                                       for k, v in times.items()),
              flush=True)
    keys = [k for k in turns[0] if k != "checkout"]
    medians = {}
    for label in dict.fromkeys(t["checkout"] for t in turns):
        mine = [t for t in turns if t["checkout"] == label]
        medians[label] = {k: statistics.median(t[k] for t in mine)
                          for k in keys}
    print(json.dumps({"turns": turns, "medians": medians}))


if __name__ == "__main__":
    main()
