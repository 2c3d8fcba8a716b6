#!/usr/bin/env python3
"""Time this checkout's kernels against another checkout's on one GPU, in
turns: K1 and K3 (cnn_pde_tpu_torch/csrc/thomas.cu), K2, K4 and K5 (the
fused channel kernels), and K6, K7 and K8 (the fused grayscale kernels).

    python3 kernel_ab.py [--other DIR ...]

K1 and K3.  Shapes: the main path's launches (chip_smoke.thomas_shapes: the
flagship's x- and y-sweeps at B = 64 and 512, the mnist layer's smoothed
sweeps at B = 128 and 1024).  Versions: this checkout's kernels and, with
``--other`` (which may be given more than once), each other checkout's
``thomas_solve`` and ``thomas_adjoint``, each launched straight through its
C entry points
(``chip_smoke.raw_thomas``) with the C interface its source declares (with
or without the ``chunk`` argument and K3's partials).  The order is the
others, this, this, the others in reverse; each is labelled by its
directory's name; another checkout whose thomas.cu compiles to the same
SASS as this one's (compared instruction by instruction) is not timed
again.  Each turn times one launch L2-warm three ways: its
device time (``device_ms``: the kernels' own time as torch.profiler
records it), CUDA events around 100 back-to-back launches (host time
between launches included where the host is slower than the kernel), and
CUDA events around the replay of a CUDA graph of 100 launches
(``chip_smoke.graph_ms``: no host time between launches).  Each version's
outputs are held against the plain versions (1e-5 abs; band gradients 1e-4
of their largest entry).

K2-K8.  Their C interface changes between checkouts, so each checkout's
own wrappers and build run them, in a subprocess started in that checkout
(``FUSED_TIMER``), every other checkout in the same order: on the
flagship's 8-step Strang branch (3, 32, 32) with fields from a seed, K2 at
B in {1, 64, 512} and K4 and K5 at B in {64, 512}; on the mnist layer (28 x
28, 10 Strang steps) K6 at B in {1, 128, 1024} and K7 and K8 at B in {128,
1024}; each timed two ways: the device time of the kernels a wrapper call
launches, as torch.profiler records them (``device_ms``; for K8 of a
checkout that sums its partials with torch.sum, those sums too), and CUDA
events around the replay of a CUDA graph of 20 wrapper calls
(``graph_ms``).  The outputs of each other checkout are held against this
one's (K2, K4, K6 and K7 1e-5 abs, K5 and K8 1e-4 of each gradient's
largest entry).  Each checkout's thomas.cu, fused_channel.cu and
fused_channel_vjp.cu are compiled to SASS and compared with this one's.

Prints one line a shape and version, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from cnn_pde_tpu_torch.ops import kernels, tridiag

# torch.profiler now and then records no device event in a session (seen
# on the H100 after many sessions in one process); such a session is run
# again, up to this many times
PROFILER_TRIES = 3
OLD_ARGS = [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
NEW_ARGS = [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def max_line(root: Path):
    """The longest line a checkout's K1 and K3 take: MAX_N of its
    ops/tridiag.py (64 before the long-line scheme)."""
    text = (root / "cnn_pde_tpu_torch" / "ops" / "tridiag.py").read_text()
    return int(re.search(r"^MAX_N = (\d+)", text, re.M).group(1))


def load_other(root: Path):
    """(thomas_solve, thomas_adjoint, chunked) of the other checkout's
    csrc/thomas.cu, built with this checkout's nvcc flags."""
    src = root / "cnn_pde_tpu_torch" / "csrc" / "thomas.cu"
    text = src.read_text()
    digest = hashlib.sha256(text.encode())
    for header in sorted(src.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest = digest.hexdigest()[:12]
    so = kernels.BUILD_DIR / f"other-thomas-{digest}.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if not so.exists():
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so),
                        str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    chunked = "int chunk" in text
    shape_args = NEW_ARGS if chunked else OLD_ARGS
    solve, adjoint = lib.thomas_solve, lib.thomas_adjoint
    solve.argtypes = [ctypes.c_void_p] * 5 + shape_args
    adjoint.argtypes = [ctypes.c_void_p] * (10 if chunked else 9) + shape_args
    solve.restype = adjoint.restype = ctypes.c_int
    return solve, adjoint, chunked


def device_ms(fn, arg_sets, passes):
    """Mean device time of one ``fn(*args)`` call: the time of the kernels
    it launches, as torch.profiler records them on the card, over
    ``passes`` walks through ``arg_sets``.  Host time between launches is
    not in it (a wrapper's Python and ctypes call can outlast a small
    kernel, and then CUDA events around calls time the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(passes):
                for args in arg_sets:
                    fn(*args)
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False))
        if us > 0:
            return us / 1e3 / (passes * len(arg_sets))
    raise RuntimeError(f"the profiler recorded no kernel in "
                       f"{PROFILER_TRIES} sessions")


def check(label, got, bands, dim, u, g, x):
    k1, k3 = got
    torch.cuda.synchronize()
    cs.check(f"{label} K1", cs.max_err(k1, tridiag.tridiag_solve_plain(
        *bands, u, dim)), cs.KERNEL_TOL)
    ref = tridiag.tridiag_adjoint_plain(*bands, g, x, dim)
    cs.check(f"{label} K3 λ", cs.max_err(k3[0], ref[0]), cs.KERNEL_TOL)
    for o, r in zip(k3[1:], ref[1:]):
        cs.check_rel(f"{label} K3 band gradient", cs.rel_err(o, r),
                     cs.GRAD_TOL)


# Run in a checkout's root as ``python3 -c FUSED_TIMER``: times that
# checkout's K2, K4 and K5 through its own wrappers; prints one JSON line and
# saves the outputs to the file named by argv[1] for the comparison.
FUSED_TIMER = r"""
import json, statistics, sys
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, ".")
from cnn_pde_tpu_torch.ops.fused_channel import fused_channel_diffusion_fwd
from cnn_pde_tpu_torch.ops.fused_channel_vjp import (fused_channel_bwd,
                                                     fused_channel_fwd_res)
from cnn_pde_tpu_torch.ops.fused_grayscale import \
    fused_grayscale_diffusion_fwd
from cnn_pde_tpu_torch.ops.fused_grayscale_vjp import (
    fused_grayscale_bwd, fused_grayscale_fwd_res)
from cnn_pde_tpu_torch.pde.diffusion import _substep_times_np

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
rng = np.random.default_rng(12345)
C, S, STEPS, DT, DX = 3, 32, 8, 0.002, 2.0
t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
args = [t(1.0 + 0.5 * rng.standard_normal((C, S, S))),
        t(5.0 * rng.standard_normal((C, S, S))),
        t(1.0 + 0.5 * rng.standard_normal((C, S, S))),
        t(5.0 * rng.standard_normal((C, S, S))),
        t(np.eye(C) + 0.05 * rng.standard_normal((C, C)))]
kw = dict(dt=DT, dx=DX, dy=DX, splitting="strang", eps=1e-6, cmax=10.0,
          ts=t(_substep_times_np(DT, STEPS)))


def device_ms(fn, calls=20, tries=3):
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False))
        if us > 0:
            return us / 1e3 / calls
    raise RuntimeError("the profiler recorded no kernel")


def graph_ms(fn, calls=20, groups=10):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
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
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


rows, outs = [], {}
for B in (1, 64, 512):
    u = t(rng.random((B, C, S, S)))
    g = t(rng.standard_normal((B, C, S, S)))
    y, res = fused_channel_fwd_res(u, *args, **kw)
    calls = {"K2": lambda: fused_channel_diffusion_fwd(u, *args, **kw)}
    if B > 1:
        calls["K4"] = lambda: fused_channel_fwd_res(u, *args, **kw)
        calls["K5"] = lambda: fused_channel_bwd(g, res, y, *args, **kw)
    for name, fn in calls.items():
        out = fn()
        outs[f"{name}_B{B}"] = [o.cpu() for o in
                                (out if isinstance(out, tuple) else (out,))]
        rows.append(dict(kernel=name, B=B, device_ms=device_ms(fn),
                         graph_ms=graph_ms(fn)))

# the mnist layer: 28 x 28, 10 Strang steps, dt 0.001, fields 2 +- 0.5 with
# time coefficients that move them by about 1 over the layer
GS, GSTEPS, GDT = 28, 10, 0.001
gargs = [t(2.0 + 0.5 * rng.standard_normal((GS, GS))),
         t(rng.standard_normal((GS, GS)) / (GDT * GSTEPS)),
         t(2.0 + 0.5 * rng.standard_normal((GS, GS))),
         t(rng.standard_normal((GS, GS)) / (GDT * GSTEPS))]
gkw = dict(dt=GDT, dx=1.0, dy=1.0, eps=1e-6,
           ts=t(_substep_times_np(GDT, GSTEPS)))
for B in (1, 128, 1024):
    u = t(rng.random((B, GS, GS)))
    g = t(rng.standard_normal((B, GS, GS)))
    y, res = fused_grayscale_fwd_res(u, *gargs, **gkw)
    calls = {"K6": lambda: fused_grayscale_diffusion_fwd(u, *gargs, **gkw)}
    if B > 1:
        calls["K7"] = lambda: fused_grayscale_fwd_res(u, *gargs, **gkw)
        calls["K8"] = lambda: fused_grayscale_bwd(g, res, y, *gargs, **gkw)
    for name, fn in calls.items():
        out = fn()
        outs[f"{name}_B{B}"] = [o.cpu() for o in
                                (out if isinstance(out, tuple) else (out,))]
        rows.append(dict(kernel=name, B=B, device_ms=device_ms(fn),
                         graph_ms=graph_ms(fn)))
torch.save(outs, sys.argv[1])
print(json.dumps(rows))
"""


def fused_times(root: Path, label: str, turn: int):
    """K2-K8 of the checkout at ``root``, timed by its own wrappers in a
    subprocess; (rows, outputs)."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    saved = kernels.BUILD_DIR / f"ab-{label}-{turn}.pt"
    run = subprocess.run([sys.executable, "-c", FUSED_TIMER, str(saved)],
                         cwd=root, capture_output=True, text=True,
                         timeout=900)
    if run.returncode != 0:
        raise RuntimeError(f"{label} ({root}) failed:\n{run.stderr[-4000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1]), torch.load(saved)


def compare_fused(this_outs, other_outs, label):
    """Hold another checkout's K2-K8 outputs against this one's."""
    for key, mine in this_outs.items():
        for i, (a, b) in enumerate(zip(mine, other_outs[key])):
            if key.startswith(("K5", "K8")):
                cs.check_rel(f"{key} output {i} this vs {label}",
                             cs.rel_err(a, b), cs.GRAD_TOL)
            else:
                cs.check(f"{key} output {i} this vs {label}",
                         cs.max_err(a, b), cs.KERNEL_TOL)


def sass(src: Path, out: Path):
    """The instructions of a source's kernels, compiled to a cubin for
    sm_90a, with names and addresses taken out."""
    subprocess.run([kernels._nvcc(), "-gencode", "arch=compute_90a,"
                    "code=sm_90a", "-std=c++17", "-O3", "-cubin", "-o",
                    str(out), str(src)], check=True)
    dump = subprocess.run([str(Path(kernels._nvcc()).parent / "cuobjdump"),
                           "-sass", str(out)], capture_output=True, text=True,
                          check=True).stdout
    ops = []
    for line in dump.splitlines():
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m:
            ops.append(m.group(1))
    return ops


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", type=Path, action="append", default=[],
                        help="another checkout's root (repeatable)")
    args = parser.parse_args()
    cs.phase_device()
    device = torch.device("cuda", 0)
    roots = {"this": Path(__file__).resolve().parent}
    for other in args.other:
        label = other.resolve().name
        if label in roots:
            raise SystemExit(f"two checkouts named {label!r}")
        roots[label] = other.resolve()
    others = [label for label in roots if label != "this"]
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # K1 and K3 of another checkout are timed only where its thomas.cu
    # compiles to other instructions than this one's; fused_channel.cu and
    # fused_channel_vjp.cu (K2, K4, K5) are compared the same way
    same_sass = {}
    for source in ("thomas", "fused_channel", "fused_channel_vjp"):
        mine = sass(roots["this"] / f"cnn_pde_tpu_torch/csrc/{source}.cu",
                    kernels.BUILD_DIR / f"ab-this-{source}.cubin")
        for label in others:
            same_sass[(source, label)] = mine == sass(
                roots[label] / f"cnn_pde_tpu_torch/csrc/{source}.cu",
                kernels.BUILD_DIR / f"ab-{label}-{source}.cubin")
            word = "the same" if same_sass[(source, label)] else "different"
            cs.log(f"[ab] {source}.cu of this checkout and of {label} "
                   f"compile to {word} SASS")
    same = {label: same_sass[("thomas", label)] for label in others}
    timed = [label for label in others if not same[label]]
    versions = {"this": cs.this_thomas()}
    versions.update({label: load_other(roots[label]) for label in timed})
    order = [*timed, "this", "this", *reversed(timed)]
    longest = {label: max_line(roots[label]) for label in roots}
    rows = []
    for at, bands, dim, B in cs.thomas_shapes(device):
        u = torch.rand((B, *bands[0].shape), device=device)
        g = torch.randn_like(u)
        x = tridiag.tridiag_solve_plain(*bands, u, dim).contiguous()
        times = {}
        # a checkout whose kernels take shorter lines is not launched
        for label in (v for v in order if bands[0].shape[dim] <= longest[v]):
            fns = versions[label]
            k1, k3 = cs.raw_thomas(fns, bands, dim, u, g, x)
            if label not in times:
                check(f"{at} {label}", (k1(), k3()), bands, dim, u, g, x)
            t = (device_ms(k1, [()], 100), device_ms(k3, [()], 100),
                 cs.time_ms(k1, groups=10, per_group=100),
                 cs.time_ms(k3, groups=10, per_group=100),
                 *(cs.graph_ms(lambda j=j: [cs.raw_thomas(
                     fns, bands, dim, u, g, x)[j]]) for j in (0, 1)))
            times.setdefault(label, []).append(t)
        for label, ts in times.items():
            k1_ms, k3_ms, k1_ev, k3_ev, k1_gr, k3_gr = (
                [t[j] for t in ts] for j in range(6))
            cs.log(f"[ab] {at} {label}: K1 {k1_ms} ms, K3 {k3_ms} ms "
                   f"(device time, L2-warm, each turn); by CUDA events "
                   f"around back-to-back launches K1 {k1_ev} ms, K3 {k3_ev} "
                   f"ms; in a CUDA graph K1 {k1_gr} ms, K3 {k3_gr} ms")
            rows.append(dict(at=at, version=label, k1_ms=k1_ms, k3_ms=k3_ms,
                             k1_events_ms=k1_ev, k3_events_ms=k3_ev,
                             k1_graph_ms=k1_gr, k3_graph_ms=k3_gr))
    result = {"thomas_ab": rows, "thomas_same_sass": same,
              "same_sass": {f"{source} {label}": v
                            for (source, label), v in same_sass.items()}}

    order = [*others, "this", "this", *reversed(others)]
    fused, outs = {}, {}
    for turn, label in enumerate(order):
        rows_f, outs[label] = fused_times(roots[label], label, turn)
        for r in rows_f:
            fused.setdefault((r["kernel"], r["B"], label), []).append(r)
    for label in others:
        compare_fused(outs["this"], outs[label], label)
    result["fused_ab"] = []
    for (name, B, label), rs in sorted(fused.items()):
        dev_ms = [r["device_ms"] for r in rs]
        gr_ms = [r["graph_ms"] for r in rs]
        at = ("8-step Strang branch (3,32,32)" if name in ("K2", "K4", "K5")
              else "mnist layer, 10 steps (28,28)")
        cs.log(f"[ab] {name} {at} B={B} {label}: device time {dev_ms} ms, "
               f"CUDA graph of wrapper calls {gr_ms} ms (each turn)")
        result["fused_ab"].append(dict(kernel=name, B=B, version=label,
                                       device_ms=dev_ms, graph_ms=gr_ms))
    cs.log(json.dumps(result))


if __name__ == "__main__":
    main()
