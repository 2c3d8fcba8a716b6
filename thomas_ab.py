#!/usr/bin/env python3
"""Time K1 and K3 (cnn_pde_tpu_torch/csrc/thomas.cu) of this checkout
against another checkout's thomas.cu on one GPU, in turns.

    python3 thomas_ab.py [--other DIR]

Shapes: the main path's K1 and K3 launches (chip_smoke.thomas_shapes: the
flagship's x- and y-sweeps at B = 64 and 512, the mnist layer's smoothed
sweeps at B = 128 and 1024).  Versions: this checkout's kernels and, with
``--other``, the other checkout's ``thomas_solve`` and ``thomas_adjoint``,
each launched straight through its C entry points
(``chip_smoke.raw_thomas``) with the C interface its source declares (with
or without the ``chunk`` argument and K3's partials).  The order is other,
this, this, other.  Each turn times one launch L2-warm three ways: its
device time (``device_ms``: the kernels' own time as torch.profiler
records it), CUDA events around 100 back-to-back launches (host time
between launches included where the host is slower than the kernel), and
CUDA events around the replay of a CUDA graph of 100 launches
(``chip_smoke.graph_ms``: no host time between launches).  Each version's outputs are
held against the plain versions (1e-5 abs; band gradients 1e-4 of their
largest entry).  Prints one line a shape and version, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import torch

import chip_smoke as cs
from cnn_pde_tpu_torch.ops import kernels, tridiag

OLD_ARGS = [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
NEW_ARGS = [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def load_other(root: Path):
    """(thomas_solve, thomas_adjoint, chunked) of the other checkout's
    csrc/thomas.cu, built with this checkout's nvcc flags."""
    src = root / "cnn_pde_tpu_torch" / "csrc" / "thomas.cu"
    text = src.read_text()
    digest = hashlib.sha256(text.encode()).hexdigest()[:12]
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(passes):
            for args in arg_sets:
                fn(*args)
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False))
    if us <= 0:
        raise RuntimeError("the profiler recorded no kernel")
    return us / 1e3 / (passes * len(arg_sets))


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


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", type=Path)
    args = parser.parse_args()
    cs.phase_device()
    device = torch.device("cuda", 0)
    versions = {"this": cs.this_thomas()}
    order = ["this", "this"]
    if args.other:
        versions["other"] = load_other(args.other)
        order = ["other", *order, "other"]
    rows = []
    for at, bands, dim, B in cs.thomas_shapes(device):
        u = torch.rand((B, *bands[0].shape), device=device)
        g = torch.randn_like(u)
        x = tridiag.tridiag_solve_plain(*bands, u, dim).contiguous()
        times = {}
        for label in order:
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
    cs.log(json.dumps({"thomas_ab": rows}))


if __name__ == "__main__":
    main()
