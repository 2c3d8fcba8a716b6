"""Debugging utilities — port of ``cnn_pde_tpu/utils/debug.py``
(``nan_guard``, ``profile_trace``, ``annotate``, ``step_timer``).

``nan_guard(step)`` wraps a train step so that a non-finite loss or
gradient raises ``FloatingPointError`` naming the step.  The JAX
``--debug-nans`` turns on ``jax_debug_nans``, which re-runs the op that
made a NaN eagerly and raises there; PyTorch has no counterpart that a
CUDA graph can hold (``torch.autograd.detect_anomaly`` checks every
backward op on the host, one sync an op), so the port checks what a step
returns: after each step of the host loop (``check_step``, one sync a
step), and after each chunk of the device epoch (``check_chunk``: its
losses, fetched anyway, and the weights once).

``profile_trace`` records ``torch.profiler`` over its block (the host and,
unless the caller asks for the CPU, the card) and writes a Chrome/Perfetto
trace into its directory, a file of its own for each block of the process
(as ``jax.profiler.start_trace`` gives each trace its own run directory);
``annotate(name)`` is a named span of that trace.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import time

import numpy as np
import torch

__all__ = ["nan_guard", "check_step", "check_chunk", "profile_trace",
           "annotate", "step_timer"]


def _first_nonfinite(named):
    """The name of the first of the (name, tensor) pairs ``named`` with a
    non-finite entry, or None; one sync."""
    named = list(named)
    if not named:
        return None
    finite = torch.stack([torch.isfinite(t).all() for _, t in named]).cpu()
    bad = np.flatnonzero(~finite.numpy())
    return named[bad[0]][0] if bad.size else None


def check_step(loss, model, step):
    """Raise unless the loss and every gradient of ``model`` are finite
    after train step ``step`` (0-based)."""
    if not bool(torch.isfinite(loss)):
        raise FloatingPointError(f"non-finite loss {float(loss)} at step "
                                 f"{step}")
    name = _first_nonfinite((n, p.grad) for n, p in model.named_parameters()
                            if p.grad is not None)
    if name is not None:
        raise FloatingPointError(f"non-finite gradient of {name} at step "
                                 f"{step}")


def check_chunk(losses, step0, model):
    """Raise unless every loss of a device-epoch chunk (host array, the
    chunk's first step ``step0``) and every weight at its end is finite;
    the message names the first step whose loss is not."""
    bad = np.flatnonzero(~np.isfinite(losses))
    if bad.size:
        raise FloatingPointError(f"non-finite loss {losses[bad[0]]} at step "
                                 f"{step0 + int(bad[0])}")
    name = _first_nonfinite(model.named_parameters())
    if name is not None:
        raise FloatingPointError(
            f"non-finite weight {name} after steps {step0}-"
            f"{step0 + len(losses) - 1}")


def nan_guard(step, first_step=0):
    """``step`` (``images, labels -> loss, acc``) checked by
    ``check_step`` after every call, the calls counted from
    ``first_step``."""
    count = [first_step]

    def guarded(images, labels):
        loss, acc = step(images, labels)
        check_step(loss, step.model, count[0])
        count[0] += 1
        return loss, acc

    guarded.model = step.model
    return guarded


# numbers the traces of this process: each block writes a file of its own
_TRACES = itertools.count()


@contextlib.contextmanager
def profile_trace(logdir=None, device="cuda"):
    """Profile the block: the host's ops, and the card's kernels unless
    ``device="cpu"``; yields ``logdir`` (by default ``torch-trace`` in the
    temporary directory) and writes the trace there on exit, also when the
    block raises (``trace_<pid>_<n>.json``, Chrome/Perfetto format, ``n``
    counting the process's blocks from 0, so that no trace replaces
    another).  Without CUDA it raises unless the caller asks for the
    CPU."""
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "torch-trace")
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("profile_trace: no CUDA device is available; "
                               "pass device='cpu' to profile the host alone")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    name = f"trace_{os.getpid()}_{next(_TRACES)}.json"
    prof = profile(activities=activities)
    try:
        with prof:
            yield logdir
    finally:
        prof.export_chrome_trace(os.path.join(logdir, name))


def annotate(name):
    """A named span of the profiler's timeline (``with annotate("eval"):``)."""
    return torch.profiler.record_function(name)


class step_timer:
    """Wall-clock step times: ``with t.measure(): ...`` (end the timed
    work with ``torch.cuda.synchronize()`` for device time)."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    @property
    def mean_ms(self):
        return 1000.0 * sum(self.times) / max(len(self.times), 1)
