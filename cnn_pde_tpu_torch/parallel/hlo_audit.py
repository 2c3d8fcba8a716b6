"""Communication-shape auditing — port of
``cnn_pde_tpu/parallel/hlo_audit.py``.

JAX counts the collective instructions of a compiled HLO program.  The
port has no compiled program to read: it counts the collectives that one
call makes, from a ``torch.profiler`` run of the call.  Each collective
records its ``c10d::`` dispatcher op (the same on gloo and NCCL), which
``collective_counts`` maps onto JAX's ``COLLECTIVES`` keys; beside it the
backend records its own event (``gloo:all_gather``, ``nccl:all_reduce``)
with the tensors' shapes; on the card the profile also holds the NCCL
kernels and their device time (``dp_scale.py`` reads them).

A profile counts calls, not compiled instructions, so the counts are per
call: a halo-exchange FTCS evolution of nt steps sends one row each way a
step on an interior rank (2·nt ``collective-permute``s; one a step on the
two edge ranks); a spatial ADI step is 3 all-to-alls; a partitioned ADI
step is 2 all-gathers whose payloads do not depend on H; a
tensor-parallel SymmetricLayer call is 1 all-reduce.

    counts, shapes, out = audit(fn, *args)
"""

from __future__ import annotations

import torch
from torch.profiler import ProfilerActivity, profile

__all__ = ["COLLECTIVES", "collective_counts", "gather_result_shapes",
           "trace", "audit"]

COLLECTIVES = ("all-reduce", "all-gather", "all-to-all",
               "collective-permute", "reduce-scatter")

# the dispatcher op of each collective the port issues
# (``collectives.py``, ``data_parallel.py``) -> JAX's name for it (a halo
# row sent one way is one collective-permute)
_OPS = {"c10d::allreduce_": "all-reduce",
        "c10d::_allgather_base_": "all-gather",
        "c10d::alltoall_base_": "all-to-all",
        "c10d::send": "collective-permute",
        "c10d::_reduce_scatter_base_": "reduce-scatter"}


def trace(fn, *args, **kwargs):
    """(fn's result, the profile of the call): CPU events with their
    shapes, and the card's kernels where there is one."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=True) as prof:
        out = fn(*args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return out, prof


def collective_counts(prof) -> dict:
    """{collective name: calls in the profile ``prof``}."""
    counts = dict.fromkeys(COLLECTIVES, 0)
    for e in prof.events():
        name = _OPS.get(e.name)
        if name is not None:
            counts[name] += 1
    return counts


def gather_result_shapes(prof):
    """[(dims...), ...]: the output shape of every all-gather in ``prof``
    (the port's gathers flatten each block to one row, so a shape is
    (axis size, numbers a rank)) — what is gathered, e.g. interface rows
    whose size does not depend on the sharded extent."""
    return [tuple(e.input_shapes[0]) for e in prof.events()
            if _OPS.get(e.name) == "all-gather" and e.input_shapes]


def audit(fn, *args, **kwargs):
    """(collective_counts, gather_result_shapes, fn's result) of one call
    of ``fn``."""
    out, prof = trace(fn, *args, **kwargs)
    return collective_counts(prof), gather_result_shapes(prof), out
