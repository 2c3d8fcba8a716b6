"""Process-group bring-up — port of ``cnn_pde_tpu/parallel/multihost.py``.

The port runs data parallelism one process a device in a
``torch.distributed`` process group: NCCL over the cards, or gloo on the
CPU when the caller asks for it (``backend="gloo"``, then
``make_mesh(device="cpu")``).  Call :func:`initialize` once a process
(torchrun sets ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``; elsewhere pass the coordinator's ``host:port`` or
``tcp://host:port``, the number of processes and this one's id), then
``make_mesh()`` spans every rank.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["initialize", "is_multihost", "local_batch_slice",
           "global_batch_from_local"]

_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR")


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend=None):
    """``torch.distributed.init_process_group`` from the arguments or
    torchrun's environment.  Returns the bring-up outcome:

    * ``"already_initialized"``: a process group exists already; no-op.
    * ``"initialized"``: the group was brought up (NCCL, or ``backend``:
      ``"gloo"`` for CPU processes).  Under NCCL the process takes the
      card of its ``LOCAL_RANK`` (or its rank modulo the cards); without
      CUDA it raises rather than carry on on the CPU.
    * ``"single_process"``: nothing configures a group, neither the
      arguments nor ``WORLD_SIZE``/``RANK``/``MASTER_ADDR``: a one-process
      run.

    A group that is configured but fails to come up raises: a silent
    single-process run would train on 1/N of the data while looking
    healthy."""
    if dist.is_initialized():
        return "already_initialized"
    configured = (coordinator_address is not None
                  or num_processes is not None or process_id is not None
                  or any(v in os.environ for v in _ENV))
    if not configured:
        return "single_process"
    backend = backend or "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("initialize: no CUDA device is available for an "
                           "NCCL group; pass backend='gloo' for a group of "
                           "CPU processes")
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", 0))
    if coordinator_address is not None:
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
    else:
        init = "env://"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    return "initialized"


def is_multihost() -> bool:
    """Whether more than one process takes part."""
    return dist.is_initialized() and dist.get_world_size() > 1


def local_batch_slice(global_batch: int):
    """(start, size) of this process's rows of a global batch: equal
    blocks in rank order."""
    if not dist.is_initialized():
        return 0, global_batch
    per = global_batch // dist.get_world_size()
    return dist.get_rank() * per, per


def global_batch_from_local(mesh, local_tree, axis="data"):
    """The global batch assembled from each process's local rows (every
    process passes its ``local_batch_slice``; each leaf's leading dim is its
    block): each leaf gathered across the mesh's ``axis`` in axis order, on
    this process's device.  A single-process mesh returns the leaves as
    tensors on its device."""
    from .data_parallel import _gather_rows

    def make(x):
        x = torch.as_tensor(x).to(mesh.device)
        return _gather_rows(mesh, x, axis) if mesh.group is not None else x

    if isinstance(local_tree, dict):
        return {k: make(v) for k, v in local_tree.items()}
    if isinstance(local_tree, (tuple, list)):
        return type(local_tree)(make(v) for v in local_tree)
    return make(local_tree)
