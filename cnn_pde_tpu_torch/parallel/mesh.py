"""Device meshes — port of ``cnn_pde_tpu/parallel/mesh.py``.

A ``Mesh`` has the JAX axes ('data', 'spatial', 'model') over a grid of
``torch.device``s.  Inside an initialized ``torch.distributed`` process
group (``multihost.initialize``, or torchrun) the grid holds one device a
rank, in rank order, and the mesh carries the group: the data-parallel
layer runs one process a device and reduces across the group.  Outside a
group the grid is the process's own devices (every visible card, or the
CPU), as a single-process server's replicas use them.

Only the 'data' axis is ported: 'spatial' and 'model' above 1 (spatial
and tensor parallelism) raise, naming ROADMAP.md A15.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh"]

AXES = ("data", "spatial", "model")


class Mesh:
    """A device grid with the axes ('data', 'spatial', 'model').

    ``devices``: numpy object array of ``torch.device``s, shaped
    (data, spatial, model).  ``group``: the process group whose ranks own
    the grid's devices (rank r the r-th), or None for a mesh of this
    process's devices.  ``shape`` maps each axis name to its size."""

    axis_names = AXES

    def __init__(self, devices, group=None):
        self.devices = devices
        self.group = group
        self.shape = dict(zip(AXES, devices.shape))
        self.rank = dist.get_rank(group) if group is not None else 0
        self.world = dist.get_world_size(group) if group is not None else 1

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def local_devices(self):
        """The devices this process drives: its rank's one in a group,
        every device of the grid otherwise."""
        flat = list(self.devices.flat)
        return [flat[self.rank]] if self.group is not None else flat

    @property
    def device(self):
        """This process's (first) device."""
        return self.local_devices[0]


def _rank_devices(world):
    """One device a rank of the default group: the CPU under gloo; under
    NCCL this process's current card for its own rank, and the card of a
    rank's place on its host for the others."""
    if dist.get_backend() == "nccl":
        n = torch.cuda.device_count()
        devices = [torch.device("cuda", r % n) for r in range(world)]
        devices[dist.get_rank()] = torch.device("cuda",
                                                torch.cuda.current_device())
        return devices
    return [torch.device("cpu")] * world


def _local_devices():
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(data: Optional[int] = None, spatial: int = 1, model: int = 1,
              devices=None) -> Mesh:
    """A mesh with ('data', 'spatial', 'model') axes.  ``data`` None uses
    all devices / (spatial·model).  ``devices``: the grid's devices (in a
    process group, one a rank); by default the group's ranks' devices, or
    this process's own outside a group."""
    if spatial != 1 or model != 1:
        raise NotImplementedError(
            f"make_mesh(spatial={spatial}, model={model}): spatial and "
            "tensor parallelism are not ported yet: ROADMAP.md A15")
    group = None
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        world = dist.get_world_size()
        devices = list(devices) if devices is not None else \
            _rank_devices(world)
        if len(devices) != world:
            raise ValueError(f"a mesh in a process group of {world} ranks "
                             f"holds one device a rank, got {len(devices)}")
    else:
        devices = list(devices) if devices is not None else _local_devices()
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if data is None:
        assert n % (spatial * model) == 0, (n, spatial, model)
        data = n // (spatial * model)
    assert data * spatial * model <= n, (data, spatial, model, n)
    if group is not None and data != n:
        raise ValueError(f"a mesh in a process group spans every rank: "
                         f"data={data} of {n}")
    grid = np.empty(data * spatial * model, dtype=object)
    grid[:] = devices[: data * spatial * model]
    return Mesh(grid.reshape(data, spatial, model), group)
