"""Device meshes — port of ``cnn_pde_tpu/parallel/mesh.py``.

A ``Mesh`` has the JAX axes ('data', 'spatial', 'model') over a grid of
``torch.device``s.  Inside an initialized ``torch.distributed`` process
group (``multihost.initialize``, or torchrun) the grid holds one device a
rank, in rank order reshaped (data, spatial, model) as JAX reshapes its
device list, and the mesh carries the group and one subgroup for each
slice of each axis: ``mesh.axis("model")`` is this rank's (group, index
along the axis, axis size).  Every rank creates every subgroup, in the
same order (``dist.new_group`` asks it), when the mesh is made.  Outside a
group the grid is the process's own devices (every visible card), as a
single-process server's replicas use them, and may have any shape; the
sharded layers refuse such a mesh past one device.  A mesh holds the CPU
only when the caller asks for it (``device="cpu"``, or ``devices=``):
without CUDA ``make_mesh()`` raises rather than carry on on the CPU.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh"]

AXES = ("data", "spatial", "model")
# the axis groups a mesh makes: each axis, and the (data, spatial) plane
# that sums a sharded step's gradients (parallel/tensor_parallel.py)
GROUPS = (("data",), ("spatial",), ("model",), ("data", "spatial"))


class Mesh:
    """A device grid with the axes ('data', 'spatial', 'model').

    ``devices``: numpy object array of ``torch.device``s, shaped
    (data, spatial, model).  ``group``: the process group whose ranks own
    the grid's devices (rank r the r-th in row-major order), or None for a
    mesh of this process's devices.  ``shape`` maps each axis name to its
    size; ``coords`` is this rank's (data, spatial, model) index."""

    axis_names = AXES

    def __init__(self, devices, group=None):
        self.devices = devices
        self.group = group
        self.shape = dict(zip(AXES, devices.shape))
        self.rank = dist.get_rank(group) if group is not None else 0
        self.world = dist.get_world_size(group) if group is not None else 1
        self.coords = tuple(int(i) for i in np.unravel_index(
            self.rank, devices.shape)) if group is not None else (0, 0, 0)
        self._groups = _axis_groups(devices.shape, self.rank) \
            if group is not None else {}

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

    def axis(self, *names):
        """(group, index, size) of this rank along the named axes (one
        axis, or ``"data", "spatial"`` for their plane, its index
        row-major): the group is None where the size is 1 (nothing to
        communicate), the whole world where the axes span it."""
        size = math.prod(self.shape[n] for n in names)
        index = 0
        for n in names:
            index = index * self.shape[n] + self.coords[AXES.index(n)]
        if size == 1:
            return None, 0, 1
        if self.group is None:
            raise ValueError(
                f"the mesh's {'x'.join(names)} axis spans {size} devices: "
                "sharded layers run one process a device, bring up a "
                "process group first (parallel/multihost.py::initialize, "
                "or torchrun)")
        return self._groups[tuple(names)], index, size

    def peer(self, axis, index):
        """The global rank at ``index`` along ``axis``, this rank's other
        coordinates held."""
        coords = list(self.coords)
        coords[AXES.index(axis)] = index
        return int(np.ravel_multi_index(coords, self.devices.shape))


def _axis_groups(shape, rank):
    """{axes: this rank's group of them} for each of ``GROUPS`` larger than
    one rank; every rank makes every group in the same order."""
    world = math.prod(shape)
    grid = np.arange(world).reshape(shape)
    out = {}
    for names in GROUPS:
        dims = [AXES.index(n) for n in names]
        size = math.prod(shape[d] for d in dims)
        if size == 1:
            continue
        if size == world:
            out[names] = dist.group.WORLD
            continue
        rest = [d for d in range(3) if d not in dims]
        for ranks in grid.transpose(rest + dims).reshape(-1, size):
            g = dist.new_group([int(r) for r in ranks])
            if rank in ranks:
                out[names] = g
    return out


def _default_devices(device, world):
    """The grid's devices when the caller names none: the CPU
    (``device="cpu"``; once, or once a rank of a group of ``world``), or
    the cards: every local card outside a group; in a group this
    process's current card for its own rank and the card of a rank's place
    on its host for the others."""
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * (world or 1)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: no CUDA device is available; pass device='cpu' "
            "(or devices=[torch.device('cpu')] * n) for a mesh of the CPU")
    n = torch.cuda.device_count()
    if world is None:
        return [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device("cuda", r % n) for r in range(world)]
    devices[dist.get_rank()] = torch.device("cuda",
                                            torch.cuda.current_device())
    return devices


def make_mesh(data: Optional[int] = None, spatial: int = 1, model: int = 1,
              devices=None, device="cuda") -> Mesh:
    """A mesh with ('data', 'spatial', 'model') axes.  ``data`` None uses
    all devices / (spatial·model).  ``devices``: the grid's devices (in a
    process group, one a rank); by default the group's ranks' cards, or
    this process's own cards outside a group, or with ``device="cpu"``
    the CPU (once, or once a rank).  Without CUDA and without either
    argument it raises.  In a group the mesh spans every rank:
    data·spatial·model is the world size."""
    group = world = None
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        world = dist.get_world_size()
    devices = list(devices) if devices is not None else \
        _default_devices(device, world)
    if group is not None and len(devices) != world:
        raise ValueError(f"a mesh in a process group of {world} ranks "
                         f"holds one device a rank, got {len(devices)}")
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if data is None:
        assert n % (spatial * model) == 0, (n, spatial, model)
        data = n // (spatial * model)
    assert data * spatial * model <= n, (data, spatial, model, n)
    if group is not None and data * spatial * model != n:
        raise ValueError(f"a mesh in a process group spans every rank: "
                         f"data·spatial·model = {data * spatial * model} "
                         f"of {n}")
    grid = np.empty(data * spatial * model, dtype=object)
    grid[:] = devices[: data * spatial * model]
    return Mesh(grid.reshape(data, spatial, model), group)
