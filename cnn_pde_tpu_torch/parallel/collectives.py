"""The collectives of the sharded layers, each an autograd Function with
its hand-written transpose — the port's counterparts of the XLA
collectives that JAX's ``shard_map`` bodies and GSPMD insert
(``lax.psum``, ``all_gather``, ``all_to_all``, ``ppermute``).

Every function takes this rank's tensor, the mesh and the axis it
communicates over (``Mesh.axis``); at axis size 1 it returns its input.

* ``copy_to`` / ``reduce_from`` / ``gather_from``: Megatron's operators
  over 'model'.  ``copy_to`` is the identity forward and an all-reduce of
  the gradient (the input of a column-parallel product); ``reduce_from``
  all-reduces the partial sums forward and passes the gradient through
  (the output of a row-parallel product); ``gather_from`` makes a
  feature-sharded output whole, its backward this rank's slice (a chain
  that ends on a column-parallel product).  The loss they assume is the
  one every model rank computes alike.
* ``all_gather``: every rank's block stacked in axis order (S, *shape),
  by ``all_gather_into_tensor``, which every torch release since 2.0 has
  (2.13 warns that it is deprecated for ``all_gather_single``).  Its
  backward is the exact transpose, a reduce-scatter
  (``reduce_scatter_tensor``: the gradients summed over the axis, this
  rank's block kept), for an objective that is the sum of every rank's
  loss (the partitioned solve's interface systems, and the spatial
  classifiers' gather, whose loss each spatial rank divides by the axis
  size).
* ``all_to_all``: JAX's tiled ``all_to_all`` (split one dim into S
  chunks, chunk j to rank j, the received chunks concatenated along
  another dim in rank order); its backward the inverse swap.
* ``halo_exchange``: each rank's first row to the previous rank and its
  last row to the next (``batch_isend_irecv``), zeros where the global
  edge has no neighbour; its backward sends each received row's gradient
  back to its owner.

All-reduces and gathers sum or stack in a fixed order on every backend, so
the ranks stay bit for bit alike; a CUDA graph captures them once their
communicators exist (NCCL makes one at a group's first collective).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["copy_to", "reduce_from", "gather_from", "all_gather",
           "gather_dim", "all_to_all", "halo_exchange"]


def _all_reduce(x, group):
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x, mesh, axis="model"):
    """Identity forward; the gradient all-reduced over ``axis``."""
    group, _, size = mesh.axis(axis)
    return x if size == 1 else _CopyTo.apply(x, group)


def reduce_from(x, mesh, axis="model"):
    """``x`` all-reduced (summed) over ``axis``; the gradient passes."""
    group, _, size = mesh.axis(axis)
    return x if size == 1 else _ReduceFrom.apply(x, group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group = group
        flat = x.reshape(1, -1).contiguous()
        out = x.new_empty((size, flat.shape[1]))
        dist.all_gather_into_tensor(out, flat, group=group)
        return out.reshape((size,) + tuple(x.shape))

    @staticmethod
    def backward(ctx, g):
        out = g.new_empty(g[0].numel())
        dist.reduce_scatter_tensor(out, g.contiguous().reshape(-1),
                                   group=ctx.group)
        return out.reshape(g.shape[1:]), None, None


def all_gather(x, mesh, axis):
    """(S, *x.shape): every rank's ``x`` along ``axis``, in axis order;
    the backward is the reduce-scatter of the gradient."""
    group, _, size = mesh.axis(axis)
    if size == 1:
        return x[None]
    return _AllGather.apply(x, group, size)


def gather_dim(x, mesh, axis, dim):
    """Every rank's ``x`` concatenated along ``dim`` in axis order (a
    sharded dim made whole); the backward is the reduce-scatter."""
    g = all_gather(x, mesh, axis)
    if g.shape[0] == 1:
        return x
    dim = dim % x.dim()
    shape = list(x.shape)
    shape[dim] *= g.shape[0]
    return g.movedim(0, dim).reshape(shape)


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.block, ctx.dim = mesh.axis(axis)[1:], dim
        with torch.no_grad():
            return gather_dim(x.detach(), mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        index, size = ctx.block
        n = g.shape[ctx.dim] // size
        return g.narrow(ctx.dim, index * n, n), None, None, None


def gather_from(x, mesh, axis="model", dim=-1):
    """Every rank's ``x`` along ``axis`` concatenated along ``dim``; the
    gradient of this rank's block is its slice of the whole one."""
    _, _, size = mesh.axis(axis)
    return x if size == 1 else _GatherFrom.apply(x, mesh, axis,
                                                 dim % x.dim())


def _swap(x, group, size, split_dim, concat_dim):
    inp = torch.stack(x.chunk(size, dim=split_dim)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, split_dim, concat_dim):
        ctx.conf = (group, size, split_dim, concat_dim)
        return _swap(x, group, size, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, size, split_dim, concat_dim = ctx.conf
        return _swap(g, group, size, concat_dim, split_dim), None, None, \
            None, None


def all_to_all(x, mesh, axis, split_dim, concat_dim):
    """JAX's tiled ``all_to_all``: ``split_dim`` cut into S equal chunks,
    chunk j to the j-th rank of ``axis``, the chunks received concatenated
    along ``concat_dim`` in axis order."""
    group, _, size = mesh.axis(axis)
    if size == 1:
        return x
    if x.shape[split_dim] % size:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split into {size}")
    return _AllToAll.apply(x, group, size, split_dim % x.dim(),
                           concat_dim % x.dim())


def _exchange(mesh, axis, to_prev, to_next):
    """``to_prev`` to the previous rank along ``axis`` and ``to_next`` to
    the next; returns (from_prev, from_next), zeros at the global edges."""
    _, index, size = mesh.axis(axis)
    from_prev = torch.zeros_like(to_next)
    from_next = torch.zeros_like(to_prev)
    ops = []
    if index > 0:
        prev = mesh.peer(axis, index - 1)
        ops += [dist.P2POp(dist.isend, to_prev.contiguous(), prev),
                dist.P2POp(dist.irecv, from_prev, prev)]
    if index < size - 1:
        nxt = mesh.peer(axis, index + 1)
        ops += [dist.P2POp(dist.isend, to_next.contiguous(), nxt),
                dist.P2POp(dist.irecv, from_next, nxt)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_prev, from_next


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, first, last, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _exchange(mesh, axis, first, last)

    @staticmethod
    def backward(ctx, g_prev, g_next):
        g_first, g_last = _exchange(ctx.mesh, ctx.axis, g_prev, g_next)
        return g_first, g_last, None, None


def halo_exchange(first, last, mesh, axis="spatial"):
    """(from_prev, from_next): the previous rank's ``last`` and the next
    rank's ``first`` along ``axis`` (zeros at the global edges), for this
    rank's ``first`` and ``last`` rows."""
    _, _, size = mesh.axis(axis)
    if size == 1:
        return torch.zeros_like(last), torch.zeros_like(first)
    return _Halo.apply(first, last, mesh, axis)
