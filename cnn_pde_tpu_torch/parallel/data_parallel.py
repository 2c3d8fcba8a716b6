"""Data-parallel training — port of ``cnn_pde_tpu/parallel/data_parallel.py``.

JAX's data parallelism is one global-view program: its step equals a
single-device step on the whole global batch.  The port runs one process a
device in a ``torch.distributed`` process group (NCCL on the card, gloo on
the CPU; ``multihost.initialize``) and keeps those global semantics, each
rank computing its rows of the single-device step:

* loss and gradients: each rank's loss is the sum over its rows divided by
  the global batch (its mean over its block / world), so the gradients
  summed across ranks are the global batch's; they are summed in one flat
  buffer by one all-reduce a step (with the loss and the accuracy beside
  them), a fixed order that a CUDA graph captures, and the clip's global
  norm is taken after the sum;
* BatchNorm in train mode (``sync_batch_norms``): each channel's
  statistics over the global batch.  Each rank's mean and sum of squared
  deviations are gathered (Chan's combination, in rank order, the same on
  every rank), and the backward gathers the sums of dy and dy·x̂ the same
  way; the running statistics take the global mean and the unbiased global
  variance, as the single-device BatchNorm does.  In a world of one the
  local batch is the global one, and torch's own batch norm runs.
  ``torch.nn.SyncBatchNorm`` refuses CPU tensors, so the gloo ranks could
  not use it;
* random draws (dropout masks, augmentation): every rank draws for the
  global batch from the same generator state and keeps its own block.

A gather is an all-reduce of a zero buffer with the rank's block written
in: exact, deterministic, and one call that NCCL, gloo and a CUDA graph
all take.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

__all__ = ["make_dp_train_step", "make_train_step_body", "shard_batch",
           "replicate", "sync_batch_norms", "spec_block",
           "GlobalBatchNorm1d", "GlobalBatchNorm2d"]


def _gather_rows(mesh, x, axis="data"):
    """Every rank's equal-shaped ``x`` along ``axis`` stacked along dim 0
    in axis order, on every rank (the all-reduce of a zero buffer holding
    this rank's block)."""
    group, index, size = mesh.axis(axis)
    if size == 1:
        return x
    buf = x.new_zeros((size,) + tuple(x.shape))
    buf[index].copy_(x)
    dist.all_reduce(buf, group=group)
    return buf.reshape((size * x.shape[0],) + tuple(x.shape[1:]))


def _check_mesh(mesh):
    if mesh.group is None and mesh.size > 1:
        raise ValueError(
            f"data-parallel training over {mesh.size} devices runs one "
            "process a device: bring up a process group first "
            "(parallel/multihost.py::initialize, or torchrun)")


def _rows(mesh, n):
    """This rank's block [lo, hi) of a global batch of ``n`` rows (its
    block along the 'data' axis)."""
    _, index, size = mesh.axis("data")
    if n % size:
        raise ValueError(f"global batch {n} is not divisible by the 'data' "
                         f"axis size {size}")
    per = n // size
    return index * per, (index + 1) * per


def shard_batch(mesh, batch):
    """This process's rows of a global batch (a tensor, array, or a tuple,
    list or dict of them), as tensors on its device.  In a process group
    every process passes the whole global batch and keeps its block along
    the 'data' axis; a single-process mesh of one device keeps all of
    it."""
    _check_mesh(mesh)

    def make(x):
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x)
        lo, hi = _rows(mesh, x.shape[0])
        return x[lo:hi].to(mesh.device)

    if isinstance(batch, dict):
        return {k: make(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(make(v) for v in batch)
    return make(batch)


def spec_block(mesh, x, spec):
    """This rank's block of ``x`` along each dim that ``spec`` (a tuple of
    axis names or None a dim, as ``Trainer(image_spec=)``) shards over an
    axis other than 'data' (the rows are cut by ``shard_batch``)."""
    for dim, name in enumerate(spec):
        if name is None or name == "data":
            continue
        _, index, size = mesh.axis(name)
        if x.shape[dim] % size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over the {name!r} axis of {size}")
        n = x.shape[dim] // size
        x = x.narrow(dim, index * n, n)
    return x.contiguous()


def replicate(mesh, tree):
    """The same value on every rank, on this process's device.  A module
    gets rank 0's parameters and buffers broadcast into it in place (and
    is returned); tensors and arrays (every process passes the same full
    value) are moved to the device."""
    if isinstance(tree, nn.Module):
        if mesh.group is not None:
            with torch.no_grad():
                for t in list(tree.parameters()) + list(tree.buffers()):
                    dist.broadcast(t.data, src=0, group=mesh.group)
        return tree

    def make(x):
        return torch.as_tensor(x).to(mesh.device)

    if isinstance(tree, dict):
        return {k: make(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(make(v) for v in tree)
    return make(tree)


# ---------------------------------------------------------------- BatchNorm

_GLOBAL_BN = weakref.WeakKeyDictionary()  # BatchNorm module -> mesh


class _GlobalBatchNormFn(torch.autograd.Function):
    """Train-mode batch norm over the global batch of a mesh's ranks.
    Returns the output, the global mean and the unbiased global variance
    (the last two without gradient)."""

    @staticmethod
    def forward(ctx, x, weight, bias, mesh, eps):
        dims = [0] + list(range(2, x.dim()))
        shape = [1, x.shape[1]] + [1] * (x.dim() - 2)
        n = x.numel() // x.shape[1]
        mean_l = x.mean(dims)
        m2_l = (x - mean_l.view(shape)).square().sum(dims)
        parts = _gather_rows(mesh, torch.stack([mean_l, m2_l])[None])
        means = parts[:, 0]
        mean = means.mean(0)
        m2 = parts[:, 1].sum(0) + n * (means - mean).square().sum(0)
        total = n * parts.shape[0]
        invstd = torch.rsqrt(m2 / total + eps)
        xhat = (x - mean.view(shape)) * invstd.view(shape)
        y = xhat if weight is None else (xhat * weight.view(shape)
                                         + bias.view(shape))
        ctx.save_for_backward(xhat, weight, invstd)
        ctx.mesh, ctx.total = mesh, total
        unbiased = m2 / max(total - 1, 1)
        ctx.mark_non_differentiable(mean, unbiased)
        return y, mean, unbiased

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        xhat, weight, invstd = ctx.saved_tensors
        dims = [0] + list(range(2, dy.dim()))
        shape = [1, dy.shape[1]] + [1] * (dy.dim() - 2)
        sum_dy = dy.sum(dims)
        sum_dy_xhat = (dy * xhat).sum(dims)
        sums = _gather_rows(ctx.mesh, torch.stack([sum_dy, sum_dy_xhat])[None]
                            ).reshape(-1, 2, sum_dy.shape[0]).sum(0)
        scale = invstd if weight is None else weight * invstd
        dx = scale.view(shape) * (dy - (sums[0] / ctx.total).view(shape)
                                  - xhat * (sums[1] / ctx.total).view(shape))
        if weight is None:
            return dx, None, None, None, None
        # the affine parameters' own rows: the step's gradient all-reduce
        # sums them across the ranks
        return dx, sum_dy_xhat, sum_dy, None, None


class _GlobalBatchNorm:
    """A BatchNorm whose train-mode statistics span the global batch of the
    mesh ``sync_batch_norms`` registered it with (eval mode, and a module
    not registered, behave as the base class)."""

    def forward(self, x):
        mesh = _GLOBAL_BN.get(self)
        # a 'data' axis of one: the local batch is the global one
        if mesh is None or not self.training or mesh.shape["data"] == 1:
            return super().forward(x)
        self._check_input_dim(x)
        y, mean, var = _GlobalBatchNormFn.apply(x, self.weight, self.bias,
                                                mesh, self.eps)
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                f = (1.0 / self.num_batches_tracked.float()
                     if self.momentum is None else self.momentum)
                self.running_mean.copy_(mean * f
                                        + self.running_mean * (1 - f))
                self.running_var.copy_(var * f + self.running_var * (1 - f))
        return y


class GlobalBatchNorm1d(_GlobalBatchNorm, nn.BatchNorm1d):
    pass


class GlobalBatchNorm2d(_GlobalBatchNorm, nn.BatchNorm2d):
    pass


_GLOBAL_CLASSES = {nn.BatchNorm1d: GlobalBatchNorm1d,
                   nn.BatchNorm2d: GlobalBatchNorm2d}


def sync_batch_norms(model, mesh):
    """Make every BatchNorm1d/2d of ``model`` take its train-mode
    statistics over ``mesh``'s global batch (its class becomes the global
    subclass, its parameters, buffers and state_dict names unchanged).
    Returns the number of BatchNorms."""
    n = 0
    for m in model.modules():
        cls = _GLOBAL_CLASSES.get(type(m))
        if cls is not None:
            m.__class__ = cls
        if isinstance(m, _GlobalBatchNorm):
            _GLOBAL_BN[m] = mesh
            n += 1
    return n


# ---------------------------------------------------------------- the step

class StepReducer:
    """The collectives of a data-parallel ``TrainStep``: the gradients, the
    loss and the accuracy summed in one flat buffer (made once: a CUDA
    graph captures the same all-reduce each step) over the mesh's
    ('data', 'spatial') plane.  Each rank's loss is its rows' share,
    divided by ``world`` = data·spatial: the ranks of the spatial axis
    hold the same rows and each takes 1/S of the loss (the spatial
    gathers' backward sums their gradients, ``collectives.all_gather``);
    the ranks of the 'model' axis share one copy of the loss and reduce
    apart (``tensor_parallel.py``).  ``rows`` = ('data' index, 'data'
    size) for the global draws."""

    def __init__(self, mesh, model, params):
        self.mesh = mesh
        _, index, size = mesh.axis("data")
        self.rows = (index, size)
        self.group, _, self.world = mesh.axis("data", "spatial")
        device = params[0].device
        numels = [p.numel() for p in params]
        self.flat = torch.zeros(sum(numels) + 2, device=device)
        self.views = [v.view_as(p) for v, p in
                      zip(self.flat[:-2].split(numels), params)]
        sync_batch_norms(model, mesh)
        # every communicator of the step exists before any capture: NCCL
        # makes one at a group's first collective
        groups = [mesh.group] + [mesh.axis(*names)[0] for names in
                                 (("data", "spatial"), ("data",),
                                  ("spatial",), ("model",))]
        for group in dict.fromkeys(g for g in groups if g is not None):
            dist.all_reduce(torch.zeros(1, device=device), group=group)

    def reduce(self, grads, loss, acc):
        """Sum ``grads`` in place across the plane; returns the summed
        (loss, acc) as new tensors."""
        torch._foreach_copy_(self.views, grads)
        self.flat[-2:].copy_(torch.stack([loss, acc]))
        if self.world > 1:
            dist.all_reduce(self.flat, group=self.group)
        torch._foreach_copy_(grads, self.views)
        return self.flat[-2].clone(), self.flat[-1].clone()


def make_train_step_body(model, train_values, mesh=None, *,
                         steps_per_epoch=1, generator=None, **kwargs):
    """The one train-step body the host loop, the device epoch and the
    data-parallel step share: ``TrainStep.body(x, y, apply)`` of a step
    over ``mesh`` (None: a single device).  ``kwargs``: the rest of
    ``make_train_step``'s arguments."""
    return make_dp_train_step(model, train_values, mesh,
                              steps_per_epoch=steps_per_epoch,
                              generator=generator, **kwargs).body


def make_dp_train_step(model, train_values, mesh, *, steps_per_epoch=1,
                       generator=None, **kwargs):
    """A ``TrainStep`` of ``model`` over ``mesh``: called on this process's
    rows of a global batch (``shard_batch``), it takes its part of the
    single-device step on the whole batch and returns the global loss and
    accuracy.  Rank 0's weights are broadcast into ``model`` first
    (``replicate``).  ``generator``: the draws' generator on the model's
    device, seeded alike on every rank (default: seed 0).  ``kwargs``: the
    rest of ``make_train_step``'s arguments."""
    from ..train.step import TrainStep

    device = next(model.parameters()).device
    if mesh is not None and getattr(model, "tp_layout", None) is None:
        replicate(mesh, model)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    return TrainStep(model, train_values, steps_per_epoch, generator,
                     mesh=mesh, **kwargs)
