"""Branch parallelism — port of ``cnn_pde_tpu/parallel/branch_parallel.py``.

The flagship's ``MultiScaleExtractor`` evolves three independent Strang
branches.  The hoisted lockstep (``pde/fused_multiscale.py``) stacks them
on a branch axis K that is a pure batch axis throughout (the mixing
reduces over C, the sweeps over H and W), so splitting K over a mesh
axis needs no collective inside the evolution: each rank evolves only its
block of branches, and one all-gather over the axis hands every rank all
of them where the attention gates read them.

JAX's GSPMD pads an uneven split; the port does the same with blocks of
ceil(K / M) branches (3 over 2 ranks: 2 + 1; over 4: 1 + 1 + 1 + 0), the
gather padded to equal blocks.  Every rank of the axis computes the same
loss on the same rows, so:

* the gather's backward keeps this rank's block of the gradient (it does
  not sum: ``collectives.all_gather``'s reduce-scatter backward, right for
  spatial ranks that each take 1/S of the loss, would multiply the branch
  gradients by M here);
* a branch's parameters get their gradient only on the rank that owns the
  branch, so the stacked parameters enter through ``copy_to`` (one
  all-reduce of their gradient over the axis a backward), and every rank
  ends the backward with each branch's gradient counted once: every
  replica takes the same AdamW step and the clip's global norm counts
  each branch once.  The gather takes the stacked parameters as a second
  input whose gradient is zero, so that a rank without a branch still
  joins that all-reduce.

It composes with data parallelism over 'data' (``Trainer(mesh=)``, host
loop and device epoch, the collectives captured in the device epoch's
graph).  Combined with tensor parallelism or spatial sharding
(``Trainer(tp=, image_spec=)``) it is not covered and the Trainer raises.
Checkpoints stay unsharded: the parameters are whole on every rank.
"""

from __future__ import annotations

import torch

from ..models.cifar10_noconv import MultiScaleExtractor
from ..pde.amp import iter_modules
from .collectives import copy_to, gather_dim

__all__ = ["enable_branch_parallel", "branch_parallel_extractors",
           "shared_branches", "gather_branches"]


def enable_branch_parallel(model, mesh, *, axis="model"):
    """Switch every ``MultiScaleExtractor`` of ``model`` to the hoisted
    lockstep with its branch axis split over ``mesh``'s ``axis``.  Returns
    the number of extractors switched.  The parameter layout is untouched,
    so checkpoints and the optimizer's groups are unaffected."""
    n = 0
    for ext in iter_modules(model, MultiScaleExtractor):
        ext.branch_mesh, ext.branch_axis = mesh, axis
        n += 1
    return n


def branch_parallel_extractors(model):
    """The extractors of ``model`` that ``enable_branch_parallel``
    switched."""
    return [ext for ext in iter_modules(model, MultiScaleExtractor)
            if ext.branch_mesh is not None]


def shared_branches(stacks, mesh, axis):
    """(flat, views): the stacked branch parameters joined into one flat
    tensor through ``copy_to`` over ``axis`` (the identity forward, one
    all-reduce of the gradient backward) and the stacks as views of it."""
    sizes = [t.numel() for t in stacks]
    flat = copy_to(torch.cat([t.reshape(-1) for t in stacks]), mesh, axis)
    return flat, [v.view_as(t) for v, t in zip(flat.split(sizes), stacks)]


class _GatherBranches(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, flat, mesh, axis):
        ctx.index = mesh.axis(axis)[1]
        ctx.n = local.shape[1]
        ctx.save_for_backward(flat)
        with torch.no_grad():
            return gather_dim(local.detach(), mesh, axis, 1)

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        return (g.narrow(1, ctx.index * ctx.n, ctx.n),
                torch.zeros_like(flat), None, None)


def gather_branches(local, flat, mesh, axis):
    """Every rank's equal block of branches ``local`` (B, n, C, H, W) along
    ``axis``, concatenated along the branch dim in axis order: one
    all-gather.  The backward keeps this rank's block of the gradient and
    gives ``flat`` (``shared_branches``' tensor) a zero one."""
    return _GatherBranches.apply(local, flat, mesh, axis)
