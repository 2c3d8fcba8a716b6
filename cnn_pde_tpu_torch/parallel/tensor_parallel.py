"""Tensor parallelism for the FC stacks and the Ruthotto K — port of
``cnn_pde_tpu/parallel/tensor_parallel.py``: Megatron column/row sharding
over the mesh's 'model' axis.

JAX writes it as GSPMD sharding annotations and lets XLA insert the
collectives.  The port runs one process a device, so it writes them: each
rank keeps its block of every sharded tensor, and the sharded modules
call Megatron's two operators (``collectives.copy_to`` before a
column-parallel product, ``collectives.reduce_from`` after a row-parallel
one).

``tp_param_specs`` is JAX's walker over the port's modules.  A chain is an
``nn.Sequential`` holding ``nn.Linear``s, or one of the MLP classifiers
whose children are JAX's 'head' Sequential (``HEAD_CHAINS``); along a
chain the Linears alternate column/row parallel, a BatchNorm between the
two riding the column shard.  A Linear too small to split
(``min_features``) or not divisible by the axis size stays replicated and
the carry resets, so attention MLPs and class heads stay whole.  A
``SymmetricLayer``'s K is sharded on its out features, its ``norm``
riding the shard.  At axis size 1 everything is replicated.

Specs are keyed by ``state_dict`` name, in torch's layout: a tuple with
the axis name at the sharded dim.  JAX's ``w`` is (in, out) where torch's
``weight`` is (out, in), so JAX's ``P(None, 'model')`` (column) is
``('model', None)`` here and ``P('model', None)`` (row) is
``(None, 'model')``; ``()`` is replicated.

``shard_pytree(mesh, model, specs)`` keeps this rank's block of every
sharded tensor in place and turns the Linears into ``ColumnParallelLinear``
/ ``RowParallelLinear`` (their ``state_dict`` names unchanged); a chain
that ends on a column-parallel Linear (the hybrid's attention MLP) gathers
its output.  Dropout between a column and a row Linear draws the global
mask and keeps this rank's feature block (``FeatureBlock``, shared by a
sharded model's Linears and Dropouts).  ``full_state_dict`` gathers the
unsharded ``state_dict`` and ``load_full_state_dict`` slices one back,
so checkpoints keep the unsharded names and shapes.

The train step (``make_tp_train_step``, the DP step's signature) reduces
every gradient over the 'data' axis only: a parameter upstream of a
column-parallel product already carries the whole gradient through
``copy_to``'s all-reduce, and a sharded one its block's.  A sum over the
parameters (the clip's global norm, the regulariser's K term) is the
unsharded model's through ``TPLayout.total``: the sharded blocks' terms
summed over 'model', the replicated tensors' counted once.

    mesh = make_mesh(data=2, model=2)       # in a process group of 4
    specs = tp_param_specs(model, mesh)
    shard_pytree(mesh, model, specs)
    step = make_tp_train_step(model, PRESETS[name]["train"], mesh)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..models.cifar10_noconv import Dropout
from ..models.mlp_models import (FashionClassifier, MNISTClassifier,
                                 SVHNClassifier)
from ..pde.ruthotto import SymmetricLayer
from .collectives import copy_to, gather_dim, gather_from, reduce_from
from .data_parallel import make_dp_train_step
from .data_parallel import replicate as replicated_like  # same operation

__all__ = ["tp_param_specs", "shard_pytree", "make_tp_train_step",
           "replicated_like", "ColumnParallelLinear", "RowParallelLinear",
           "TPLayout", "FeatureBlock", "full_state_dict",
           "load_full_state_dict", "model_total", "HEAD_CHAINS"]

AXIS = "model"
# modules whose children are, in order, the JAX model's 'head' Sequential
HEAD_CHAINS = (MNISTClassifier, FashionClassifier, SVHNClassifier)
_BN = (nn.BatchNorm1d, nn.BatchNorm2d)


def _is_chain(m):
    if isinstance(m, HEAD_CHAINS):
        return True
    return isinstance(m, nn.Sequential) and any(
        isinstance(c, nn.Linear) for c in m.children())


def _shard_bn(prefix, bn, axis, specs):
    for name in ("weight", "bias", "running_mean", "running_var"):
        if getattr(bn, name, None) is not None:
            specs[prefix + name] = (axis,)


def _symmetric_specs(prefix, layer, tp, axis, min_features, specs):
    """K.weight (D, D) split on its out features (dim 0), JAX's
    ``P(None, axis)`` on ``w``; the norm rides the shard."""
    D = layer.K.weight.shape[0]
    if D % tp or D < min_features:
        return
    specs[prefix + "K.weight"] = (axis, None)
    _shard_bn(prefix + "norm.", layer.norm, axis, specs)


def _chain_specs(prefix, chain, tp, axis, min_features, specs):
    """Column/row alternation along one chain; returns the carry at its
    end (True: its output is feature-sharded and must be gathered)."""
    carry = False
    for name, m in chain.named_children():
        p = f"{prefix}{name}."
        if isinstance(m, nn.Linear):
            fout, fin = m.weight.shape
            if not carry and fout % tp == 0 and fout >= min_features:
                specs[p + "weight"] = (axis, None)
                if m.bias is not None:
                    specs[p + "bias"] = (axis,)
                carry = True
            elif carry and fin % tp == 0:
                specs[p + "weight"] = (None, axis)
                carry = False
            else:
                carry = False
        elif isinstance(m, _BN) and m.affine and carry:
            _shard_bn(p, m, axis, specs)
    return carry


def tp_param_specs(model, mesh, *, axis=AXIS, min_features=128):
    """{state_dict name: spec} for ``model``: Megatron col/row alternation
    in every FC chain, each SymmetricLayer's K on its out features, ``()``
    (replicated) everywhere else.  ``min_features``: a Linear starts a
    column-parallel pair only when its out features are at least this and
    divisible by the axis size."""
    specs = {name: () for name in model.state_dict()}
    tp = mesh.shape[axis]
    if tp == 1:
        return specs

    def walk(module, prefix):
        if isinstance(module, SymmetricLayer):
            _symmetric_specs(prefix, module, tp, axis, min_features, specs)
        elif _is_chain(module):
            _chain_specs(prefix, module, tp, axis, min_features, specs)
        else:
            for name, child in module.named_children():
                walk(child, f"{prefix}{name}.")

    walk(model, "")
    return specs


# ---------------------------------------------------------------- modules

class FeatureBlock:
    """Which block of the features a sharded model's activations are,
    while its forward runs between a column- and a row-parallel Linear:
    (index, size) along the model axis, else None.  One a model, shared by
    its sharded Linears (which set it) and its Dropouts (which draw the
    global mask and keep the block, ``models.cifar10_noconv.Dropout``)."""

    def __init__(self):
        self.block = None


class ColumnParallelLinear(nn.Linear):
    """A Linear holding this rank's block of the out features (weight rows,
    bias): identity forward of its input with the gradient all-reduced
    over the axis (``copy_to``), and its output that block of the
    features (gathered at the end of a chain that ends here,
    ``_GatheredChain``)."""

    def forward(self, x):
        mesh, axis = self.tp
        y = F.linear(copy_to(x, mesh, axis), self.weight, self.bias)
        self.features.block = mesh.axis(axis)[1:]
        return y


class RowParallelLinear(nn.Linear):
    """A Linear holding this rank's block of the in features (weight
    columns): its partial products summed over the axis (``reduce_from``:
    one all-reduce), then the replicated bias."""

    def forward(self, x):
        self.features.block = None
        y = reduce_from(F.linear(x, self.weight), *self.tp)
        return y if self.bias is None else y + self.bias


class _GatheredChain(nn.Sequential):
    """A chain that ends on a column-parallel Linear: its output gathered
    to all features (``gather_from``)."""

    def forward(self, x):
        y = super().forward(x)
        self.features.block = None
        return gather_from(y, *self.tp)


# ---------------------------------------------------------------- layout

class TPLayout:
    """The sharding of a model: its mesh, axis and specs."""

    def __init__(self, mesh, axis, specs):
        self.mesh, self.axis, self.specs = mesh, axis, specs

    def dim(self, name):
        """The sharded dim of ``name``, or None."""
        spec = self.specs.get(name, ())
        return spec.index(self.axis) if self.axis in spec else None

    def local(self, name, full):
        """This rank's block of the unsharded tensor ``full``."""
        d = self.dim(name)
        if d is None:
            return full
        _, index, size = self.mesh.axis(self.axis)
        n = full.shape[d] // size
        return full.narrow(d, index * n, n).contiguous()

    def total(self, terms):
        """The sum over the unsharded model of per-parameter scalars:
        ``terms`` is [(state_dict name, 0-d tensor)]; the terms of sharded
        blocks are summed over the model axis in one all-reduce (its
        gradient passed through, ``reduce_from``), every other term counted
        once (collective: every rank calls it for the same names)."""
        own = [t for n, t in terms if self.dim(n) is None]
        blocks = [t for n, t in terms if self.dim(n) is not None]
        if not blocks:
            return _sum(own)
        return _sum(own) + reduce_from(_sum(blocks), self.mesh, self.axis)

    def whole(self, name, t):
        """The unsharded tensor of this rank's block ``t`` (collective:
        every rank calls it for the same names in the same order)."""
        d = self.dim(name)
        if d is None:
            return t
        with torch.no_grad():
            return gather_dim(t, self.mesh, self.axis, d)


def shard_pytree(mesh, model, specs, *, axis=AXIS):
    """Keep this rank's block of every tensor of ``model`` that ``specs``
    shards (in place: new Parameters, so build the optimizer after), and
    make the sharded Linears, SymmetricLayers and chains call their
    collectives.  Records the layout as ``model.tp_layout``; returns the
    model."""
    if getattr(model, "tp_layout", None) is not None:
        raise ValueError("the model is sharded already")
    _, _, size = mesh.axis(axis)
    layout = TPLayout(mesh, axis, specs)
    if size > 1:
        modules = dict(model.named_modules())
        with torch.no_grad():
            for name, spec in specs.items():
                if axis not in spec:
                    continue
                owner, _, leaf = name.rpartition(".")
                m = modules[owner]
                t = getattr(m, leaf)
                block = layout.local(name, t.data)
                if isinstance(t, nn.Parameter):
                    setattr(m, leaf, nn.Parameter(
                        block, requires_grad=t.requires_grad))
                else:
                    m._buffers[leaf] = block
        features = FeatureBlock()
        for name, m in modules.items():
            prefix = f"{name}." if name else ""
            w = specs.get(prefix + "weight")
            if isinstance(m, Dropout):
                m.features = features
            if isinstance(m, nn.Linear) and w:
                m.__class__ = (ColumnParallelLinear if w[0] == axis
                               else RowParallelLinear)
                m.out_features, m.in_features = m.weight.shape
                m.tp, m.features = (mesh, axis), features
            elif isinstance(m, _BN) and specs.get(prefix + "weight"):
                m.num_features = m.weight.shape[0]
            elif (isinstance(m, SymmetricLayer)
                  and specs.get(prefix + "K.weight")):
                m.tp = (mesh, axis)
        for m in modules.values():  # once every Linear has its class
            if (isinstance(m, nn.Sequential) and _is_chain(m)
                    and _ends_sharded(m)):
                m.__class__ = _GatheredChain
                m.tp, m.features = (mesh, axis), features

        def reset(*_):  # a forward interrupted between a column and a
            features.block = None  # row Linear leaves no block behind
        model.register_forward_pre_hook(reset)
    model.tp_layout = layout
    return model


def _ends_sharded(chain):
    """Whether the last Linear of ``chain`` is column-parallel."""
    last = [m for m in chain.children() if isinstance(m, nn.Linear)][-1]
    return isinstance(last, ColumnParallelLinear)


def full_state_dict(model):
    """The unsharded ``state_dict`` of a (possibly sharded) model: every
    sharded tensor gathered over the model axis (a collective)."""
    sd = model.state_dict()
    layout = getattr(model, "tp_layout", None)
    if layout is None:
        return sd
    return {k: layout.whole(k, v) for k, v in sd.items()}


def load_full_state_dict(model, state_dict, strict=True):
    """Load an unsharded ``state_dict`` into a (possibly sharded) model,
    each rank its block."""
    layout = getattr(model, "tp_layout", None)
    if layout is not None:
        state_dict = {k: layout.local(k, torch.as_tensor(v))
                      for k, v in state_dict.items()}
    return model.load_state_dict(state_dict, strict=strict)


def make_tp_train_step(model, train_values, mesh, *, specs=None,
                       steps_per_epoch=1, generator=None, **kwargs):
    """A ``TrainStep`` of ``model`` over a DP×TP ``mesh``: batch rows over
    'data', the FC stacks and Ruthotto K over 'model'.  The model gets rank
    0's weights (``replicated_like``) and is sharded by ``specs`` (default
    ``tp_param_specs``) unless it is sharded already.  ``kwargs``: the rest
    of ``make_train_step``'s arguments."""
    if getattr(model, "tp_layout", None) is None:
        replicated_like(mesh, model)
        shard_pytree(mesh, model, specs or tp_param_specs(model, mesh))
    return make_dp_train_step(model, train_values, mesh,
                              steps_per_epoch=steps_per_epoch,
                              generator=generator, **kwargs)


def _sum(ts):
    return torch.stack(ts).sum() if ts else 0.0


def model_total(model, terms):
    """``TPLayout.total`` of ``model``'s layout; the plain sum of the terms
    of a model that is not sharded (or None)."""
    layout = getattr(model, "tp_layout", None)
    if layout is None:
        return _sum([t for _, t in terms])
    return layout.total(terms)

