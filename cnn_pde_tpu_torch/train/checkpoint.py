"""Checkpoint and resume — port of ``cnn_pde_tpu/train/checkpoint.py``.

A checkpoint holds what a resumed run needs to continue as if it had not
stopped: the model's ``state_dict`` (parameters and BatchNorm statistics,
under the reference's names), the optimizer's ``state_dict``, the step
count, the train step's own counters (``make_train_step``: updates,
micro-step and the accumulated gradients of ``grad_accum``), the device
generator's state (augmentation and dropout draws) and ``extra`` (fit's
``best_acc``/``patience_count``/``epoch``), as ``<dir>/<tag>.ckpt``
written by ``torch.save`` to a temporary file and renamed over the old
one.  The JAX package's ``orbax`` backend has no PyTorch counterpart and
raises.

A model sharded by tensor parallelism (``parallel/tensor_parallel.py``,
``model.tp_layout``) is saved unsharded: every rank gathers the blocks of
its parameters, their Adam moments and accumulated gradients (a
collective, so every rank calls ``save_checkpoint``), and rank 0 writes;
``restore_state`` gives each rank its block back.
"""

from __future__ import annotations

import concurrent.futures
import os

import torch

__all__ = ["save_checkpoint", "save_checkpoint_async",
           "wait_for_checkpoints", "load_checkpoint", "restore_state",
           "model_state_dict"]

BACKENDS = ("pickle",)


def _check_backend(backend):
    if backend not in BACKENDS:
        raise NotImplementedError(
            f"checkpoint backend {backend!r} has no PyTorch counterpart in "
            f"the port; use one of {BACKENDS} (torch.save)")


def _map_tensors(fn, tree):
    """``tree`` (dicts, lists, tuples, tensors, plain values) with ``fn``
    applied to every tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def _param_names(state):
    """The parameter names of the optimizer's state indices and of the
    train step's accumulated gradients, in their orders."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    opt = [names[id(p)] for g in state.optimizer.param_groups
           for p in g["params"]]
    return opt, [n for n, _ in state.model.named_parameters()]


def _reshard(state, payload, fn):
    """``payload`` with ``fn(name, tensor)`` applied to each parameter-
    shaped tensor: the model's, the optimizer's moments and the train
    step's accumulated gradients, in one order on every rank."""
    opt_names, step_names = _param_names(state)
    payload["model"] = {k: fn(k, v) for k, v in payload["model"].items()}
    osd = payload["optimizer"]
    osd["state"] = {i: {k: (fn(opt_names[int(i)], v) if k != "step" else v)
                        for k, v in st.items()}
                    for i, st in sorted(osd["state"].items())}
    acc = payload["train_step"].get("acc")
    if acc is not None:
        payload["train_step"]["acc"] = [fn(n, a)
                                        for n, a in zip(step_names, acc)]
    return payload


def _payload(state, extra):
    payload = {"model": state.model.state_dict(),
               "optimizer": state.optimizer.state_dict(),
               "step": int(state.step),
               "train_step": state.train_step.state_dict(),
               "generator": state.generator.get_state()}
    layout = getattr(state.model, "tp_layout", None)
    if layout is not None:
        payload = _reshard(state, payload, layout.whole)
    if extra:
        payload["extra"] = dict(extra)
    return payload


def _writes(state):
    """Whether this process writes: rank 0 of a sharded model's mesh (the
    others only gather), or the one process."""
    layout = getattr(state.model, "tp_layout", None)
    return layout is None or layout.mesh.rank == 0


def _write(directory, tag, payload):
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{tag}.ckpt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(_map_tensors(lambda t: t.detach().to("cpu", copy=True),
                            payload), tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(directory, state, tag="last", backend="pickle",
                    extra=None):
    """Save ``state`` (a ``loop.TrainState``) as ``<directory>/<tag>.ckpt``;
    ``extra``: a flat dict of plain numbers saved beside it.  Returns the
    path (None on a rank of a sharded model that does not write)."""
    _check_backend(backend)
    payload = _payload(state, extra)
    return _write(directory, tag, payload) if _writes(state) else None


class _Saver:
    """One worker thread that writes checkpoints in order, and the saves
    not yet waited on."""

    def __init__(self):
        self.executor = None
        self.pending = []


_SAVER = _Saver()


def save_checkpoint_async(directory, state, tag="last", backend="pickle",
                          extra=None):
    """``save_checkpoint`` off the training thread.  The snapshot is copies
    of the tensors made on their device before this returns (the train
    step updates the live ones in place), queued in the stream order; the
    worker copies them to the host and writes the file.  One worker
    serialises the saves.  Returns a Future; ``wait_for_checkpoints()``
    before reading the files or exiting."""
    _check_backend(backend)
    snapshot = _map_tensors(torch.clone, _payload(state, extra))
    if not _writes(state):
        fut = concurrent.futures.Future()
        fut.set_result(None)
        return fut
    if _SAVER.executor is None:
        _SAVER.executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt")
    fut = _SAVER.executor.submit(_write, directory, tag, snapshot)
    _SAVER.pending.append(fut)
    return fut


def wait_for_checkpoints():
    """Block until every async save has landed; re-raises the first
    failure.  Returns the number of saves waited on."""
    pending, _SAVER.pending = _SAVER.pending, []
    for fut in pending:
        fut.result()
    return len(pending)


def load_checkpoint(directory, tag="last"):
    """The payload of ``<directory>/<tag>.ckpt`` (tensors on the CPU).
    The file is read with ``weights_only=True``: tensors, containers and
    plain values only."""
    path = os.path.join(directory, f"{tag}.ckpt")
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_state(state, directory, tag="last"):
    """Restore ``state`` (a ``loop.TrainState`` made for the same model and
    optimizer) in place from ``<directory>/<tag>.ckpt``; the model loads
    with ``strict=True``.  Returns the state."""
    payload = load_checkpoint(directory, tag)
    layout = getattr(state.model, "tp_layout", None)
    if layout is not None:
        payload = _reshard(state, payload, layout.local)
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.train_step.load_state_dict(payload["train_step"])
    state.generator.set_state(payload["generator"])
    state.step = int(payload["step"])
    return state


def model_state_dict(directory, tag="best"):
    """The model ``state_dict`` of a checkpoint, for serving."""
    return load_checkpoint(directory, tag)["model"]

