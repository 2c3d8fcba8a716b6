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


def _payload(state, extra):
    payload = {"model": state.model.state_dict(),
               "optimizer": state.optimizer.state_dict(),
               "step": int(state.step),
               "train_step": state.train_step.state_dict(),
               "generator": state.generator.get_state()}
    if extra:
        payload["extra"] = dict(extra)
    return payload


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
    path."""
    _check_backend(backend)
    return _write(directory, tag, _payload(state, extra))


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
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.train_step.load_state_dict(payload["train_step"])
    state.generator.set_state(payload["generator"])
    state.step = int(payload["step"])
    return state


def model_state_dict(directory, tag="best"):
    """The model ``state_dict`` of a checkpoint, for serving."""
    return load_checkpoint(directory, tag)["model"]

