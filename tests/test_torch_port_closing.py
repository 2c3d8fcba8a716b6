"""What closes the port against the JAX package: the parallel layer's
CPU paths only when asked for (``make_mesh(device="cpu")``,
``initialize(backend="gloo")``; without CUDA both raise otherwise),
``utils.profile_trace``/``annotate``, and the three tridiagonal oracles
(``ops/tridiag.py``: ``tridiag_solve_scan``, ``tridiag_solve_unrolled``,
``thomas_solve_reference``) against JAX's on seeded numpy systems.

Tolerances: the solves 1e-5 of the largest entry (float32, the same
recurrence; ``thomas_solve_reference`` against JAX's default solver, the
same system); the gradients 1e-4 of each tensor's largest entry.
"""

import json
import os
import re
import socket
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cnn_pde_tpu.ops.tridiag as jax_tridiag
from cnn_pde_tpu_torch import ops
from cnn_pde_tpu_torch.ops import kernels, tridiag
from cnn_pde_tpu_torch.parallel import initialize, make_mesh, multihost
from cnn_pde_tpu_torch.utils import annotate, profile_trace

SOLVE_TOL = 1e-5
GRAD_TOL = 1e-4
ORACLES = ("tridiag_solve_scan", "tridiag_solve_unrolled",
           "thomas_solve_reference")
# (band shape, batch): batch-free bands broadcast against d, as every ADI
# sweep has them; bands as large as d; a line of one and of two rows
SYSTEMS = {"batch_free": ((3, 32), (4,)), "full": ((4, 3, 17), ()),
           "short": ((5, 2), (3,)), "one_row": ((2, 1), (3,))}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """This file's tests on two intra-op threads, the default restored
    after (Tier-1 runs six test processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_cuda(monkeypatch):
    """A machine without CUDA, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---- the parallel layer: the CPU only when asked for ----------------------

def test_make_mesh_without_cuda_raises(no_cuda):
    for kw in ({}, {"data": 1}, {"spatial": 1, "model": 1},
               {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh(**kw)


def test_make_mesh_on_the_cpu_when_asked(no_cuda):
    mesh = make_mesh(device="cpu")
    assert mesh.devices.shape == (1, 1, 1) and mesh.group is None
    assert mesh.device == torch.device("cpu")
    mesh = make_mesh(data=2, model=2, devices=[torch.device("cpu")] * 4)
    assert mesh.shape == {"data": 2, "spatial": 1, "model": 2}
    assert {d.type for d in mesh.devices.flat} == {"cpu"}


def test_mesh_of_a_gloo_group_takes_the_cpu_when_asked(no_cuda):
    """A one-process gloo group: its mesh raises without ``device="cpu"``
    and holds the rank's CPU with it."""
    assert initialize(f"127.0.0.1:{_free_port()}", num_processes=1,
                      process_id=0, backend="gloo") == "initialized"
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh()
        mesh = make_mesh(device="cpu")
        assert mesh.group is not None and mesh.world == 1
        assert list(mesh.devices.flat) == [torch.device("cpu")]
        assert mesh.axis("data") == (None, 0, 1)
    finally:
        torch.distributed.destroy_process_group()


def test_initialize_without_backend_raises_without_cuda(no_cuda,
                                                        monkeypatch):
    """NCCL is the default: without CUDA a configured group raises before
    any bring-up, from arguments or from torchrun's environment; an
    unconfigured process stays a single process."""
    with mock.patch.object(multihost.dist, "init_process_group") as init:
        with pytest.raises(RuntimeError, match="backend='gloo'"):
            initialize("10.0.0.1:1234", 2, 0)
        with pytest.raises(RuntimeError, match="backend='gloo'"):
            initialize("10.0.0.1:1234", 2, 0, backend="nccl")
        assert initialize() == "single_process"
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("RANK", "1")
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        with pytest.raises(RuntimeError, match="backend='gloo'"):
            initialize()
        init.assert_not_called()


def test_initialize_gloo_when_asked(no_cuda):
    with mock.patch.object(multihost.dist, "init_process_group") as init:
        assert initialize("10.0.0.1:1234", 4, 3,
                          backend="gloo") == "initialized"
        init.assert_called_once_with("gloo", init_method="tcp://10.0.0.1:1234",
                                     world_size=4, rank=3)


# ---- profile_trace and annotate -------------------------------------------

def test_profile_trace_writes_an_annotated_trace(tmp_path):
    """On the CPU when asked: the trace file is JSON, holds the span of
    ``annotate`` and the ops under it; the block's value passes out."""
    logdir = str(tmp_path / "trace")
    with profile_trace(logdir, device="cpu") as where:
        assert where == logdir
        with annotate("closing_span"):
            y = torch.ones(64, 64) @ torch.ones(64, 64)
    assert float(y[0, 0]) == 64.0
    files = os.listdir(logdir)
    assert len(files) == 1
    assert re.fullmatch(rf"trace_{os.getpid()}_\d+\.json", files[0]), files
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "closing_span" in names and "aten::mm" in names


def test_profile_trace_keeps_every_trace_of_a_process(tmp_path):
    """Two blocks in one process and directory leave two files, each with
    its own span and not the other's."""
    logdir = str(tmp_path / "trace")
    for span in ("first", "second"):
        with profile_trace(logdir, device="cpu"):
            with annotate(span):
                torch.ones(8, 8) @ torch.ones(8, 8)
    files = sorted(os.listdir(logdir),
                   key=lambda f: int(f.rsplit("_", 1)[1].split(".")[0]))
    assert len(files) == 2, files
    for name, span, other in ((files[0], "first", "second"),
                              (files[1], "second", "first")):
        assert re.fullmatch(rf"trace_{os.getpid()}_\d+\.json", name), name
        with open(os.path.join(logdir, name)) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert span in names and other not in names, (name, span)


def test_profile_trace_without_cuda_raises(no_cuda, tmp_path):
    logdir = tmp_path / "trace"
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            with profile_trace(str(logdir), **kw):
                pass
    assert not logdir.exists()


# ---- the tridiagonal oracles against JAX's --------------------------------

def _rel(x, y):
    x, y = (np.asarray(t, np.float64) for t in (x, y))
    return float(np.max(np.abs(x - y)) / max(np.max(np.abs(y)), 1e-30))


def _system(name, seed=0):
    """Diagonally dominant bands and a right-hand side, float32."""
    shape, batch = SYSTEMS[name]
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    c = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    b = (2.0 + np.abs(a) + np.abs(c)).astype(np.float32)
    d = rng.standard_normal(batch + shape).astype(np.float32)
    return a, b, c, d


@pytest.mark.parametrize("oracle", ORACLES)
@pytest.mark.parametrize("system", ("batch_free", "full"))
def test_oracle_matches_jax(oracle, system):
    a, b, c, d = _system(system)
    ours = getattr(tridiag, oracle)(*map(torch.from_numpy, (a, b, c, d)))
    ref = getattr(jax_tridiag, oracle)(*map(jnp.asarray, (a, b, c, d)))
    assert ours.shape == ref.shape and ours.dtype == torch.float32
    assert _rel(ours.numpy(), ref) < SOLVE_TOL


@pytest.mark.parametrize("system", ("batch_free", "short", "one_row"))
def test_scan_gradients_match_jax(system):
    """Autograd through ``tridiag_solve_scan`` against ``jax.grad``
    through JAX's scan: a, b, c and d of Σ w·x."""
    a, b, c, d = _system(system, seed=1)
    w = np.random.default_rng(2).standard_normal(d.shape).astype(np.float32)
    ts = [torch.tensor(t, requires_grad=True) for t in (a, b, c, d)]
    (tridiag.tridiag_solve_scan(*ts) * torch.from_numpy(w)).sum().backward()
    refs = jax.grad(lambda *t: (jax_tridiag.tridiag_solve_scan(*t) * w).sum(),
                    argnums=(0, 1, 2, 3))(*map(jnp.asarray, (a, b, c, d)))
    for name, t, ref in zip("abcd", ts, refs):
        # an input the solve never reads (a of a one-row line) gets no
        # gradient in autograd, a zero one in JAX
        grad = t.grad if t.grad is not None else torch.zeros_like(t)
        assert grad.shape == ref.shape, name
        assert _rel(grad.numpy(), ref) < GRAD_TOL, name


def test_reference_gradients_match_jax():
    """``thomas_solve_reference``'s custom VJP (the 'scan' solver's)
    against JAX's, on b + eps."""
    a, b, c, d = _system("batch_free", seed=3)
    w = np.random.default_rng(4).standard_normal(d.shape).astype(np.float32)
    ts = [torch.tensor(t, requires_grad=True) for t in (a, b, c, d)]
    (tridiag.thomas_solve_reference(*ts) * torch.from_numpy(w)).sum() \
        .backward()
    refs = jax.grad(
        lambda *t: (jax_tridiag.thomas_solve_reference(*t) * w).sum(),
        argnums=(0, 1, 2, 3))(*map(jnp.asarray, (a, b, c, d)))
    for name, t, ref in zip("abcd", ts, refs):
        assert _rel(t.grad.numpy(), ref) < GRAD_TOL, name


def test_oracles_launch_no_kernel(monkeypatch):
    """Where a tensor would take K1/K3 (``use_kernel`` true), the oracles
    stay plain PyTorch: neither kernel is reached, forward or backward;
    they are exported from ``ops``."""
    def refuse(*args, **kwargs):
        raise AssertionError("an oracle reached a kernel")

    monkeypatch.setattr(kernels, "use_kernel", lambda *t: True)
    monkeypatch.setattr(tridiag, "_thomas_kernel", refuse)
    monkeypatch.setattr(tridiag, "tridiag_adjoint", refuse)
    a, b, c, d = (torch.tensor(t, requires_grad=True)
                  for t in _system("batch_free"))
    for oracle in ORACLES:
        assert getattr(ops, oracle) is getattr(tridiag, oracle)
        getattr(ops, oracle)(a, b, c, d).sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in (a, b, c, d))
