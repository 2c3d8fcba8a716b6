"""Export in the port (serve.export_model / load_exported) and the three
kernels it reaches as ``torch.library`` ops, on the CPU.

K1 (``cnn_pde_tpu_torch::thomas_solve``), K2 (``::fused_channel_fwd``) and
K6 (``::fused_grayscale_fwd``) pass ``torch.library.opcheck`` (schema,
fake implementation, autograd registration, dynamic-shape tracing) at
small shapes, and equal their plain versions on a CPU tensor.  A small
per-sweep, fused and int8-linearized model is exported, saved, loaded and
run: equal to the eager predict bit for bit (the same plain versions in
the same order), the int8 one within 1e-6 of the largest entry; the
program holds the ops and a pinned cache as a constant.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cnn_pde_tpu_torch.models import build_model
from cnn_pde_tpu_torch.ops.fused_channel import (
    fused_channel_diffusion_plain, fused_channel_fwd_op)
from cnn_pde_tpu_torch.ops.fused_grayscale import (
    fused_grayscale_diffusion_plain, fused_grayscale_fwd_op)
from cnn_pde_tpu_torch.ops.tridiag import thomas_solve_op, tridiag_solve_plain
from cnn_pde_tpu_torch.pde import enable_amp
from cnn_pde_tpu_torch.pde.diffusion import _substep_times_np
from cnn_pde_tpu_torch.serve import (cache_hoisted_operators,
                                     clear_operator_cache, export_model,
                                     linearize_pde_layers, load_exported,
                                     make_predict_fn)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = {"thomas_solve": torch.ops.cnn_pde_tpu_torch.thomas_solve,
       "fused_channel_fwd": torch.ops.cnn_pde_tpu_torch.fused_channel_fwd,
       "fused_grayscale_fwd": torch.ops.cnn_pde_tpu_torch.fused_grayscale_fwd}


def _t(rng, *shape, lo=0.0, hi=1.0):
    return torch.tensor(rng.uniform(lo, hi, shape), dtype=torch.float32)


def _op_cases():
    rng = np.random.default_rng(0)
    r = _t(rng, 3, 5, 7, hi=2.0)
    bands = (-r, 1.0 + 2.0 * r + 1e-6, -r)
    ts = torch.tensor(_substep_times_np(0.01, 2), dtype=torch.float32)
    channel = (_t(rng, 2, 3, 6, 6), *(_t(rng, 3, 6, 6, lo=0.5, hi=1.5)
                                      for _ in range(4)),
               torch.eye(3) + 0.05 * _t(rng, 3, 3), ts, 0.01, 1.0, 1.0,
               "strang", 1e-6, 10.0)
    gray = (_t(rng, 2, 6, 6), *(_t(rng, 6, 6, lo=0.5, hi=1.5)
                                for _ in range(4)), ts, 0.3, 1.0, 1.0, 1e-6)
    return [
        ("thomas_solve", (*bands, _t(rng, 2, 3, 5, 7), -1),
         lambda a, b, c, d, dim: tridiag_solve_plain(a, b, c, d, dim)),
        ("thomas_solve", (*bands, _t(rng, 2, 3, 5, 7), -2),
         lambda a, b, c, d, dim: tridiag_solve_plain(a, b, c, d, dim)),
        ("fused_channel_fwd", channel,
         lambda u, ab, at, bb, bt, m, ts, dt, dx, dy, sp, eps, cmax:
         fused_channel_diffusion_plain(u, ab, at, bb, bt, m, dt=dt, dx=dx,
                                       dy=dy, ts=ts, splitting=sp, eps=eps,
                                       cmax=cmax)),
        ("fused_grayscale_fwd", gray,
         lambda u, ab, at, bb, bt, ts, dt, dx, dy, eps:
         fused_grayscale_diffusion_plain(u, ab, at, bb, bt, dt=dt, dx=dx,
                                         dy=dy, ts=ts, eps=eps)),
    ]


@pytest.mark.parametrize("name,args,plain",
                         [pytest.param(*c, id=f"{c[0]}-{i}")
                          for i, c in enumerate(_op_cases())])
def test_registered_ops_pass_opcheck_and_equal_plain(name, args, plain):
    op = OPS[name]
    torch.library.opcheck(op.default, args)
    out = op(*args)
    assert out.is_contiguous()
    assert torch.equal(out, plain(*args))


def test_wrappers_call_the_registered_ops():
    assert thomas_solve_op is OPS["thomas_solve"].default
    assert fused_channel_fwd_op is OPS["fused_channel_fwd"].default
    assert fused_grayscale_fwd_op is OPS["fused_grayscale_fwd"].default


def _int8(model, x):
    linearize_pde_layers(model, x, dtype="int8")
    return model


# (label, model, batch shape, op nodes expected in the program)
MODELS = [
    ("per_sweep", lambda x: build_model("mnist", device="cpu"),
     (3, 1, 28, 28), {"thomas_solve": 30}),
    ("fused_grayscale", lambda x: build_model("mnist", device="cpu",
                                              fused_inference=True),
     (3, 1, 28, 28), {"fused_grayscale_fwd": 1}),
    ("fused_channel", lambda x: build_model("cifar10_noconv", device="cpu",
                                            fused_inference=True),
     (2, 3, 32, 32), {"fused_channel_fwd": 3}),
    ("int8", lambda x: _int8(build_model("mnist", device="cpu"), x),
     (3, 1, 28, 28), {}),
]


@pytest.mark.parametrize("label,make,shape,ops",
                         [pytest.param(*m, id=m[0]) for m in MODELS])
def test_export_save_load_round_trip(tmp_path, label, make, shape, ops):
    x = np.random.default_rng(1).random(shape).astype(np.float32)
    model = make(x)
    want = make_predict_fn(model)(x)
    path = tmp_path / "model.pt2"
    blob = export_model(model, x, path)
    assert path.read_bytes() == blob
    program = torch.export.load(path)
    found = {}
    for node in program.graph.nodes:
        target = str(node.target)
        if target.startswith("cnn_pde_tpu_torch."):
            name = target.split(".")[1]
            found[name] = found.get(name, 0) + 1
    assert found == ops
    for source in (blob, str(path)):
        got = load_exported(source)(x)
        assert not got.requires_grad
        if label == "int8":
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= 1e-6 * scale
        else:
            assert torch.equal(got, want)


def test_export_embeds_pinned_operator_cache():
    """A pinned operator cache is lifted into the program as a constant:
    the loaded program still serves the cached grade after the model's
    cache is cleared."""
    model = build_model("mnist", device="cpu")
    enable_amp(model)
    x = np.random.default_rng(2).random((2, 1, 28, 28)).astype(np.float32)
    assert cache_hoisted_operators(model) == 1
    want = make_predict_fn(model)(x)
    blob = export_model(model, x)
    program = torch.export.load(__import__("io").BytesIO(blob))
    assert not any("thomas_solve" in str(n.target)
                   for n in program.graph.nodes)
    clear_operator_cache(model)
    assert torch.equal(load_exported(blob)(x), want)


def test_exported_program_loads_in_a_fresh_process(tmp_path):
    """The loader needs only cnn_pde_tpu_torch (which registers the ops),
    never jax or the JAX package."""
    x = np.random.default_rng(3).random((2, 3, 32, 32)).astype(np.float32)
    model = build_model("cifar10_noconv", device="cpu", fused_inference=True)
    export_model(model, x, tmp_path / "m.pt2")
    np.save(tmp_path / "x.npy", x)
    code = (
        "import sys, numpy as np\n"
        "from cnn_pde_tpu_torch.serve import load_exported\n"
        f"out = load_exported({str(tmp_path / 'm.pt2')!r})("
        f"np.load({str(tmp_path / 'x.npy')!r}))\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, out.numpy())\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'cnn_pde_tpu')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"),
                                  make_predict_fn(model)(x).numpy())
