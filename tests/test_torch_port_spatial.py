"""The port's spatial sharding (``cnn_pde_tpu_torch/parallel/spatial.py``,
``dist_tridiag.py``, ``spatial_model.py``, ``hlo_audit.py``) against the
JAX package's unsharded functions and models on the CPU.

Four gloo ranks, each a process that imports only torch and the port and
runs one torch thread (``_worker``), run every case once (the module
fixture) on a data=1 × spatial=4 mesh (S = 4: the partitioned solve has
interior blocks) and a data=2 × spatial=2 one, each rank returning its
block; this process, on two threads, computes JAX's references meanwhile.

Tolerances are the JAX package's own for its sharded functions
(``tests/test_parallel.py``): FTCS and the Laplacian 1e-6; the all_to_all
ADI step rtol 1e-5 / atol 1e-6; the partitioned step and solve rtol 2e-5
/ atol 2e-6, its gradients rtol 1e-4 / atol 1e-5; the emotion logits rtol
5e-4 / atol 1e-3 (the FTCS layer is CFL-unstable at its init and
amplifies values about 1e6x); the Tiny-ImageNet logits 1e-5.  A spatial
train step's PDE-parameter gradients are held against the unsharded
port step's on the same global batch (augmentation and dropout on) at
rtol 1e-4 (emotion: 1e-3, its amplified values) with its loss at 1e-5.
The emotion classifier built with another horizon (``HORIZON``: T = 0.02,
dt = 0.001, 20 FTCS steps) is held at the emotion bars against JAX's
spatial classifier of that horizon and the unsharded port model with a
20-step ``FourierFTCSLayer``.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
SPEC = ("data", None, "spatial", None)
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
PDE_PARAMS = {"emotion": [f"pde.{a}_w{i}" for a in ("alpha", "beta")
                          for i in (1, 2, 3)],
              "tiny_imagenet": ["diff.alpha_base", "diff.channel_scaling"]}
HORIZON = {"T": 0.02, "dt": 0.001}  # twice the default FTCS steps


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """This process on two intra-op threads, the default restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _f32(a):
    return np.asarray(a, np.float32)


def _inputs():
    """Every case's global inputs, from numpy seeds."""
    rng = np.random.default_rng(0)
    out = {"ftcs": (_f32(rng.standard_normal((3, 48, 48))),
                    _f32(rng.random((48, 48)) * 0.1),
                    _f32(rng.random((48, 48)) * 0.1)),
           "lap": (_f32(rng.standard_normal((2, 3, 64, 64))),
                   _f32(rng.random(3) * 0.1))}
    for smooth in (False, True):
        out[("adi", smooth)] = (_f32(rng.standard_normal((2, 32, 32))),
                                _f32(rng.random((32, 32)) + 0.2),
                                _f32(rng.random((32, 32)) + 0.2))
    lo = rng.random((6, 64))
    c = -rng.random((6, 64))
    out["solve"] = (_f32(-lo), _f32(1.0 + lo + np.abs(c)), _f32(c),
                    _f32(rng.standard_normal((4, 6, 64))))
    out["grad"] = (_f32(rng.standard_normal((2, 16, 16))),
                   _f32(rng.random((16, 16)) + 0.2),
                   _f32(rng.random((16, 16)) + 0.2),
                   _f32(rng.random((2, 16, 16))))
    out["audit"] = {h: (_f32(rng.standard_normal((4, h, 48))),
                        _f32(rng.random((h, 48)) + 0.2)) for h in (48, 96)}
    out["emotion"] = (_f32(rng.random((4, 1, 48, 48))),
                      rng.integers(0, 7, 4).astype(np.int64))
    out["tiny_imagenet"] = (_f32(rng.standard_normal((4, 3, 64, 64))),
                            rng.integers(0, 20, 4).astype(np.int64))
    return out


def _block(mesh, x, dim):
    from cnn_pde_tpu_torch.parallel.spatial import block

    lo, hi = block(mesh, x.shape[dim])
    return torch.as_tensor(x).narrow(dim, lo, hi - lo).contiguous()


def _model(name, mesh, weights, dropout=0.0, horizon=None):
    """The spatial classifier (mesh) or the unsharded port model (None)
    with ``weights``; the emotion model's FTCS layer of ``horizon`` (T and
    dt) when given."""
    from cnn_pde_tpu_torch.models import (EmotionClassifier,
                                          TinyImageNetClassifier)
    from cnn_pde_tpu_torch.parallel import (SpatialFTCSClassifier,
                                            SpatialTinyImageNetClassifier)
    from cnn_pde_tpu_torch.pde.spectral import FourierFTCSLayer

    if name == "emotion":
        if mesh is not None:
            model = SpatialFTCSClassifier(mesh, dropout_rate=dropout,
                                          **(horizon or {}))
        else:
            model = EmotionClassifier(dropout_rate=dropout)
            if horizon:
                model.pde = FourierFTCSLayer(Nx=48, Ny=48, **horizon)
    else:
        model = (TinyImageNetClassifier(num_classes=20, dropout_rate=dropout)
                 if mesh is None else SpatialTinyImageNetClassifier(
                     mesh, num_classes=20, dropout_rate=dropout))
    model.load_state_dict(weights, strict=True)
    return model.eval()


def _train_values(name):
    from cnn_pde_tpu_torch.presets import PRESETS

    return dict(PRESETS[name]["train"])


def _step(name, weights, mesh=None):
    """One train step of the preset's values (augmentation and dropout on)
    on the global batch: (loss, {PDE parameter: gradient})."""
    from cnn_pde_tpu_torch.parallel import make_dp_train_step, shard_batch
    from cnn_pde_tpu_torch.train import make_train_step

    model = _model(name, mesh, weights, dropout=0.3)
    x, y = _inputs()[name]
    gen = torch.Generator().manual_seed(7)
    if mesh is None:
        step = make_train_step(model, _train_values(name), 3, gen)
    else:
        step = make_dp_train_step(model, _train_values(name), mesh,
                                  steps_per_epoch=3, generator=gen,
                                  image_spec=SPEC)
        x, y = shard_batch(mesh, (x, y))
    loss, _ = step(x, y)
    params = dict(model.named_parameters())
    return float(loss), {k: params[k].grad.clone() for k in PDE_PARAMS[name]}


def _spatial_cases(mesh, res):
    from cnn_pde_tpu_torch.parallel import (adi_strang_step_partitioned,
                                            adi_strang_step_spatial,
                                            ftcs_evolve_spatial,
                                            laplacian_step_spatial,
                                            tridiag_solve_partitioned)
    from cnn_pde_tpu_torch.parallel.hlo_audit import audit

    inp = _inputs()
    u, al, be = inp["ftcs"]
    res["ftcs"] = ftcs_evolve_spatial(mesh, _block(mesh, u, 1),
                                      _block(mesh, al, 0),
                                      _block(mesh, be, 0), 7)
    u, coeff = inp["lap"]
    res["lap"] = laplacian_step_spatial(mesh, _block(mesh, u, 2),
                                        torch.as_tensor(coeff), dt=0.01)
    for smooth in (False, True):
        u, al, be = (_block(mesh, t, t.ndim - 2) for t in inp[("adi", smooth)])
        for fn in (adi_strang_step_spatial, adi_strang_step_partitioned):
            res[(fn.__name__, smooth)] = fn(mesh, u, al, be, dt=0.01,
                                            smooth=smooth, eps=1e-6)
    a, b, c, d = inp["solve"]
    res["solve"] = tridiag_solve_partitioned(
        _block(mesh, a, 1), _block(mesh, b, 1), _block(mesh, c, 1),
        _block(mesh, d, 2), mesh)
    u, al, be, gw = (_block(mesh, t, t.ndim - 2) for t in inp["grad"])
    al.requires_grad_()
    be.requires_grad_()
    x = adi_strang_step_partitioned(mesh, u, al, be, dt=0.01, smooth=True,
                                    eps=1e-6)
    (x * gw).sum().backward()
    res["grad"] = (al.grad, be.grad)
    # the collectives of one call
    u, ab = inp["audit"][48]
    res["audit_ftcs"] = audit(ftcs_evolve_spatial, mesh, _block(mesh, u, 1),
                              _block(mesh, ab * 0.1, 0),
                              _block(mesh, ab * 0.1, 0), 10)[0]
    res["audit_adi"] = audit(adi_strang_step_spatial, mesh,
                             _block(mesh, u, 1), _block(mesh, ab, 0),
                             _block(mesh, ab, 0), dt=0.01)[0]
    for h, (u, ab) in inp["audit"].items():
        res[("audit_partitioned", h)] = audit(
            adi_strang_step_partitioned, mesh, _block(mesh, u, 1),
            _block(mesh, ab, 0), _block(mesh, ab, 0), dt=0.01)[:2]


def _worker(rank, port, out):
    """One gloo rank: every case, its results saved to ``out/rank<r>.pt``."""
    torch.set_num_threads(1)
    from cnn_pde_tpu_torch.parallel import (SpatialFTCSClassifier,
                                            initialize, make_mesh)

    initialize(f"127.0.0.1:{port}", num_processes=WORLD, process_id=rank,
               backend="gloo")
    weights = torch.load(os.path.join(out, "weights.pt"))
    meshes = {k: make_mesh(data=d, spatial=s, device="cpu") for k, (d, s)
              in MESHES.items()}
    res = {"shapes": {k: m.shape for k, m in meshes.items()},
           "coords": {k: m.coords for k, m in meshes.items()}}
    _spatial_cases(meshes["1x4"], res)
    for key, mesh in meshes.items():
        _, d, D = mesh.axis("data")
        for name in ("emotion", "tiny_imagenet"):
            x, _ = _inputs()[name]
            rows = np.split(x, D)[d]
            with torch.no_grad():
                res[(name, key, "logits")] = _model(
                    name, mesh, weights[name])(_block(mesh, rows, 2))
            res[(name, key, "step")] = _step(name, weights[name], mesh)
        x, _ = _inputs()["emotion"]
        model = _model("emotion", mesh, weights["emotion"],
                       horizon=HORIZON)
        res[("emotion", key, "horizon_nt")] = model.pde.Nt
        with torch.no_grad():
            res[("emotion", key, "horizon_logits")] = model(
                _block(mesh, np.split(x, D)[d], 2))
    res["default_nt"] = SpatialFTCSClassifier(meshes["1x4"]).pde.Nt
    res = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
           for k, v in res.items()}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_models():
    """The JAX emotion (48 x 48) and Tiny-ImageNet (64 x 64, 20 classes)
    models with their init weights, and those as the port's state dicts."""
    import jax

    from cnn_pde_tpu.models import EmotionClassifier, TinyImageNetClassifier
    from cnn_pde_tpu_torch.compat import state_dict_from_jax

    out = {}
    for name, model in (("emotion", EmotionClassifier(img_size=48)),
                        ("tiny_imagenet",
                         TinyImageNetClassifier(num_classes=20))):
        params, state = jax.tree_util.tree_map(
            np.asarray, jax.jit(model.init)(jax.random.PRNGKey(3)))
        out[name] = (model, params, state,
                     state_dict_from_jax(params, state, name))
    return out


def _jax_references(models):
    """JAX's unsharded results of every case."""
    import jax
    import jax.numpy as jnp

    from cnn_pde_tpu.nn import Ctx
    from cnn_pde_tpu.ops import ftcs_evolve, sweep_x, sweep_y, tridiag_solve
    from cnn_pde_tpu.ops.stencil import laplacian_step
    from cnn_pde_tpu.parallel import SpatialFTCSClassifier, make_mesh

    inp = _inputs()
    ref = {"ftcs": ftcs_evolve(*map(jnp.asarray, inp["ftcs"]), nt=7),
           "lap": laplacian_step(*map(jnp.asarray, inp["lap"]), dt=0.01),
           "solve": tridiag_solve(*map(jnp.asarray, inp["solve"]))}

    def strang(u, al, be, smooth):
        x = sweep_x(u, al, 0.005, 1.0, smooth=smooth, eps=1e-6)
        x = sweep_y(x, be, 0.01, 1.0, smooth=smooth, eps=1e-6)
        return sweep_x(x, al, 0.005, 1.0, smooth=smooth, eps=1e-6)

    for smooth in (False, True):
        ref[("adi", smooth)] = strang(*map(jnp.asarray, inp[("adi", smooth)]),
                                      smooth)
    u, al, be, gw = map(jnp.asarray, inp["grad"])
    ref["grad"] = jax.grad(lambda a, b: jnp.sum(strang(u, a, b, True) * gw),
                           argnums=(0, 1))(al, be)
    for name, (model, params, state, _) in models.items():
        x, _ = inp[name]
        ref[(name, "logits")] = jax.jit(
            lambda p, x: model.apply(p, state, x, Ctx(train=False))[0])(
                params, jnp.asarray(x))
    # JAX's spatial emotion classifier of HORIZON, H over four devices
    _, params, state, _ = models["emotion"]
    spatial = SpatialFTCSClassifier(make_mesh(data=2, spatial=4), **HORIZON)
    ref["horizon_nt"] = spatial.pde.Nt
    ref["horizon_logits"] = jax.jit(
        lambda p, x: spatial.apply(p, state, x, Ctx(train=False))[0])(
            params, jnp.asarray(inp["emotion"][0]))
    return {k: (tuple(map(np.asarray, v)) if isinstance(v, tuple)
                else v if isinstance(v, int) else np.asarray(v))
            for k, v in ref.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The four gloo ranks' results, with JAX's references computed while
    they run."""
    out = str(tmp_path_factory.mktemp("spatial"))
    models = _jax_models()
    torch.save({k: v[3] for k, v in models.items()},
               os.path.join(out, "weights.pt"))
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    code = ("import sys; from tests.test_torch_port_spatial import _worker; "
            "_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port),
                               out], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORLD)]
    try:
        ref = _jax_references(models)
        logs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (o, e) in zip(procs, logs):
        assert p.returncode == 0, (o + e)[-4000:]
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return ranks, ref, {k: v[3] for k, v in models.items()}


def _whole(ranks, key, dim):
    """The 1x4 mesh's blocks of ``key`` concatenated along ``dim``."""
    return torch.cat([r[key] for r in ranks], dim=dim).numpy()


def test_meshes_in_a_four_rank_world(world):
    ranks, _, _ = world
    for r, res in enumerate(ranks):
        assert res["shapes"]["1x4"] == {"data": 1, "spatial": 4, "model": 1}
        assert res["shapes"]["2x2"] == {"data": 2, "spatial": 2, "model": 1}
        assert res["coords"]["1x4"] == (0, r, 0)
        assert res["coords"]["2x2"] == (r // 2, r % 2, 0)


def test_ftcs_and_laplacian_match_jax(world):
    ranks, ref, _ = world
    np.testing.assert_allclose(_whole(ranks, "ftcs", 1), ref["ftcs"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_whole(ranks, "lap", 2), ref["lap"],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("smooth", [False, True])
def test_adi_all_to_all_matches_jax(world, smooth):
    ranks, ref, _ = world
    np.testing.assert_allclose(
        _whole(ranks, ("adi_strang_step_spatial", smooth), 1),
        ref[("adi", smooth)], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("smooth", [False, True])
def test_adi_partitioned_matches_jax(world, smooth):
    ranks, ref, _ = world
    np.testing.assert_allclose(
        _whole(ranks, ("adi_strang_step_partitioned", smooth), 1),
        ref[("adi", smooth)], rtol=2e-5, atol=2e-6)


def test_tridiag_partitioned_matches_jax(world):
    ranks, ref, _ = world
    np.testing.assert_allclose(_whole(ranks, "solve", 2), ref["solve"],
                               rtol=2e-5, atol=2e-6)


def test_adi_partitioned_grads_match_jax(world):
    ranks, ref, _ = world
    for i, name in enumerate(("alpha", "beta")):
        got = torch.cat([r["grad"][i] for r in ranks]).numpy()
        np.testing.assert_allclose(got, ref["grad"][i], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_audit_ftcs_one_exchange_each_way_a_step(world):
    """10 steps: an interior rank sends a row each way a step, an edge
    rank one a step; nothing else crosses."""
    ranks, _, _ = world
    for r, res in enumerate(ranks):
        c = res["audit_ftcs"]
        assert c["collective-permute"] == (10 if r in (0, WORLD - 1)
                                           else 20), (r, c)
        assert c["all-gather"] == c["all-to-all"] == c["all-reduce"] == 0, c


def test_audit_adi_three_all_to_alls(world):
    ranks, _, _ = world
    for res in ranks:
        c = res["audit_adi"]
        assert c["all-to-all"] == 3, c
        assert c["all-gather"] == c["collective-permute"] == \
            c["all-reduce"] == 0, c


def test_audit_partitioned_two_gathers_independent_of_h(world):
    """Two all-gathers a step, no all-to-all or halo, whose payloads are the
    same at H = 48 and H = 96 (a full-tensor gather would double)."""
    ranks, _, _ = world
    for res in ranks:
        shapes = {}
        for h in (48, 96):
            c, gathered = res[("audit_partitioned", h)]
            assert c["all-gather"] == 2, (h, c)
            assert c["all-to-all"] == c["collective-permute"] == 0, (h, c)
            shapes[h] = sorted(gathered)
        assert shapes[48] == shapes[96], shapes
        # (S, 4·W) interface coefficients and (S, 2·B·W) interface rows
        assert shapes[48] == [(WORLD, 4 * 48), (WORLD, 2 * 4 * 48)]


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
@pytest.mark.parametrize("name", ["emotion", "tiny_imagenet"])
def test_spatial_classifier_logits(world, name, mesh):
    """The spatial classifier's logits (each rank its 'data' rows) against
    the unsharded port model and JAX's on the same weights."""
    ranks, ref, weights = world
    tol = (dict(rtol=5e-4, atol=1e-3) if name == "emotion"
           else dict(rtol=1e-5, atol=1e-5))
    d_size = MESHES[mesh][0]
    got = torch.cat([ranks[r][(name, mesh, "logits")]
                     for r in range(0, WORLD, WORLD // d_size)]).numpy()
    for r in range(WORLD):  # the spatial ranks of a row block agree
        peer = (r // (WORLD // d_size)) * (WORLD // d_size)
        assert torch.equal(ranks[r][(name, mesh, "logits")],
                           ranks[peer][(name, mesh, "logits")])
    x, _ = _inputs()[name]
    with torch.no_grad():
        unsharded = _model(name, None, weights[name])(torch.as_tensor(x))
    np.testing.assert_allclose(got, unsharded.numpy(), **tol)
    np.testing.assert_allclose(got, ref[(name, "logits")], **tol)


def test_spatial_classifier_horizon_logits(world):
    """``SpatialFTCSClassifier(mesh, T=0.02, dt=0.001)`` on both meshes
    against JAX's spatial classifier of that horizon and the unsharded
    port model with a 20-step FTCS layer, on the same weights."""
    ranks, ref, weights = world
    x, _ = _inputs()["emotion"]
    with torch.no_grad():
        unsharded = _model("emotion", None, weights["emotion"],
                           horizon=HORIZON)(torch.as_tensor(x)).numpy()
    for mesh, (d_size, _) in MESHES.items():
        got = torch.cat([ranks[r][("emotion", mesh, "horizon_logits")]
                         for r in range(0, WORLD, WORLD // d_size)]).numpy()
        np.testing.assert_allclose(got, unsharded, rtol=5e-4, atol=1e-3,
                                   err_msg=mesh)
        np.testing.assert_allclose(got, ref["horizon_logits"], rtol=5e-4,
                                   atol=1e-3, err_msg=mesh)


def test_spatial_classifier_horizon_steps(world):
    """T / dt sets the evolution's steps, as in JAX's class; the default
    stays 10."""
    ranks, ref, _ = world
    assert ref["horizon_nt"] == 20
    for res in ranks:
        assert res["default_nt"] == 10
        for mesh in MESHES:
            assert res[("emotion", mesh, "horizon_nt")] == 20


@pytest.mark.parametrize("name", ["emotion", "tiny_imagenet"])
def test_spatial_train_step_pde_gradients(world, name):
    """One spatial train step on each mesh (augmentation and dropout on,
    batch rows over 'data', H over 'spatial'): the loss and the PDE
    parameters' summed gradients equal the unsharded port step's on the
    global batch."""
    ranks, _, weights = world
    loss, grads = _step(name, weights[name])
    rtol = 1e-3 if name == "emotion" else 1e-4
    for res, mesh in ((res, mesh) for res in ranks for mesh in MESHES):
        got_loss, got = res[(name, mesh, "step")]
        assert abs(got_loss - loss) <= 1e-5 * max(1.0, abs(loss)), \
            (got_loss, loss)
        for k, g in grads.items():
            assert float(g.abs().max()) > 0, k
            np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=rtol,
                                       atol=1e-7 * float(g.abs().max()),
                                       err_msg=k)


def test_sharded_functions_refuse_a_mesh_without_a_group():
    from cnn_pde_tpu_torch.parallel import ftcs_evolve_spatial, make_mesh

    mesh = make_mesh(data=1, spatial=2, devices=["cpu", "cpu"])
    assert mesh.shape == {"data": 1, "spatial": 2, "model": 1}
    u = torch.zeros(1, 4, 4)
    with pytest.raises(ValueError, match="process group"):
        ftcs_evolve_spatial(mesh, u, u[0], u[0], 1)


def test_train_cli_spatial(tmp_path):
    """``--spatial 2`` (emotion) in a world of two gloo processes: the mesh
    line and the summary JSON, printed by rank 0 only."""
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cnn_pde_tpu_torch.train", "--preset",
             "emotion", "--synthetic", "--epochs", "1", "--steps", "2",
             "--batch-size", "8", "--spatial", "2", "--device", "cpu",
             "--no-preemption-handler"], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        logs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (o, e) in zip(procs, logs):
        assert p.returncode == 0, (o + e)[-4000:]
    out = logs[0][0]
    assert "Mesh: data=1 x spatial=2 x model=1 (2 devices)" in out, out
    result = json.loads(out.strip().splitlines()[-1])
    assert result["preset"] == "emotion" and result["steps"] == 2
    assert 0.0 <= result["best_acc"] <= 100.0
    assert np.isfinite(result["first_loss"])
    assert result["devices"] == 2
    assert logs[1][0].strip() == ""
