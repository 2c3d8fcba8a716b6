"""The port's data-parallel layer (``cnn_pde_tpu_torch/parallel/``) against
the JAX package's on the CPU.

Two gloo ranks, each a process that imports only torch and the port
(``_worker``), run every case of the world together once (the module
fixture), while this process runs the references: JAX's
``make_dp_train_step`` on a 2-device mesh of its CPU devices, and the
port's single-process step and Trainer on the whole global batch.

Tolerances: the loss within 1e-5 and the parameters after one AdamW step
within 5e-5, the JAX package's own bars for its DP step against a single
device (``tests/test_parallel.py``).  The parameters are held where the
reference's clipped gradient exceeds 1e-6 (Adam's first step is
lr·sign(g), and a gradient's rounding in another order of sums moves the
sign of one near 0, as in ``test_torch_port_train.py``), and the
gradients that vanish in exact arithmetic are left out.  The device epoch under DP is held against the
meshless one at 5e-5 on parameters and 1e-4 on the epoch's mean loss
(``tests/test_parallel.py::test_device_epoch_under_dp_mesh``); eval
predictions and ``make_predict_fn(mesh=)`` exactly.
"""

import json
import os
import socket
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from cnn_pde_tpu_torch.data import synthetic_dataset
from cnn_pde_tpu_torch.models import build_model
from cnn_pde_tpu_torch.parallel import make_mesh, multihost
from cnn_pde_tpu_torch.presets import PRESETS
from cnn_pde_tpu_torch.serve import make_predict_fn
from cnn_pde_tpu_torch.train import TrainConfig, Trainer, make_train_step


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """This file's tests on two intra-op threads, the default restored
    after.  Tier-1 runs six test processes at once on the machine's cores,
    and torch's default of one thread a core in each makes their threads
    wait on one another (a ResNet-18 step measured 18x slower in six
    processes at once than at two threads each)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
LOSS_TOL = 1e-5
PARAM_TOL = 5e-5
ZERO_IN_EXACT_ARITHMETIC = {"feature_bn.bias"} | {
    f"classifier.network.{i}.bias" for i in (0, 4, 8, 12)}
EPOCH_DATA = dict(train_per_class=10, test_per_class=3)  # 100 / 30 images


def _values(name, full):
    """The preset's train values; ``full`` keeps its augmentation (the
    JAX comparisons run without: JAX draws from its own keys)."""
    values = dict(PRESETS[name]["train"])
    if not full:
        values["augment"] = None
    return values


def _batch(name):
    """A seeded global batch: the flagship's is ``test_torch_port_train``'s
    step case (no max-pool near tie), mnist's 16 images."""
    if name == "cifar10_noconv":
        rng = np.random.default_rng(26)
        return (rng.random((8, 3, 32, 32)).astype(np.float32),
                rng.integers(0, 10, 8).astype(np.int32))
    rng = np.random.default_rng(3)
    return (rng.random((16, 1, 28, 28)).astype(np.float32),
            rng.integers(0, 10, 16).astype(np.int32))


def _model(name, weights, full):
    model = build_model(name, device="cpu", **(
        {} if full else {"dropout_rate": 0.0}))
    model.load_state_dict(weights, strict=True)
    return model


# the step cases: (model, full config); full = dropout and augmentation on
STEP_CASES = [("mnist", False), ("mnist", True), ("cifar10_noconv", False),
              ("cifar10_noconv", True)]


def _step(name, full, weights, mesh=None):
    """One train step of the port from ``weights`` on the global batch
    (``mesh``: this rank's rows of it): (loss, acc, state_dict)."""
    from cnn_pde_tpu_torch.parallel import make_dp_train_step, shard_batch

    model = _model(name, weights, full)
    x, y = _batch(name)
    gen = torch.Generator().manual_seed(11)
    if mesh is None:
        step = make_train_step(model, _values(name, full), 3, gen)
    else:
        step = make_dp_train_step(model, _values(name, full), mesh,
                                  steps_per_epoch=3, generator=gen)
        x, y = shard_batch(mesh, (x, y))
    loss, acc = step(x, y)
    return (float(loss), float(acc),
            {k: v.clone() for k, v in model.state_dict().items()},
            {k: p.grad.clone() for k, p in model.named_parameters()})


def _epoch_trainer(mesh, device_epoch, weights):
    model = _model("mnist", weights, True)
    cfg = TrainConfig(epochs=1, batch_size=16, log_every=10**9,
                      device_epoch=device_epoch)
    trainer = Trainer(model, cfg, PRESETS["mnist"]["train"], mesh=mesh)
    return trainer, trainer.init_state(6)


def _epoch(mesh, device_epoch, weights):
    """One Trainer epoch of mnist on the small synthetic set and its eval:
    (epoch record, state_dict, eval)."""
    ds = synthetic_dataset("mnist", **EPOCH_DATA)
    trainer, state = _epoch_trainer(mesh, device_epoch, weights)
    rec = trainer.train_epoch(state, ds, 0, verbose=False)
    ev = trainer.evaluate(state, ds)
    return (rec, {k: v.clone() for k, v in state.model.state_dict().items()},
            {"acc": ev["acc"], "predictions": ev["predictions"]},
            state.step)


def _worker(rank, port, out):
    """One gloo rank: every case of the world, its results saved to
    ``out/rank<r>.pt``."""
    from cnn_pde_tpu_torch.parallel import initialize

    torch.manual_seed(0)
    outcome = initialize(f"127.0.0.1:{port}", num_processes=WORLD,
                         process_id=rank, backend="gloo")
    again = initialize(f"127.0.0.1:{port}", num_processes=WORLD,
                       process_id=rank, backend="gloo")
    mesh = make_mesh(device="cpu")
    weights = torch.load(os.path.join(out, "weights.pt"))
    res = {"outcomes": (outcome, again), "shape": mesh.shape,
           "devices": [str(d) for d in mesh.devices.flat],
           "slice": multihost.local_batch_slice(16),
           "multihost": multihost.is_multihost(),
           "gathered": multihost.global_batch_from_local(
               mesh, torch.full((2, 3), float(rank)))}
    for name, full in STEP_CASES:
        res[(name, full)] = _step(name, full, weights[name], mesh)
    for device_epoch in (False, True):
        res[("epoch", device_epoch)] = _epoch(mesh, device_epoch,
                                              weights["mnist"])
    # checkpoints: rank 0 writes behind a barrier, every rank restores
    from cnn_pde_tpu_torch.train.checkpoint import restore_state

    ckpt = os.path.join(out, "ckpt")
    ds = synthetic_dataset("mnist", **EPOCH_DATA)
    trainer, state = _epoch_trainer(mesh, False, weights["mnist"])
    trainer.fit(state, ds, verbose=False, checkpoint_dir=ckpt,
                checkpoint_every=1)
    trained = {k: v.clone() for k, v in state.model.state_dict().items()}
    _, fresh = _epoch_trainer(mesh, False, weights["mnist"])
    restore_state(fresh, ckpt, tag="last")
    res["restored"] = all(torch.equal(trained[k], v) for k, v in
                          fresh.model.state_dict().items())
    res["step_after_restore"] = fresh.step
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_weights():
    """JAX-initialised weights of both models, as the port's state dicts."""
    import jax

    from cnn_pde_tpu.models import CIFAR10PDENoConv, MNISTClassifier
    from cnn_pde_tpu_torch.compat import state_dict_from_jax

    out = {}
    for name, cls in (("mnist", MNISTClassifier),
                      ("cifar10_noconv", CIFAR10PDENoConv)):
        model = cls(dropout_rate=0.0)
        params, state = jax.tree_util.tree_map(
            np.asarray, jax.jit(model.init)(jax.random.PRNGKey(5)))
        out[name] = (model, params, state,
                     state_dict_from_jax(params, state, name))
    return out


@pytest.fixture(scope="module")
def world(jax_weights, tmp_path_factory):
    """The two gloo ranks' results, the JAX DP steps computed while they
    run."""
    out = str(tmp_path_factory.mktemp("dp"))
    torch.save({k: v[3] for k, v in jax_weights.items()},
               os.path.join(out, "weights.pt"))
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    code = ("import sys; from tests.test_torch_port_data_parallel import "
            "_worker; _worker(int(sys.argv[1]), int(sys.argv[2]), "
            "sys.argv[3])")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port),
                               out], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORLD)]
    try:
        jax_steps = {name: _jax_dp_step(name, *jax_weights[name][:3])
                     for name in ("mnist", "cifar10_noconv")}
        logs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (o, e) in zip(procs, logs):
        assert p.returncode == 0, (o + e)[-4000:]
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"),
                        weights_only=False) for r in range(WORLD)]
    return ranks, jax_steps, out


def _jax_dp_step(name, model, params, state):
    """JAX's DP step on a 2-device mesh of its CPU devices from the same
    weights and global batch, with the preset's grouped AdamW, clip and
    schedule (3 steps an epoch): (loss, {name: new param}, {name: grad})."""
    import jax
    import optax

    from cnn_pde_tpu.nn import Ctx
    from cnn_pde_tpu.parallel import (make_dp_train_step, make_mesh as jmesh,
                                      replicate, shard_batch)
    from cnn_pde_tpu.train.losses import cross_entropy
    from cnn_pde_tpu.train.optim import build_optimizer
    from cnn_pde_tpu.utils.config import get_preset
    from cnn_pde_tpu_torch.compat import state_dict_from_jax

    preset = get_preset(name)
    tv = PRESETS[name]["train"]
    opt = build_optimizer(params, preset.make_schedule(3),
                          groups=preset.param_groups,
                          default_weight_decay=tv["weight_decay"],
                          default_lr_scale=tv["default_lr_scale"],
                          clip_norm=tv["clip_norm"])
    mesh = jmesh(data=2, devices=jax.devices()[:2])
    step = make_dp_train_step(model, opt, mesh, label_smoothing=0.1)
    x, y = _batch(name)
    rng = jax.random.PRNGKey(0)
    new_params, new_state, _, loss = step(
        replicate(mesh, params), replicate(mesh, state),
        replicate(mesh, opt.init(params)), *shard_batch(mesh, (x, y)), rng)

    def loss_fn(p):
        logits, _ = model.apply(p, state, x, Ctx(train=True, rng=rng))
        return cross_entropy(logits, y, 0.1)

    grads = jax.jit(jax.grad(loss_fn))(params)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (float(loss), state_dict_from_jax(as_np(new_params),
                                             as_np(new_state), name),
            state_dict_from_jax(as_np(grads), as_np(new_state), name))


def _max_diff(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def test_world_comes_up_with_one_device_a_rank(world):
    ranks, _, _ = world
    for r, res in enumerate(ranks):
        assert res["outcomes"] == ("initialized", "already_initialized")
        assert res["shape"] == {"data": 2, "spatial": 1, "model": 1}
        assert res["devices"] == ["cpu", "cpu"]
        assert res["slice"] == (8 * r, 8)
        assert res["multihost"]
        np.testing.assert_array_equal(
            res["gathered"].numpy(), np.repeat([0.0, 1.0], 2)[:, None]
            * np.ones((1, 3)))


@pytest.mark.parametrize("name,full", STEP_CASES)
def test_dp_step_matches_the_single_process_step(world, jax_weights, name,
                                                 full):
    """Each rank's step ends on the same weights, those of the port's
    single-process step on the whole global batch (global BatchNorm
    statistics and running statistics; with ``full``, the global draws of
    dropout and augmentation)."""
    ranks, _, _ = world
    loss, acc, post, grads = _step(name, full, jax_weights[name][3])
    r0, r1 = ranks[0][(name, full)], ranks[1][(name, full)]
    assert r0[0] == r1[0] and r0[1] == r1[1]
    assert abs(r0[0] - loss) <= LOSS_TOL
    assert abs(r0[1] - acc) <= 1e-6
    for key, ref in post.items():
        assert torch.equal(r0[2][key], r1[2][key]), key
        if key in ZERO_IN_EXACT_ARITHMETIC:
            continue
        got = r0[2][key]
        if key in grads:
            moved = grads[key].abs() > 1e-6
            got, ref = got[moved], ref[moved]
        assert _max_diff(got, ref) <= PARAM_TOL, key


@pytest.mark.parametrize("name", ["mnist", "cifar10_noconv"])
def test_dp_step_matches_jax_dp_step(world, jax_weights, name):
    ranks, jax_steps, _ = world
    loss_ref, post_ref, grads = jax_steps[name]
    loss, _, post, _ = ranks[0][(name, False)]
    assert abs(loss - loss_ref) <= LOSS_TOL
    names = dict(_model(name, jax_weights[name][3], False).named_parameters())
    norm = float(np.sqrt(sum(np.sum(np.square(grads[k].numpy(),
                                              dtype=np.float64))
                             for k in names)))
    clip = min(1.0, 1.0 / norm)
    for key, ref in post_ref.items():
        # JAX keeps no count of BatchNorm's batches
        if key in ZERO_IN_EXACT_ARITHMETIC or key.endswith("_tracked"):
            continue
        got = post[key].numpy()
        if key in names:
            moved = np.abs(grads[key].numpy() * clip) > 1e-6
            got, ref = got[moved], ref.numpy()[moved]
        else:
            ref = ref.numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=PARAM_TOL,
                                   err_msg=key)


@pytest.mark.parametrize("device_epoch", [False, True])
def test_trainer_epoch_and_eval_under_dp(world, jax_weights, device_epoch):
    """``Trainer(mesh=)`` (host loop and device epoch) against the meshless
    Trainer: the same steps, the weights within 5e-5, the epoch's mean loss
    within 1e-4, and the gathered eval predictions equal."""
    ranks, _, _ = world
    rec, post, ev, steps = _epoch(None, device_epoch,
                                  jax_weights["mnist"][3])
    got = ranks[0][("epoch", device_epoch)]
    assert got[3] == steps == 6
    assert abs(got[0]["loss"] - rec["loss"]) <= 1e-4
    for key, ref in post.items():
        assert torch.equal(got[1][key], ranks[1][("epoch", device_epoch)][1]
                           [key]), key
        assert _max_diff(got[1][key], ref) <= PARAM_TOL, key
    np.testing.assert_array_equal(got[2]["predictions"].shape, (30,))
    # the eval of the DP weights on one process gives the gathered ones
    model = _model("mnist", got[1], True)
    trainer = Trainer(model, TrainConfig(batch_size=16),
                      PRESETS["mnist"]["train"])
    single = trainer.evaluate(trainer.init_state(),
                              synthetic_dataset("mnist", **EPOCH_DATA))
    np.testing.assert_array_equal(got[2]["predictions"],
                                  single["predictions"])
    assert got[2]["acc"] == single["acc"]


def test_checkpoints_written_by_rank0_restored_on_every_rank(world):
    ranks, _, out = world
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == [
        "best.ckpt", "last.ckpt"]
    for res in ranks:
        assert res["restored"] and res["step_after_restore"] == 6


def test_make_mesh_shapes_match_jax():
    import jax

    from cnn_pde_tpu.parallel import make_mesh as jmesh

    cpus = ["cpu"] * 8
    for kw in ({}, {"data": 2}, {"data": 8}):
        assert make_mesh(devices=cpus, **kw).devices.shape == \
            jmesh(devices=jax.devices()[:8], **kw).devices.shape
        assert make_mesh(devices=cpus, **kw).shape == dict(
            jmesh(devices=jax.devices()[:8], **kw).shape)
    assert make_mesh(device="cpu").devices.shape == (1, 1, 1)
    # the spatial and model axes (ported: a mesh outside a process group
    # may take any shape; the sharded layers refuse it past one device)
    for kw in ({"spatial": 2}, {"model": 2},
               {"data": 2, "spatial": 2, "model": 2}):
        ours = make_mesh(devices=cpus, **kw)
        ref = jmesh(devices=jax.devices()[:8], **kw)
        assert ours.devices.shape == ref.devices.shape
        assert ours.shape == dict(ref.shape)
        assert ours.axis_names == ref.axis_names
    with pytest.raises(AssertionError):
        make_mesh(data=9, devices=cpus)


def test_initialize_outcomes(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    dist = multihost.dist
    with mock.patch.object(dist, "is_initialized", return_value=True):
        assert multihost.initialize() == "already_initialized"
    with mock.patch.object(dist, "init_process_group") as init:
        assert multihost.initialize() == "single_process"
        init.assert_not_called()
        assert multihost.initialize("10.0.0.1:1234", 4, 2,
                                    backend="gloo") == "initialized"
        init.assert_called_once_with("gloo", init_method="tcp://10.0.0.1:1234",
                                     world_size=4, rank=2)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with mock.patch.object(dist, "init_process_group") as init:
        assert multihost.initialize(backend="gloo") == "initialized"
        init.assert_called_once_with("gloo", init_method="env://",
                                     world_size=2, rank=1)
    # a configured group that fails to come up raises
    with mock.patch.object(dist, "init_process_group",
                           side_effect=RuntimeError("connect refused")):
        with pytest.raises(RuntimeError, match="connect refused"):
            multihost.initialize(backend="gloo")
    assert not multihost.is_multihost()
    assert multihost.local_batch_slice(16) == (0, 16)


def test_predict_over_two_cpu_replicas(jax_weights):
    """``make_predict_fn(mesh=)`` over two CPU replicas: each half of the
    request through its replica, bit for bit against the meshless predict
    of the same rows; buckets pad first; a batch or bucket that the 'data'
    axis does not divide raises."""
    model = _model("mnist", jax_weights["mnist"][3], True)
    mesh = make_mesh(devices=["cpu", "cpu"])
    x = np.random.default_rng(4).random((16, 1, 28, 28)).astype(np.float32)
    for output in ("logits", "probs", "labels"):
        meshless = make_predict_fn(model, output=output)
        fn = make_predict_fn(model, output=output, mesh=mesh)
        ref = torch.cat([meshless(x[:8]), meshless(x[8:])])
        assert torch.equal(fn(x), ref)
        np.testing.assert_allclose(fn(x).double().numpy(),
                                   meshless(x).double().numpy(), rtol=0,
                                   atol=1e-6)
    fn = make_predict_fn(model, mesh=mesh, buckets=(4, 16))
    assert torch.equal(fn(x[:3]), make_predict_fn(model)(
        np.concatenate([x[:3], x[2:3]]))[:3])
    with pytest.raises(ValueError, match="not divisible by the 'data' axis"):
        make_predict_fn(model, mesh=mesh)(x[:3])
    with pytest.raises(ValueError, match=r"buckets \[3\] not divisible"):
        make_predict_fn(model, mesh=mesh, buckets=(3, 8))
    group_mesh = mock.Mock(group=object())
    with pytest.raises(ValueError, match="not all local"):
        make_predict_fn(model, mesh=group_mesh)
