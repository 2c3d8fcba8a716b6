"""Branch parallelism (``cnn_pde_tpu_torch/parallel/branch_parallel.py``)
against the JAX package on the CPU: the flagship's hoisted lockstep with
its branch axis split over the mesh's 'model' axis.

Six gloo ranks, each a process that imports only torch and the port and
runs one torch thread (``_worker``), run every case once (the module
fixture) on three meshes: data=2 × model=3 (JAX's own test mesh, one
branch a rank), data=3 × model=2 (the uneven split, 2 + 1 branches, which
JAX's GSPMD pads) and data=1 × model=6 (three ranks without a branch).
This process computes JAX's unsharded references meanwhile, and the
port's meshless Trainer runs.

Tolerances: features and every extractor gradient against JAX's
unsharded ``lockstep_hoisted`` model at JAX's bar (atol 2e-5, gradients
scaled by max(1, largest entry); ``tests/test_branch_parallel.py``), on
its inputs and perturbed weights; the ranks bit for bit alike.
``Trainer(mesh=)`` (host loop; at data=3 × model=2 the device epoch too)
against the meshless Trainer on the same global batches, at
``test_torch_port_data_parallel.py``'s bars: the epoch's mean loss within
1e-4 and the parameters within 5e-5 where the meshless first step's
gradient exceeds 1e-6, the ranks bit for bit alike.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 6
MESHES = {"2x3": (2, 3), "3x2": (3, 2), "1x6": (1, 6)}
# the meshes whose Trainer runs, and on which loops
TRAINER_RUNS = {"2x3": (False,), "3x2": (False, True)}
BATCH = 12  # the global batch: divisible by every 'data' size
STEPS = 2
PARAM_TOL = 5e-5
ZERO_IN_EXACT_ARITHMETIC = {"feature_bn.bias"} | {
    f"classifier.network.{i}.bias" for i in (0, 4, 8, 12)}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """This process on two intra-op threads, the default restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _inputs():
    """The JAX test's batch (B = 4)."""
    return np.random.default_rng(0).random((4, 3, 32, 32)).astype(
        np.float32)


def _model(weights, mesh=None, dropout_rate=0.0):
    """The port's flagship with ``weights``: branch-parallel over
    ``mesh``, or (None) the meshless hoisted lockstep."""
    from cnn_pde_tpu_torch.models import build_model
    from cnn_pde_tpu_torch.parallel import enable_branch_parallel

    model = build_model("cifar10_noconv", device="cpu",
                        dropout_rate=dropout_rate)
    model.load_state_dict(weights, strict=True)
    if mesh is None:
        model.feature_extractor.lockstep_hoisted = True
        return model, 0
    return model, enable_branch_parallel(model, mesh)


def _features_and_grads(model):
    """The extractor's features of the batch and the gradients of Σ f²."""
    f = model.feature_extractor(torch.from_numpy(_inputs()))
    (f ** 2).sum().backward()
    return f.detach(), {n: p.grad.clone() for n, p in
                        model.feature_extractor.named_parameters()}


def _trainer_run(weights, mesh, device_epoch):
    """``STEPS`` steps of ``Trainer`` (the preset's augmentation, dropout
    and AdamW) at the global batch ``BATCH``: (epoch record, parameters,
    the first step's gradients)."""
    from cnn_pde_tpu_torch.data import synthetic_dataset
    from cnn_pde_tpu_torch.presets import PRESETS
    from cnn_pde_tpu_torch.train import TrainConfig, Trainer

    values = PRESETS["cifar10_noconv"]["train"]
    model, _ = _model(weights, mesh, dropout_rate=0.3)
    trainer = Trainer(model, TrainConfig.from_preset(
        values, epochs=1, batch_size=BATCH, max_steps_per_epoch=STEPS,
        seed=3, device_epoch=device_epoch, log_every=10**9), values,
        mesh=mesh)
    state = trainer.init_state(STEPS)
    first = {}

    def keep(p, name):
        first.setdefault(name, p.grad.clone())

    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: keep(p, n)) for n, p in model.named_parameters()]
    rec = trainer.train_epoch(state, synthetic_dataset(
        "cifar10", train_per_class=3, test_per_class=1), 0, verbose=False)
    for h in hooks:
        h.remove()
    return (rec, {n: p.detach().clone() for n, p in
                  model.named_parameters()}, first)


def _worker(rank, port, out):
    """One gloo rank: every case, its results saved to ``out/rank<r>.pt``."""
    torch.set_num_threads(1)
    from cnn_pde_tpu_torch.parallel import initialize, make_mesh
    from cnn_pde_tpu_torch.parallel.hlo_audit import audit

    initialize(f"127.0.0.1:{port}", num_processes=WORLD, process_id=rank,
               backend="gloo")
    weights = torch.load(os.path.join(out, "weights.pt"))
    res = {}
    for key, (data, model_size) in MESHES.items():
        mesh = make_mesh(data=data, model=model_size, device="cpu")
        res[(key, "shape")] = (mesh.shape, mesh.coords)
        model, res[(key, "switched")] = _model(weights, mesh)
        res[(key, "features")] = _features_and_grads(model)
        x = torch.from_numpy(_inputs())
        with torch.no_grad():
            res[(key, "forward")] = audit(model.feature_extractor, x)[:2]
        loss = (model.feature_extractor(x) ** 2).sum()
        params = list(model.feature_extractor.parameters())
        res[(key, "backward")] = audit(torch.autograd.grad, loss,
                                       params)[:2]
        for device_epoch in TRAINER_RUNS.get(key, ()):
            res[(key, "trainer", device_epoch)] = _trainer_run(
                weights, mesh, device_epoch)
    # the port's modules on these paths import neither JAX nor its package
    res["foreign"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "cnn_pde_tpu"))
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_weights():
    """The JAX flagship's init with every weight moved by 0.02·N(0, 1)
    (the JAX test's), and those as the port's state dict."""
    import jax

    from cnn_pde_tpu.models.cifar10_noconv import CIFAR10PDENoConv
    from cnn_pde_tpu_torch.compat import state_dict_from_jax

    key = jax.random.PRNGKey(0)
    model = CIFAR10PDENoConv()
    model.extractor.lockstep_hoisted = True
    params, state = model.init(key)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a + 0.02 * jax.random.normal(
            jax.random.fold_in(key, a.size), a.shape)), params)
    state = jax.tree_util.tree_map(np.asarray, state)
    return model, params, state, state_dict_from_jax(params, state)


def _jax_reference(model, params, state):
    """JAX's unsharded hoisted lockstep: features and the gradients of
    Σ f², by the port's names."""
    import jax
    import jax.numpy as jnp

    from cnn_pde_tpu.nn import Ctx
    from cnn_pde_tpu_torch.compat import state_dict_from_jax

    def loss(p, s, x):
        f, _ = model.extractor.apply(p["feature_extractor"],
                                     s["feature_extractor"], x,
                                     Ctx(train=False))
        return jnp.sum(f ** 2), f

    (_, f), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, state, jnp.asarray(_inputs()))
    grads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, g),
                                state)
    return np.asarray(f), {k: v for k, v in grads.items()
                           if k.startswith("feature_extractor.")}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The six gloo ranks' results, with JAX's references and the meshless
    Trainer runs made while they run."""
    out = str(tmp_path_factory.mktemp("branch"))
    model, params, state, weights = _jax_weights()
    torch.save(weights, os.path.join(out, "weights.pt"))
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    code = ("import sys; from tests.test_torch_port_branch_parallel import "
            "_worker; _worker(int(sys.argv[1]), int(sys.argv[2]), "
            "sys.argv[3])")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port),
                               out], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORLD)]
    try:
        ref = _jax_reference(model, params, state)
        meshless = {de: _trainer_run(weights, None, de)
                    for de in (False, True)}
        logs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (o, e) in zip(procs, logs):
        assert p.returncode == 0, (o + e)[-4000:]
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return ranks, ref, meshless, weights


def test_meshes_in_a_six_rank_world(world):
    """The three meshes over six ranks; each rank's process, which ran
    the lockstep, the gather and the Trainer, imported neither JAX nor
    the JAX package."""
    ranks, _, _, _ = world
    for r, res in enumerate(ranks):
        assert res["foreign"] == []
        for key, (data, model) in MESHES.items():
            shape, coords = res[(key, "shape")]
            assert shape == {"data": data, "spatial": 1, "model": model}
            assert coords == (r // model, 0, r % model)
            assert res[(key, "switched")] == 1


@pytest.mark.parametrize("key", list(MESHES))
def test_features_and_gradients_match_jax(world, key):
    """Every rank's features and every extractor gradient against JAX's
    unsharded hoisted lockstep; the ranks bit for bit alike (each branch's
    gradient counted once on every rank, whether it owns the branch or
    not)."""
    ranks, (f_ref, g_ref), _, _ = world
    f, grads = ranks[0][(key, "features")]
    assert grads.keys() == {k[len("feature_extractor."):] for k in g_ref}
    np.testing.assert_allclose(f.numpy(), f_ref, rtol=0, atol=2e-5)
    for name, g in grads.items():
        ref = g_ref[f"feature_extractor.{name}"].numpy()
        scale = max(1.0, float(np.max(np.abs(ref))))
        np.testing.assert_allclose(g.numpy() / scale, ref / scale, rtol=0,
                                   atol=2e-5, err_msg=name)
    for res in ranks[1:]:
        f_r, g_r = res[(key, "features")]
        assert torch.equal(f_r, f)
        for name, g in grads.items():
            assert torch.equal(g_r[name], g), name


@pytest.mark.parametrize("key", list(MESHES))
def test_one_gather_a_forward(world, key):
    """A forward makes one all-gather over 'model' and no other
    collective, so none inside the evolution; its payload is the padded
    block of ceil(3 / M) branches.  The backward makes one all-reduce
    (the branch parameters' gradients) and nothing else: the gather's
    backward keeps the rank's block without a collective."""
    ranks, _, _, _ = world
    _, model = MESHES[key]
    per = -(-3 // model)
    for res in ranks:
        counts, shapes = res[(key, "forward")]
        assert counts == {"all-reduce": 0, "all-gather": 1, "all-to-all": 0,
                          "collective-permute": 0, "reduce-scatter": 0}
        assert shapes == [(model, 4 * per * 3 * 32 * 32)]
        counts, shapes = res[(key, "backward")]
        assert counts == {"all-reduce": 1, "all-gather": 0, "all-to-all": 0,
                          "collective-permute": 0, "reduce-scatter": 0}


@pytest.mark.parametrize("key,device_epoch",
                         [(k, de) for k, runs in TRAINER_RUNS.items()
                          for de in runs])
def test_trainer_under_mesh_matches_meshless(world, key, device_epoch):
    """``Trainer(mesh=)`` on the branch-parallel model (every rank its
    rows of each global batch and its branches) against the meshless
    Trainer on the hoisted lockstep model."""
    ranks, _, meshless, _ = world
    rec_ref, params_ref, first = meshless[device_epoch]
    rec, params, _ = ranks[0][(key, "trainer", device_epoch)]
    assert abs(rec["loss"] - rec_ref["loss"]) <= 1e-4
    for res in ranks[1:]:
        other = res[(key, "trainer", device_epoch)]
        assert other[0]["loss"] == rec["loss"]
        for name, p in params.items():
            assert torch.equal(other[1][name], p), name
    for name, ref in params_ref.items():
        if name in ZERO_IN_EXACT_ARITHMETIC:
            continue
        moved = first[name].abs() > 1e-6
        err = float((params[name] - ref)[moved].abs().max()) \
            if moved.any() else 0.0
        assert err <= PARAM_TOL, (name, err)


def test_branch_blocks():
    """Blocks of ceil(K / M) branches, as GSPMD pads an uneven split."""
    from cnn_pde_tpu_torch.pde.fused_multiscale import branch_block

    assert [branch_block(3, i, 2) for i in range(2)] == [(0, 2), (2, 3)]
    assert [branch_block(3, i, 3) for i in range(3)] == [(0, 1), (1, 2),
                                                        (2, 3)]
    assert [branch_block(3, i, 4) for i in range(4)] == [
        (0, 1), (1, 2), (2, 3), (3, 3)]
    assert branch_block(3, 0, 1) == (0, 3)


def test_one_process_mesh_is_the_hoisted_lockstep(world):
    """``enable_branch_parallel`` over a mesh of this process (a 'model'
    axis of one) runs the meshless hoisted lockstep, bit for bit; with
    ``tp`` or ``image_spec`` the Trainer refuses the combination."""
    from cnn_pde_tpu_torch.parallel import make_mesh
    from cnn_pde_tpu_torch.presets import PRESETS
    from cnn_pde_tpu_torch.train import TrainConfig, Trainer

    _, _, _, weights = world
    mesh = make_mesh(device="cpu")
    model, switched = _model(weights, mesh)
    assert switched == 1
    f, grads = _features_and_grads(model)
    f_ref, grads_ref = _features_and_grads(_model(weights)[0])
    assert torch.equal(f, f_ref)
    for name, g in grads.items():
        assert torch.equal(g, grads_ref[name]), name
    values = PRESETS["cifar10_noconv"]["train"]
    for kw in ({"tp": True}, {"image_spec": ("data", None, None, None)}):
        with pytest.raises(ValueError, match="branch parallelism combined"):
            Trainer(model, TrainConfig(batch_size=8), values, mesh=mesh,
                    **kw)
