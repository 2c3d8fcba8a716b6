"""The port's tensor parallelism (``cnn_pde_tpu_torch/parallel/
tensor_parallel.py``, the SymmetricLayer's TP path in ``pde/ruthotto.py``
and ``Trainer(tp=True)``) against the JAX package on the CPU.

Four gloo ranks, each a process that imports only torch and the port and
runs one torch thread (``_worker``), run every case once (the module
fixture) on a data=2 × model=2 and a data=1 × model=4 mesh; this process,
on two threads, computes JAX's references meanwhile.

The bars are the JAX package's for its TP layer
(``tests/test_tensor_parallel.py``): three SGD-with-momentum steps of a
small FC chain and of a ParabolicBlock net (D = 192) against JAX's
unsharded steps, the losses at rtol 1e-5 and the gradients and parameters
at rtol 1e-4 / atol 1e-6 (SGD: Adam's first step is lr·sign(g), and the
summation order of a psum flips the sign of a gradient near 0);
``Trainer(tp=True)`` on mnist against the meshless Trainer, the epoch's
loss within 1e-3 and the parameters within 2.5e-3 (AdamW), and TP eval
logits against the unsharded forward at rtol 1e-5 / atol 1e-6.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch import nn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
STEP_CASES = [(net, mesh) for net in ("fc", "parabolic") for mesh in MESHES]
SPEC_MODELS = ["cifar10_noconv", "cifar10_hybrid", "mnist", "emotion"]
LR = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """This process on two intra-op threads, the default restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


class ParabolicNet(nn.Module):
    """JAX's test net (``tests/test_tensor_parallel.py::_parabolic_model``):
    a ParabolicBlock (3 channels, 8 x 8, D = 192) and a Linear head."""

    def __init__(self, num_steps=2, compute_dtype=torch.float32):
        super().__init__()
        from cnn_pde_tpu_torch.pde import ParabolicBlock

        self.block = ParabolicBlock(3, 8, num_steps=num_steps, dt=0.5,
                                    compute_dtype=compute_dtype)
        self.head = nn.Linear(192, 10)

    def forward(self, x):
        y = self.block(x)
        return self.head(y.reshape(y.shape[0], -1))


def _net(name, weights):
    from cnn_pde_tpu_torch.models import EnhancedFC

    model = (EnhancedFC(96, [512, 256], 10, dropout_rate=0.0)
             if name == "fc" else ParabolicNet())
    model.load_state_dict(weights[name], strict=True)
    return model


def _batch(name):
    rng = np.random.default_rng(1 if name == "fc" else 9)
    shape = (16, 96) if name == "fc" else (16, 3, 8, 8)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.integers(0, 10, 16).astype(np.int64))


def _sgd_values():
    return {"augment": None, "label_smoothing": 0.1, "clip_norm": None,
            "regularizer": None}


def _tp_steps(name, weights, mesh):
    """Three TP SGD steps (optax.sgd(lr, momentum=0.9) is torch's SGD with
    momentum 0.9): (losses, the first step's gradients as the full
    tensors, the full state_dict after)."""
    from cnn_pde_tpu_torch.parallel import (full_state_dict,
                                            make_tp_train_step,
                                            replicated_like, shard_batch,
                                            shard_pytree, tp_param_specs)

    model = _net(name, weights)
    replicated_like(mesh, model)
    shard_pytree(mesh, model, tp_param_specs(model, mesh))
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9)
    step = make_tp_train_step(model, _sgd_values(), mesh,
                              generator=torch.Generator(),
                              schedule=lambda _: LR, optimizer=opt)
    x, y = shard_batch(mesh, _batch(name))
    losses, grads = [], None
    for i in range(3):
        losses.append(float(step(x, y)[0]))
        if i == 0:
            grads = {n: model.tp_layout.whole(n, p.grad.clone())
                     for n, p in model.named_parameters()}
    return losses, grads, full_state_dict(model)


def _trainer(mesh, weights, device_epoch=True):
    from cnn_pde_tpu_torch.models import build_model
    from cnn_pde_tpu_torch.presets import PRESETS
    from cnn_pde_tpu_torch.train import TrainConfig, Trainer

    model = build_model("mnist", device="cpu", dropout_rate=0.0)
    model.load_state_dict(weights["mnist"], strict=True)
    cfg = TrainConfig(epochs=1, batch_size=16, log_every=10**9,
                      device_epoch=device_epoch)
    trainer = Trainer(model, cfg, PRESETS["mnist"]["train"], mesh=mesh,
                      tp=mesh is not None)
    return trainer, trainer.init_state(6)


def _trainer_epoch(mesh, weights):
    """One mnist epoch (6 steps of 16) on the small synthetic set: (epoch
    record, full state_dict, eval accuracy, eval logits of 8 images)."""
    from cnn_pde_tpu_torch.data import synthetic_dataset
    from cnn_pde_tpu_torch.parallel import full_state_dict

    ds = synthetic_dataset("mnist", train_per_class=10, test_per_class=2)
    trainer, state = _trainer(mesh, weights)
    rec = trainer.train_epoch(state, ds, 0, verbose=False)
    ev = trainer.evaluate(state, ds)
    state.model.eval()
    with torch.no_grad():
        logits = state.model(torch.as_tensor(ds.test_images[:8]))
    return rec, full_state_dict(state.model), ev["acc"], logits


def _worker(rank, port, out):
    """One gloo rank: every case, its results saved to ``out/rank<r>.pt``."""
    torch.set_num_threads(1)
    from cnn_pde_tpu_torch.parallel import (initialize, make_mesh,
                                            shard_pytree, tp_param_specs)
    from cnn_pde_tpu_torch.parallel.hlo_audit import audit
    from cnn_pde_tpu_torch.pde import ParabolicBlock
    from cnn_pde_tpu_torch.train.checkpoint import (load_checkpoint,
                                                    restore_state)

    initialize(f"127.0.0.1:{port}", num_processes=WORLD, process_id=rank,
               backend="gloo")
    weights = torch.load(os.path.join(out, "weights.pt"))
    meshes = {k: make_mesh(data=d, model=m, device="cpu")
              for k, (d, m) in MESHES.items()}
    res = {"coords": {k: m.coords for k, m in meshes.items()}}
    for name, key in STEP_CASES:
        res[(name, key)] = _tp_steps(name, weights, meshes[key])
    # the blocks a rank holds
    mesh = meshes["2x2"]
    model = _net("fc", weights)
    shard_pytree(mesh, model, tp_param_specs(model, mesh))
    res["block_shapes"] = {k: tuple(v.shape)
                           for k, v in model.state_dict().items()}
    # one all-reduce a SymmetricLayer call, forward
    for n_steps in (1, 3):
        block = ParabolicBlock(3, 8, num_steps=n_steps, dt=0.5).eval()
        block.reset_parameters(torch.Generator().manual_seed(0))
        shard_pytree(meshes["1x4"], block,
                     tp_param_specs(block, meshes["1x4"]))
        with torch.no_grad():
            res[("audit", n_steps)] = audit(block, torch.ones(4, 3, 8, 8))[0]
    # both grades of the Ruthotto products under TP: the full hybrid's
    # train step (exact) and a bf16 ParabolicNet's gradients
    for dtype in (torch.float32, torch.bfloat16):
        net = ParabolicNet(compute_dtype=dtype)
        net.load_state_dict(weights["parabolic"])
        shard_pytree(meshes["1x4"], net, tp_param_specs(net, meshes["1x4"]))
        x, y = _batch("parabolic")
        loss = nn.functional.cross_entropy(net(torch.as_tensor(x)),
                                           torch.as_tensor(y))
        loss.backward()
        res[("grade", dtype)] = (float(loss), {
            n: net.tp_layout.whole(n, p.grad)
            for n, p in net.named_parameters()})
    res["hybrid"] = _dropout_step("cifar10_hybrid", weights, mesh)
    for key in MESHES:
        res[("mnist dropout", key)] = _dropout_step("mnist", weights,
                                                    meshes[key])
    # the Trainer, and its checkpoints: unsharded on disk, sliced back
    res["trainer"] = _trainer_epoch(mesh, weights)
    from cnn_pde_tpu_torch.data import synthetic_dataset

    ckpt = os.path.join(out, "ckpt")
    trainer, state = _trainer(mesh, weights, device_epoch=False)
    trainer.fit(state, synthetic_dataset("mnist", train_per_class=10,
                                         test_per_class=2),
                verbose=False, checkpoint_dir=ckpt, checkpoint_every=1)
    trained = {k: v.clone() for k, v in state.model.state_dict().items()}
    moments = [v["exp_avg"].clone() for v in
               state.optimizer.state_dict()["state"].values()]
    _, fresh = _trainer(mesh, weights, device_epoch=False)
    restore_state(fresh, ckpt, tag="last")
    res["restored"] = (
        all(torch.equal(trained[k], v)
            for k, v in fresh.model.state_dict().items()),
        all(torch.equal(a, b["exp_avg"]) for a, b in zip(
            moments, fresh.optimizer.state_dict()["state"].values())))
    if rank == 0:
        res["saved_shapes"] = {k: tuple(v.shape) for k, v in
                               load_checkpoint(ckpt, "last")["model"].items()}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _dropout_model(name, weights):
    """The hybrid (exact grade) or mnist, with its preset's dropout rate
    (0.4 for the hybrid's head, whose Dropouts sit between column- and
    row-parallel Linears; 0.3 for mnist's one Dropout, used on the
    replicated input of the column-parallel fc1 and on its
    feature-sharded output)."""
    from cnn_pde_tpu_torch.models import build_model

    kwargs = ({"dropout_rate": 0.4, "ruthotto_dtype": torch.float32}
              if name == "cifar10_hybrid" else {"dropout_rate": 0.3})
    model = build_model(name, device="cpu", **kwargs)
    model.load_state_dict(weights[name])
    return model


def _dropout_batch(name):
    rng = np.random.default_rng(4)
    shape = (8, 3, 32, 32) if name == "cifar10_hybrid" else (16, 1, 28, 28)
    return (rng.random(shape).astype(np.float32),
            rng.integers(0, 10, shape[0]).astype(np.int64))


def _dropout_step(name, weights, mesh=None):
    """One preset step (no augmentation) of ``_dropout_model`` with the
    dropout masks drawn from a seeded generator, TP on ``mesh`` (None:
    unsharded): (loss, every clipped gradient as the full tensor)."""
    from cnn_pde_tpu_torch.parallel import make_tp_train_step, shard_batch
    from cnn_pde_tpu_torch.presets import PRESETS
    from cnn_pde_tpu_torch.train import make_train_step

    model = _dropout_model(name, weights)
    values = dict(PRESETS[name]["train"], augment=None)
    gen = torch.Generator().manual_seed(5)
    if mesh is None:
        step = make_train_step(model, values, 3, gen)
        loss = float(step(*map(torch.as_tensor, _dropout_batch(name)))[0])
        return loss, {n: p.grad.clone() for n, p in model.named_parameters()}
    step = make_tp_train_step(model, values, mesh, steps_per_epoch=3,
                              generator=gen)
    loss = float(step(*shard_batch(mesh, _dropout_batch(name)))[0])
    return loss, {n: model.tp_layout.whole(n, p.grad)
                  for n, p in model.named_parameters()}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_port(params, state):
    """A JAX (params, state) as a port state_dict: dotted paths, ``w``
    transposed to ``weight``, ``b``/``scale`` to ``bias``/``weight``,
    ``mean``/``var`` to the running statistics."""
    out = {}

    def walk(tree, path, is_state):
        for k, v in tree.items():
            p = f"{path}.{k}" if path else str(k)
            if isinstance(v, dict):
                walk(v, p, is_state)
                continue
            head, _, leaf = p.rpartition(".")
            if is_state:
                leaf = {"mean": "running_mean", "var": "running_var"}[leaf]
                out[f"{head}.num_batches_tracked"] = torch.tensor(0)
            else:
                leaf = {"w": "weight", "b": "bias", "scale": "weight",
                        "bias": "bias"}[leaf]
            arr = np.array(v)
            out[f"{head}.{leaf}"] = torch.as_tensor(
                arr.T.copy() if leaf == "weight" and arr.ndim == 2 else arr)

    walk(params, "", False)
    walk(state, "", True)
    return out


def _jax_nets():
    """JAX's EnhancedFC(96, [512, 256], 10) and ParabolicNet with their
    init weights."""
    import jax

    from cnn_pde_tpu.models.cifar10_noconv import EnhancedFC
    from cnn_pde_tpu.nn.core import Module
    from cnn_pde_tpu.nn.layers import Linear
    from cnn_pde_tpu.pde import ParabolicBlock

    class JaxParabolicNet(Module):
        def __init__(self):
            self.block = ParabolicBlock(3, 8, num_steps=2, dt=0.5)
            self.head = Linear(192, 10)

        def init(self, key):
            k1, k2 = jax.random.split(key)
            pb, sb = self.block.init(k1)
            ph, _ = self.head.init(k2)
            return {"block": pb, "head": ph}, {"block": sb}

        def apply(self, params, state, x, ctx):
            y, sb = self.block.apply(params["block"], state["block"], x, ctx)
            logits, _ = self.head.apply(params["head"], {},
                                        y.reshape(y.shape[0], -1), ctx)
            return logits, {"block": sb}

    out = {}
    for name, model in (("fc", EnhancedFC(96, [512, 256], 10,
                                          dropout_rate=0.0)),
                        ("parabolic", JaxParabolicNet())):
        params, state = jax.tree_util.tree_map(
            np.asarray, model.init(jax.random.PRNGKey(0)))
        sd = _to_port(params, state)
        if name == "fc":
            sd = {f"network.{k}": v for k, v in sd.items()}
        else:
            sd = {k.replace(".sym.", ".symmetric_layer."): v
                  for k, v in sd.items()}
        out[name] = (model, params, state, sd)
    return out


def _jax_sgd(model, params, state, name):
    """JAX's unsharded reference: three SGD(momentum 0.9) steps, the
    losses, the first gradients and the parameters after, in the port's
    names."""
    import jax
    import jax.numpy as jnp
    import optax

    from cnn_pde_tpu.nn.core import Ctx
    from cnn_pde_tpu.train.losses import cross_entropy

    opt = optax.sgd(LR, momentum=0.9)
    x, y = map(jnp.asarray, _batch(name))

    def loss_fn(p, ms):
        logits, new_ms = model.apply(p, ms, x, Ctx(train=True))
        return cross_entropy(logits, y, 0.1), new_ms

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    p, ms, os_ = params, state, opt.init(params)
    losses, first = [], None
    for i in range(3):
        (loss, ms), g = grad_fn(p, ms)
        if i == 0:
            first = g
        upd, os_ = opt.update(g, os_, p)
        p = optax.apply_updates(p, upd)
        losses.append(float(loss))
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return losses, np_(first), np_(p)


@pytest.fixture(scope="module")
def jax_weights():
    import jax

    from cnn_pde_tpu.models import CIFAR10HybridPDEModel, MNISTClassifier
    from cnn_pde_tpu_torch.compat import state_dict_from_jax

    nets = _jax_nets()
    weights = {k: v[3] for k, v in nets.items()}
    for name, model in (("mnist", MNISTClassifier(dropout_rate=0.0)),
                        ("cifar10_hybrid",
                         CIFAR10HybridPDEModel(dropout_rate=0.0))):
        params, state = jax.tree_util.tree_map(
            np.asarray, jax.jit(model.init)(jax.random.PRNGKey(2)))
        weights[name] = state_dict_from_jax(params, state, name)
    return nets, weights


@pytest.fixture(scope="module")
def world(jax_weights, tmp_path_factory):
    """The four gloo ranks' results, with JAX's SGD steps computed while
    they run."""
    nets, weights = jax_weights
    out = str(tmp_path_factory.mktemp("tp"))
    torch.save(weights, os.path.join(out, "weights.pt"))
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    code = ("import sys; from tests.test_torch_port_tensor_parallel import "
            "_worker; _worker(int(sys.argv[1]), int(sys.argv[2]), "
            "sys.argv[3])")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port),
                               out], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORLD)]
    try:
        ref = {name: _jax_sgd(*nets[name][:3], name) for name in nets}
        logs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (o, e) in zip(procs, logs):
        assert p.returncode == 0, (o + e)[-4000:]
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return ranks, ref, out


def _jax_specs(name):
    """JAX's tp_param_specs of the full model on make_mesh(data=2,
    model=4), as {port state_dict name: torch-layout spec}."""
    import jax

    from cnn_pde_tpu.models import MODEL_REGISTRY
    from cnn_pde_tpu.parallel import P, make_mesh, tp_param_specs
    from cnn_pde_tpu_torch.compat import _torch_key

    model = MODEL_REGISTRY[name]()
    params, _ = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    specs = tp_param_specs(params, make_mesh(data=2, model=4))
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda s: isinstance(s, P))[0]:
        dotted = ".".join(str(k.key) for k in path)
        key = _torch_key(dotted, is_state=False, preset=name)
        spec = tuple(spec)
        out[key] = spec[::-1] if dotted.endswith(".w") and spec else spec
    return out


@pytest.mark.parametrize("name", SPEC_MODELS)
def test_tp_param_specs_match_jax(name):
    """Every parameter's spec equals JAX's at data=2 x model=4, JAX's
    (in, out) layout swapped for torch's (out, in)."""
    from cnn_pde_tpu_torch.models import build_model
    from cnn_pde_tpu_torch.parallel import make_mesh, tp_param_specs

    model = build_model(name, device="cpu")
    mesh = make_mesh(data=2, model=4, devices=["cpu"] * 8)
    ours = tp_param_specs(model, mesh)
    ref = _jax_specs(name)
    params = dict(model.named_parameters())
    assert set(ref) == set(params)
    for key in params:
        assert ours[key] == ref[key], (key, ours[key], ref[key])
    assert any(ours.values())
    # the sharded BatchNorms' statistics ride their parameters' shard
    for key, spec in ours.items():
        if key.endswith("running_mean"):
            assert spec == ours[key.replace("running_mean", "weight")]


def test_trivial_model_axis_is_fully_replicated():
    from cnn_pde_tpu_torch.models import build_model
    from cnn_pde_tpu_torch.parallel import make_mesh, tp_param_specs

    model = build_model("cifar10_hybrid", device="cpu")
    specs = tp_param_specs(model, make_mesh(data=8, devices=["cpu"] * 8))
    assert set(specs) == set(model.state_dict())
    assert not any(specs.values())


@pytest.mark.parametrize("name,mesh", STEP_CASES)
def test_tp_sgd_steps_match_jax(world, name, mesh):
    """Three TP SGD steps against JAX's unsharded steps: the losses, the
    first step's gradients and the parameters after, every rank alike."""
    ranks, ref, _ = world
    losses_ref, grads_ref, params_ref = ref[name]
    for res in ranks:
        losses, grads, post = res[(name, mesh)]
        np.testing.assert_allclose(losses, losses_ref, rtol=1e-5)
        for tree, got in ((grads_ref, grads), (params_ref, post)):
            for key, want in _to_port(tree, {}).items():
                key = ("network." + key if name == "fc" else
                       key.replace(".sym.", ".symmetric_layer."))
                np.testing.assert_allclose(got[key].numpy(), want.numpy(),
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=key)


def test_tp_blocks_are_distributed(world):
    """Each rank of data=2 x model=2 holds half of the 96->512 column
    weight, of its bias and BatchNorm, and of the 512->256 row weight."""
    ranks, _, _ = world
    shapes = ranks[0]["block_shapes"]
    assert shapes["network.0.weight"] == (256, 96)
    assert shapes["network.0.bias"] == (256,)
    assert shapes["network.1.weight"] == shapes["network.1.running_var"] \
        == (256,)
    assert shapes["network.4.weight"] == (256, 256)
    assert shapes["network.4.bias"] == (256,)
    assert shapes["network.8.weight"] == (10, 256)


def test_symmetric_layer_one_all_reduce_a_call(world):
    ranks, _, _ = world
    for res in ranks:
        for n_steps in (1, 3):
            c = res[("audit", n_steps)]
            assert c["all-reduce"] == n_steps, (n_steps, c)
            assert c["all-to-all"] == c["all-gather"] == 0, c


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_symmetric_layer_grades_under_tp(world, jax_weights, dtype):
    """The SymmetricLayer's exact and bf16 grades under TP (model=4): the
    loss and every gradient against the unsharded layer in that grade.  In
    the bf16 grade the input's cotangent is summed over 'model' in float32
    and rounded to bf16 once, as the unsharded product rounds it; the
    order of that sum can move a value across a bf16 rounding boundary,
    so the gradients also get one bf16 step of the tensor's largest
    element (2^-9 of it) of absolute slack."""
    ranks, _, _ = world
    net = ParabolicNet(compute_dtype=dtype)
    net.load_state_dict(jax_weights[1]["parabolic"])
    x, y = _batch("parabolic")
    loss = nn.functional.cross_entropy(net(torch.as_tensor(x)),
                                       torch.as_tensor(y))
    loss.backward()
    loss = float(loss)
    for res in ranks:
        got_loss, grads = res[("grade", dtype)]
        assert abs(got_loss - loss) <= 1e-5 * abs(loss)
        for n, p in net.named_parameters():
            ref = p.grad.float().numpy()
            slack = (2.0 ** -9 * np.abs(ref).max() if dtype == torch.bfloat16
                     else 0.0)
            np.testing.assert_allclose(grads[n].float().numpy(), ref,
                                       rtol=1e-4, atol=max(1e-6, slack),
                                       err_msg=n)


def _hold_dropout_step(got, want):
    """A TP step's loss (rtol 1e-5) and every gradient (rtol 1e-4, atol
    1e-6) against the unsharded step's."""
    loss, grads = want
    got_loss, got_grads = got
    assert abs(got_loss - loss) <= 1e-5 * abs(loss)
    assert set(got_grads) == set(grads)
    for n, g in grads.items():
        np.testing.assert_allclose(got_grads[n].numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=n)


def test_hybrid_tp_step_matches_unsharded(world, jax_weights):
    """The full hybrid (exact grade, dropout 0.4) at data=2 x model=2: one
    preset step's loss (the regulariser's K term summed over 'model') and
    every gradient (the sharded head with its column-shard BatchNorms and
    dropout masks, the attention MLP whose output is gathered, the K
    blocks, the replicated rest) against the unsharded step's, the masks
    drawn from the same seeded generator."""
    ranks, _, _ = world
    want = _dropout_step("cifar10_hybrid", jax_weights[1])
    for res in ranks:
        _hold_dropout_step(res["hybrid"], want)


def test_mnist_shared_dropout_tp_step_matches_unsharded(world, jax_weights):
    """mnist with dropout 0.3 at data=2 x model=2 and data=1 x model=4: its
    one Dropout draws a replicated mask before the column-parallel fc1 and
    a feature-sharded one after it; the loss and every gradient against
    the unsharded step's."""
    ranks, _, _ = world
    want = _dropout_step("mnist", jax_weights[1])
    for key in MESHES:
        for res in ranks:
            _hold_dropout_step(res[("mnist dropout", key)], want)


def test_trainer_tp_matches_meshless(world, jax_weights):
    """``Trainer(mesh=make_mesh(data=2, model=2), tp=True)``: one mnist
    device epoch against the meshless Trainer (loss 1e-3, parameters
    2.5e-3), and its eval logits against the unsharded forward of its own
    weights (1e-5 / 1e-6)."""
    from cnn_pde_tpu_torch.models import build_model

    ranks, _, _ = world
    rec, post, acc, _ = _trainer_epoch(None, jax_weights[1])
    for res in ranks:
        got_rec, got_post, got_acc, logits = res["trainer"]
        assert abs(got_rec["loss"] - rec["loss"]) < 1e-3
        for key, ref in post.items():
            np.testing.assert_allclose(got_post[key].double().numpy(),
                                       ref.double().numpy(), rtol=0,
                                       atol=2.5e-3, err_msg=key)
        assert abs(got_acc - acc) <= 5.0 + 1e-9
        model = build_model("mnist", device="cpu", dropout_rate=0.0)
        model.load_state_dict(got_post)
        from cnn_pde_tpu_torch.data import synthetic_dataset

        ds = synthetic_dataset("mnist", train_per_class=10, test_per_class=2)
        with torch.no_grad():
            ref_logits = model(torch.as_tensor(ds.test_images[:8]))
        np.testing.assert_allclose(logits.numpy(), ref_logits.numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_tp_checkpoints_are_unsharded_and_restored(world, jax_weights):
    """Rank 0 writes the unsharded names and shapes; every rank restores
    its block of the weights and of Adam's moments bit for bit."""
    ranks, _, _ = world
    assert ranks[0]["saved_shapes"] == {
        k: tuple(v.shape) for k, v in jax_weights[1]["mnist"].items()}
    for res in ranks:
        assert res["restored"] == (True, True)


def test_train_cli_tp(tmp_path):
    """``--tp 2`` (mnist) in a world of two gloo processes: the mesh line
    and the summary JSON, printed by rank 0 only, and an unsharded
    checkpoint."""
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cnn_pde_tpu_torch.train", "--preset",
             "mnist", "--synthetic", "--epochs", "1", "--steps", "3",
             "--batch-size", "16", "--tp", "2", "--device", "cpu",
             "--checkpoint-dir", str(tmp_path / "ckpt"),
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
    assert "Mesh: data=1 x spatial=1 x model=2 (2 devices)" in out, out
    result = json.loads(out.strip().splitlines()[-1])
    assert result["preset"] == "mnist" and result["steps"] == 3
    assert np.isfinite(result["first_loss"]) and result["devices"] == 2
    assert logs[1][0].strip() == ""
    saved = torch.load(tmp_path / "ckpt" / "best.ckpt", weights_only=True)
    assert tuple(saved["model"]["fc1.weight"].shape) == (256, 784)
