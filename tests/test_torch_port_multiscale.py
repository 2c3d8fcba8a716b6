"""The flagship's study modes (``pde/fused_multiscale.py`` and
``models/cifar10_noconv.py``) against the JAX package on the CPU: the
per-sweep lockstep (``fused_multiscale=True``), the hoisted lockstep on
precomputed operators (``lockstep_hoisted``) in float32 and in the AMP
grade's bf16, through the model, the Trainer, the predict and the device
epoch, and the solves each mode makes.  JAX-initialised weights come in
through ``state_dict_from_jax``.

Tolerances: the lockstep evolution rtol 1e-5 / atol 1e-6 (JAX's
``tests/test_fused_multiscale.py``); model logits 1e-4; train-mode
gradients 1e-4 of each tensor's largest entry + 1e-6 (dropout 0, a batch
without max-pool near ties, ``test_torch_port_train.py``'s case); the
hoisted lockstep's features atol 1e-5 and its gradients 2e-5 of
max(1, largest entry), on the JAX test's own inputs and perturbed
weights; the bf16 grade 4e-3 (features) and 6e-3 (gradients) of the
largest entry against the JAX bf16 grade, with its bf16 product run as
``test_torch_port_amp.py`` runs it (``_emulate_jax_bf16``), and a control
whose every GEMM returns a bf16-rounded result that must miss those bars;
``Trainer.fit`` against the sequential model's: each epoch's mean loss
1e-4 relative and the test accuracies equal (``test_torch_port_trainer
.py``'s bars).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cnn_pde_tpu.ops.tridiag as jax_tridiag
from cnn_pde_tpu.models.cifar10_noconv import CIFAR10PDENoConv as JaxModel
from cnn_pde_tpu.models.cifar10_noconv import MultiScaleExtractor as JaxExt
from cnn_pde_tpu.nn import Ctx
from cnn_pde_tpu.pde.amp import enable_amp as jax_enable_amp
from cnn_pde_tpu.pde.fused_multiscale import (
    fused_multiscale_evolve as jax_fused_evolve)
from cnn_pde_tpu.train.losses import cross_entropy as jax_cross_entropy
from cnn_pde_tpu_torch.compat import state_dict_from_jax
from cnn_pde_tpu_torch.data import synthetic_dataset
from cnn_pde_tpu_torch.models import build_model
from cnn_pde_tpu_torch.ops import tridiag
from cnn_pde_tpu_torch.pde import enable_amp
from cnn_pde_tpu_torch.pde.fused_multiscale import fused_multiscale_evolve
from cnn_pde_tpu_torch.presets import PRESETS
from cnn_pde_tpu_torch.serve import make_predict_fn
from cnn_pde_tpu_torch.train import TrainConfig, Trainer

from tests.test_torch_port_train_model import ZERO_IN_EXACT_ARITHMETIC

MODES = ("fused", "hoisted")
SCALES = JaxExt._SCALES
EVOLVE_KW = dict(dts=[s["dt"] for s in SCALES],
                 steps_list=[s["num_steps"] for s in SCALES],
                 dxs=[s["dx"] for s in SCALES],
                 dys=[s["dy"] for s in SCALES])


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six test
    files at once on one host, and eight threads each oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def restore_impls():
    """Both packages' global solver default, restored after the test (the
    JAX ``enable_amp`` sets it)."""
    jax_prev = jax_tridiag.set_default_impl("auto")
    prev = tridiag.set_default_impl("auto")
    try:
        yield
    finally:
        jax_tridiag.set_default_impl(jax_prev)
        tridiag.set_default_impl(prev)


@pytest.fixture
def _emulate_jax_bf16(monkeypatch):
    """Run the JAX bf16 apply on the CPU: X and d rounded to bf16, the
    product in float32 (the bf16 × bf16 → float32 dot has no CPU kernel)."""
    apply = jax_tridiag._inv_apply_einsum

    def emulated(X, d, transpose):
        if X.dtype == jnp.bfloat16:
            X = X.astype(jnp.float32)
            d = d.astype(jnp.bfloat16).astype(jnp.float32)
        return apply(X, d, transpose)

    monkeypatch.setattr(jax_tridiag, "_inv_apply_einsum", emulated)


def _rel(x, y):
    """max |x − y| over the largest |y|."""
    x, y = (np.asarray(t, np.float64) for t in (x, y))
    return float(np.max(np.abs(x - y)) / max(np.max(np.abs(y)), 1e-30))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(sd, mode=None, dropout_rate=0.0):
    """The port's flagship with ``sd`` loaded strictly, in ``mode``
    (None: sequential)."""
    model = build_model("cifar10_noconv", device="cpu",
                        dropout_rate=dropout_rate,
                        fused_multiscale=mode == "fused")
    model.feature_extractor.lockstep_hoisted = mode == "hoisted"
    model.load_state_dict(sd, strict=True)
    return model


def _jax_model(mode=None, dropout_rate=0.0):
    model = JaxModel(dropout_rate=dropout_rate,
                     fused_multiscale=mode == "fused")
    model.extractor.lockstep_hoisted = mode == "hoisted"
    return model


@pytest.fixture(scope="module")
def jax_flagship():
    model = JaxModel(dropout_rate=0.0)
    params, state = _np(jax.jit(model.init)(jax.random.PRNGKey(5)))
    return params, state, state_dict_from_jax(params, state)


@pytest.fixture(scope="module")
def batch():
    """``test_torch_port_train.py``'s step batch: 8 images whose pooled
    features hold no max-pool near tie."""
    rng = np.random.default_rng(26)
    return (rng.random((8, 3, 32, 32)).astype(np.float32),
            rng.integers(0, 10, 8).astype(np.int32))


def _extractor_grads(model, x):
    """Features of the port's extractor and the gradients of Σ f²."""
    f = model.feature_extractor(torch.from_numpy(x))
    (f ** 2).sum().backward()
    return f.detach().numpy(), {n: p.grad for n, p in
                                model.named_parameters()
                                if p.grad is not None}


def _jax_extractor_grads(model, params, state, x):
    """JAX's features and gradients of Σ f²."""
    def loss(p, s, x):
        f, _ = model.extractor.apply(p["feature_extractor"],
                                     s["feature_extractor"], x,
                                     Ctx(train=False))
        return jnp.sum(f ** 2), f

    (_, f), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, state, jnp.asarray(x))
    return np.asarray(f), state_dict_from_jax(_np(g), state)


def test_fused_multiscale_evolve_matches_jax():
    """The per-sweep lockstep evolution against JAX's and JAX's sequential
    branches, with a perturbed time coefficient (JAX's own case)."""
    rng = np.random.default_rng(0)
    x = rng.random((4, 3, 32, 32)).astype(np.float32)
    ext = JaxExt(32, 3)
    params, _ = _np(ext.init(jax.random.PRNGKey(0)))
    params["pde1"]["alpha_time_coeff"] = (
        rng.standard_normal((3, 32, 32)) * 0.1).astype(np.float32)
    branches = [params[f"pde{i + 1}"] for i in range(3)]
    ref = np.asarray(jax_fused_evolve(jnp.asarray(x), branches, **EVOLVE_KW))
    got = fused_multiscale_evolve(
        torch.from_numpy(x), [{k: torch.tensor(v) for k, v in b.items()}
                              for b in branches], **EVOLVE_KW)
    assert tuple(got.shape) == (3, 4, 3, 32, 32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    for i in range(3):
        seq, _ = ext.pdes[i].apply(branches[i], {}, jnp.asarray(x),
                                   Ctx(False))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(seq),
                                   rtol=1e-5, atol=1e-6)


def test_lockstep_model_logits_match_jax(jax_flagship, batch):
    """``build_model(..., fused_multiscale=True)`` loads the JAX weights
    under the sequential model's names and its eval logits match JAX's
    lockstep model and the port's sequential model within 1e-4."""
    params, state, sd = jax_flagship
    x, _ = batch
    ref, _ = _jax_model("fused")(params, state, jnp.asarray(x))
    model = _port(sd, "fused")
    assert model.feature_extractor.fused
    assert model.state_dict().keys() == _port(sd).state_dict().keys()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        seq = _port(sd)(torch.from_numpy(x)).numpy()
    assert _rel(got, np.asarray(ref)) <= 1e-4
    assert _rel(got, seq) <= 1e-4


@pytest.mark.parametrize("mode", MODES)
def test_lockstep_train_gradients_match_jax(jax_flagship, batch, mode):
    """Train-mode (batch statistics) cross-entropy gradients of each
    lockstep model against JAX's same mode, dropout 0."""
    params, state, sd = jax_flagship
    x, y = batch
    jmodel = _jax_model(mode)

    def loss_fn(p, s):
        logits, ns = jmodel.apply(p, s, x,
                                  Ctx(train=True, rng=jax.random.PRNGKey(0)))
        return jax_cross_entropy(logits, y, 0.1), ns

    # the new state returned, as JAX's Trainer does: a jitted gradient
    # that drops it gave a combine_weights gradient that the eager
    # gradient and central differences both contradict (XLA on the CPU)
    (loss_ref, _), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, state)
    grads = state_dict_from_jax(_np(g), state)
    model = _port(sd, mode).train()
    logits = model(torch.from_numpy(x))
    loss = torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(y).long(), label_smoothing=0.1)
    loss.backward()
    assert abs(loss.item() - float(loss_ref)) <= 1e-4 * abs(float(loss_ref))
    for name, p in model.named_parameters():
        if name in ZERO_IN_EXACT_ARITHMETIC:
            continue
        ref = grads[name].double()
        err = float((p.grad.double() - ref).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()) + 1e-6, (name, err)


def test_hoisted_lockstep_matches_jax_and_sequential():
    """``lockstep_hoisted``'s features and gradients against JAX's hoisted
    lockstep and the port's sequential extractor, on JAX's own test case
    (B = 4, every weight moved by 0.02·N(0, 1))."""
    key = jax.random.PRNGKey(0)
    x = np.random.default_rng(0).random((4, 3, 32, 32)).astype(np.float32)
    model = JaxModel()
    params, state = model.init(key)
    params = _np(jax.tree_util.tree_map(
        lambda a: a + 0.02 * jax.random.normal(
            jax.random.fold_in(key, a.size), a.shape), params))
    state = _np(state)
    f_ref, g_ref = _jax_extractor_grads(_jax_model("hoisted"), params, state,
                                        x)
    sd = state_dict_from_jax(params, state)
    f, g = _extractor_grads(_port(sd, "hoisted"), x)
    f_seq, g_seq = _extractor_grads(_port(sd), x)
    assert np.max(np.abs(f - f_ref)) <= 1e-5
    assert np.max(np.abs(f - f_seq)) <= 1e-5
    assert g.keys() == g_seq.keys() and len(g) == 31
    for name, got in g.items():
        for ref in (g_ref[name], g_seq[name]):
            scale = max(1.0, float(ref.abs().max()))
            assert float((got - ref).abs().max()) / scale <= 2e-5, name


@pytest.fixture
def bf16_control(monkeypatch):
    """A control for the bf16 grade's bars: every operator GEMM's result
    rounded to bf16."""
    bmm = tridiag._bmm

    def rounded(a, b):
        return bmm(a, b).to(torch.bfloat16).float()

    return lambda: monkeypatch.setattr(tridiag, "_bmm", rounded)


@pytest.mark.parametrize("mode", MODES)
def test_bf16_grade_matches_jax_bf16_grade(jax_flagship, batch, mode,
                                           restore_impls, _emulate_jax_bf16,
                                           bf16_control):
    """``enable_amp`` on each lockstep model against the JAX ``enable_amp``
    on the same mode: the hoisted lockstep's operators at bf16 (the first
    branch's ``operator_dtype``), the per-sweep lockstep's solves by a bf16
    operator built at each call (JAX: its global 'matinv_bf16').  Features
    and gradients of Σ f² within the bf16 bars, their distance from
    float32 no further than JAX's plus the bar; the control misses."""
    params, state, sd = jax_flagship
    x, _ = batch
    f32_ref, _ = _jax_extractor_grads(_jax_model(mode), params, state, x)
    jmodel = _jax_model(mode)
    assert jax_enable_amp(jmodel) == 3
    f_ref, g_ref = _jax_extractor_grads(jmodel, params, state, x)
    jax_tridiag.set_default_impl("auto")
    runs = []
    for control in (False, True):
        if control:
            bf16_control()
        model = _port(sd, mode)
        assert enable_amp(model) == 3
        assert model.feature_extractor.pde1.operator_dtype == torch.bfloat16
        runs.append(_extractor_grads(model, x))
    (f, g), (f_ctl, g_ctl) = runs
    assert f.dtype == np.float32
    assert _rel(f, f_ref) <= 4e-3
    assert _rel(f, f32_ref) <= _rel(f_ref, f32_ref) + 4e-3
    worst = max(_rel(g[n].numpy(), g_ref[n].numpy()) for n in g)
    assert worst <= 6e-3
    assert (_rel(f_ctl, f_ref) > 4e-3
            or max(_rel(g_ctl[n].numpy(), g_ref[n].numpy())
                   for n in g_ctl) > 6e-3)
    assert tridiag._DEFAULT_IMPL == "auto"  # enable_amp leaves it


@pytest.mark.parametrize("mode", MODES)
def test_lockstep_trainer_matches_sequential(jax_flagship, mode):
    """``Trainer.fit`` on the host loop (the preset's augmentation,
    dropout, clip and grouped AdamW; two epochs of two steps and their
    evals) of each lockstep model against the same run of the sequential
    model, at the Trainer tests' bars: each epoch's mean loss within 1e-4
    relative and every test accuracy equal."""
    _, _, sd = jax_flagship
    ds = synthetic_dataset("cifar10", train_per_class=3, test_per_class=2)
    values = PRESETS["cifar10_noconv"]["train"]
    runs = []
    for m in (mode, None):
        trainer = Trainer(_port(sd, m, dropout_rate=0.3),
                          TrainConfig.from_preset(
                              values, epochs=2, batch_size=8,
                              max_steps_per_epoch=2, seed=4,
                              log_every=10**9), values)
        runs.append(trainer.fit(trainer.init_state(2), ds, verbose=False))
    ours, ref = runs
    assert len(ours["history"]) == len(ref["history"]) == 2
    for a, b in zip(ours["history"], ref["history"]):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
        assert a["test_acc"] == b["test_acc"]
    assert ours["best_acc"] == ref["best_acc"]


def _count_solves(monkeypatch):
    """Count the K1 sites (each call of K1's op, ``thomas_solve_op``) and
    the K3 sites (each plain adjoint, K3's CPU path) that a run reaches."""
    calls = {"K1": 0, "K3": 0}
    solve, adjoint = tridiag.thomas_solve_op, tridiag.tridiag_adjoint_plain

    def counted_solve(*args, **kw):
        calls["K1"] += 1
        return solve(*args, **kw)

    def counted_adjoint(*args, **kw):
        calls["K3"] += 1
        return adjoint(*args, **kw)

    monkeypatch.setattr(tridiag, "thomas_solve_op", counted_solve)
    monkeypatch.setattr(tridiag, "tridiag_adjoint_plain", counted_adjoint)
    return calls


def test_solves_a_forward_and_backward(jax_flagship, monkeypatch):
    """The per-sweep lockstep makes 24 solves a forward and 24 adjoints a
    backward where the sequential branches make 51 each; the hoisted
    lockstep builds its operators by 2 solves and makes no adjoint."""
    _, _, sd = jax_flagship
    calls = _count_solves(monkeypatch)
    x = torch.rand(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    expect = {"fused": (24, 24), None: (51, 51), "hoisted": (2, 0)}
    for mode, (fwd, bwd) in expect.items():
        model = _port(sd, mode).train()
        calls.update(K1=0, K3=0)
        y = model(x)
        assert calls == {"K1": fwd, "K3": 0}, mode
        y.square().sum().backward()
        assert calls == {"K1": fwd, "K3": bwd}, mode


def test_mode_precedence_and_refusals(jax_flagship, monkeypatch):
    """The lockstep excludes the fused layer modes; ``lockstep_hoisted``
    takes precedence over ``fused`` (JAX's order), so a model with both
    builds operators and runs no per-sweep solve."""
    _, _, sd = jax_flagship
    for kw in ({"fused_pde": True}, {"fused_inference": True}):
        with pytest.raises(ValueError, match="excludes"):
            build_model("cifar10_noconv", device="cpu",
                        fused_multiscale=True, **kw)
    calls = _count_solves(monkeypatch)
    model = _port(sd, "fused")
    model.feature_extractor.lockstep_hoisted = True
    with torch.no_grad():
        model(torch.rand(2, 3, 32, 32))
    assert calls == {"K1": 2, "K3": 0}


@pytest.mark.parametrize("mode", MODES)
def test_lockstep_predict_and_device_epoch(jax_flagship, mode):
    """Each lockstep model through ``make_predict_fn`` (the eval forward's
    logits) and ``Trainer(device_epoch=True)`` (on the CPU the same step
    bodies without a graph: bit for bit the host loop's weights)."""
    _, _, sd = jax_flagship
    x = torch.rand(5, 3, 32, 32, generator=torch.Generator().manual_seed(2))
    model = _port(sd, mode)
    with torch.no_grad():
        want = model.eval()(x)
    assert torch.equal(make_predict_fn(model)(x), want)
    ds = synthetic_dataset("cifar10", train_per_class=2, test_per_class=1)
    values = PRESETS["cifar10_noconv"]["train"]
    weights = []
    for device_epoch in (False, True):
        model = _port(sd, mode, dropout_rate=0.3)
        trainer = Trainer(model, TrainConfig.from_preset(
            values, epochs=1, batch_size=8, max_steps_per_epoch=2, seed=1,
            device_epoch=device_epoch, log_every=10**9), values)
        state = trainer.init_state(2)
        trainer.train_epoch(state, ds, 0, verbose=False)
        weights.append(model.state_dict())
    for k, v in weights[0].items():
        assert torch.equal(v, weights[1][k]), k
