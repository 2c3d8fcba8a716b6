"""The AMP grade of the port against the JAX package on the CPU: the
inverse-operator solves (``tridiag_inverse_operator``,
``tridiag_solve_precomputed``, ``tridiag_solve_with_operator``,
``set_default_impl``), the hoisted branch of the three ADI layers in the
float32 and bf16 grades, ``enable_amp``, the serving operator cache, bf16
Adam moments and both CLIs' ``--amp``.  On the CPU the operators are built
by the plain Thomas recurrence and applied by float32 GEMMs (the bf16 grade
on bf16-rounded operands, ``gemm_route``).

The JAX bf16 grade's bf16 × bf16 → float32 product does not run on the
CPU, so it is run as the JAX package's own test runs it there: its apply
with both operands rounded to bf16 and multiplied in float32
(``_emulate_jax_bf16``), which is the same product.

Tolerances: 5e-6 of the largest entry on solves and their gradients (the
JAX tests' bar); hoisted layers within 1e-5 on outputs and 2e-5 of
max(1, largest entry) on gradients, against the JAX hoisted layer and the
port's per-sweep layer (the JAX test's bar); the bf16 grade within 4e-3
(outputs) and 6e-3 (gradients) of the largest entry against the JAX bf16
grade, where one bf16 rounding that falls the other way moves an element
by one bf16 step; against float32 the bf16 grade is held no further than
the JAX bf16 grade is, plus that step; bf16 moments within 2e-4 of float32
AdamW over 10 updates (the JAX test's bar).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cnn_pde_tpu.ops.tridiag as jax_tridiag
from cnn_pde_tpu.nn import Ctx
from cnn_pde_tpu.pde import ChannelCoupledDiffusion as JaxCoupled
from cnn_pde_tpu.pde import GrayscaleDiffusion as JaxGrayscale
from cnn_pde_tpu.pde import MixedChannelDiffusion as JaxMixed
import cnn_pde_tpu_torch.data as port_data
from cnn_pde_tpu_torch.layers import Conv2d
from cnn_pde_tpu_torch.models import build_model
from cnn_pde_tpu_torch.ops import tridiag
from cnn_pde_tpu_torch.ops.adi import apply_sweep, sweep_operator
from cnn_pde_tpu_torch.pde import (ChannelCoupledDiffusion, GrayscaleDiffusion,
                                   MixedChannelDiffusion, enable_amp,
                                   iter_adi_layers)
from cnn_pde_tpu_torch.serve import (cache_hoisted_operators,
                                     clear_operator_cache, make_predict_fn)
from cnn_pde_tpu_torch.serve_cli import main as serve_main
from cnn_pde_tpu_torch.train import build_optimizer
from cnn_pde_tpu_torch.train.__main__ import main as train_main
from cnn_pde_tpu_torch.train.optim import (OptaxAdamW, ParamGroup,
                                           set_learning_rates)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six test
    files at once on one host, and eight threads each oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


PRESETS = ["cifar10_noconv", "mnist", "fashion_mnist", "svhn"]
# (JAX class, port class, keywords, input shape): the JAX test's cases
LAYERS = {
    "grayscale": (JaxGrayscale, GrayscaleDiffusion,
                  dict(size=12, num_steps=4), (3, 1, 12, 12)),
    "coupled": (JaxCoupled, ChannelCoupledDiffusion,
                dict(size=10, num_steps=3), (3, 3, 10, 10)),
    "mixed_strang": (JaxMixed, MixedChannelDiffusion,
                     dict(size=10, num_steps=3, splitting="strang"),
                     (3, 3, 10, 10)),
    "mixed_lie": (JaxMixed, MixedChannelDiffusion,
                  dict(size=10, num_steps=3, splitting="lie"),
                  (3, 3, 10, 10)),
}


def _rel(x, y):
    """max |x − y| over the largest |y|."""
    x, y = (np.asarray(t, np.float64) for t in (x, y))
    return float(np.max(np.abs(x - y)) / max(np.max(np.abs(y)), 1e-30))


def _bands(rng, rows=5, n=16):
    r = rng.random((rows, n)).astype(np.float32) * 0.5
    return -r, 1 + 2 * r, -r


@pytest.fixture
def restore_impls():
    """Both packages' global solver default, restored after the test."""
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


def test_inverse_operator_matches_jax():
    a, b, c = _bands(np.random.default_rng(0))
    ref = np.asarray(jax_tridiag.tridiag_inverse_operator(a, b, c))
    X = tridiag.tridiag_inverse_operator(*map(torch.from_numpy, (a, b, c)))
    assert X.shape == ref.shape == (5, 16, 16) and X.dtype == torch.float32
    assert _rel(X, ref) <= 5e-6
    half = tridiag.tridiag_inverse_operator(
        *map(torch.from_numpy, (a, b, c)), dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16
    assert torch.equal(half, X.to(torch.bfloat16))


@pytest.mark.parametrize("form", ["precomputed", "with_operator"])
def test_operator_solve_matches_jax(form):
    """Forward and the a, b, c, d gradients of the loss Σx² against the
    JAX function's and the JAX exact solve's; X gets no gradient."""
    rng = np.random.default_rng(1)
    a, b, c = _bands(rng)
    d = rng.standard_normal((4, 5, 16)).astype(np.float32)
    jax_fn = getattr(jax_tridiag, f"tridiag_solve_{form}")
    port_fn = getattr(tridiag, f"tridiag_solve_{form}")
    X_ref = jax_tridiag.tridiag_inverse_operator(a, b, c)
    x_ref, g_ref = jax.jit(jax.value_and_grad(
        lambda *args: jnp.sum(jax_fn(*args, X_ref) ** 2),
        argnums=(0, 1, 2, 3)))(a, b, c, d)
    x_exact = jax_tridiag.tridiag_solve(a, b, c, d)

    args = [torch.tensor(v, requires_grad=True) for v in (a, b, c, d)]
    X = tridiag.tridiag_inverse_operator(*args[:3]).requires_grad_()
    x = port_fn(*args, X)
    (x ** 2).sum().backward()
    assert _rel(x.detach(), x_exact) <= 5e-6
    assert abs(float((x.detach().double() ** 2).sum()) - float(x_ref)) \
        <= 5e-6 * float(x_ref)
    for t, ref in zip(args, g_ref):
        assert _rel(t.grad, ref) <= 5e-6
    assert X.grad is None or not X.grad.any()


def test_precomputed_gives_x_a_zero_gradient():
    a, b, c = map(torch.from_numpy, _bands(np.random.default_rng(2)))
    X = tridiag.tridiag_inverse_operator(a, b, c).requires_grad_()
    d = torch.randn(3, 5, 16)
    tridiag.tridiag_solve_precomputed(a, b, c, d, X).sum().backward()
    assert X.grad is not None and torch.equal(X.grad, torch.zeros_like(X))


def test_set_default_impl(restore_impls):
    """'matinv' sends tridiag_solve (either axis) through an operator built
    at the call and matches 'auto'; 'matinv_bf16' stays within the JAX
    test's bar (0.02 of the largest entry); the JAX package's other impls
    ('scan', 'pcr', 'pcr2', 'pallas') are taken and match 'auto' at the
    exact bar; an unknown name raises."""
    rng = np.random.default_rng(3)
    a, b, c = (torch.from_numpy(t) for t in _bands(rng, 6, 12))
    d = torch.from_numpy(rng.standard_normal((4, 6, 12)).astype(np.float32))
    for dim in (-1, -2):
        exact = tridiag.tridiag_solve(a, b, c, d, dim)
        assert tridiag.set_default_impl("matinv") == "auto"
        assert _rel(tridiag.tridiag_solve(a, b, c, d, dim), exact) <= 5e-6
        assert tridiag.set_default_impl("matinv_bf16") == "matinv"
        assert _rel(tridiag.tridiag_solve(a, b, c, d, dim), exact) <= 0.02
        tridiag.set_default_impl("auto")
    for dim in (-1, -2):
        exact = tridiag.tridiag_solve(a, b, c, d, dim)
        for impl in ("scan", "pcr", "pcr2", "pallas"):
            assert tridiag.set_default_impl(impl) == "auto"
            assert _rel(tridiag.tridiag_solve(a, b, c, d, dim), exact) <= 5e-6
            assert tridiag.set_default_impl("auto") == impl
    with pytest.raises(ValueError):
        tridiag.set_default_impl("nope")
    assert tridiag._DEFAULT_IMPL == "auto"


def test_matinv_bf16_matches_jax(restore_impls, _emulate_jax_bf16):
    """The per-call bf16 impl against JAX's (bf16 rounding emulated), its
    value and gradients; and its solve against the exact one within the
    JAX test's bar."""
    rng = np.random.default_rng(4)
    N = 32
    b = 2.0 + rng.random((8, N)).astype(np.float32)
    a = -rng.random((8, N)).astype(np.float32) * 0.5
    c = -rng.random((8, N)).astype(np.float32) * 0.5
    d = rng.random((64, 8, N)).astype(np.float32)
    exact = np.asarray(jax_tridiag.tridiag_solve(a, b, c, d))
    jax_tridiag.set_default_impl("matinv_bf16")
    g_ref = jax.jit(jax.grad(
        lambda *t: jnp.sum(jax_tridiag.tridiag_solve(*t) ** 2),
        argnums=(0, 1, 2, 3)))(a, b, c, d)
    ref = np.asarray(jax.jit(jax_tridiag.tridiag_solve)(a, b, c, d))
    tridiag.set_default_impl("matinv_bf16")
    args = [torch.tensor(v, requires_grad=True) for v in (a, b, c, d)]
    x = tridiag.tridiag_solve(*args)
    (x ** 2).sum().backward()
    assert x.dtype == torch.float32
    assert _rel(x.detach(), ref) <= 4e-3
    assert _rel(x.detach(), exact) <= 0.02
    for t, g in zip(args, g_ref):
        assert _rel(t.grad, g) <= 6e-3


def _jax_params(JaxLayer, kw, seed=0):
    """The JAX layer's init with every leaf moved by 0.01·N(0, 1), as the
    JAX test does, as float32 numpy arrays."""
    params, _ = JaxLayer(**kw).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 10)
    return {k: (np.asarray(v) + 0.01 * rng.standard_normal(np.shape(v)))
            .astype(np.float32) for k, v in params.items()}


def _jax_run(layer, params, u):
    """Output and gradients of Σy² of a JAX layer in training mode."""
    def loss(p):
        y, _ = layer.apply(p, {}, jnp.asarray(u), Ctx(train=True))
        return jnp.sum(y ** 2), y

    (_, y), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return np.asarray(y), {k: np.asarray(g) for k, g in grads.items()}


def _port_run(layer, params, u):
    layer.load_state_dict({k: torch.tensor(v) for k, v in params.items()})
    layer.train()
    y = layer(torch.from_numpy(u))
    (y ** 2).sum().backward()
    return y.detach().numpy(), {n: p.grad.numpy()
                                for n, p in layer.named_parameters()}


def _grads_close(got, ref, tol):
    assert set(got) == set(ref)
    for name, g in ref.items():
        scale = max(1.0, float(np.max(np.abs(g))))
        assert float(np.max(np.abs(got[name] - g))) / scale <= tol, name


@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("case", list(LAYERS))
def test_hoisted_layer_matches_jax_and_per_sweep(case, refine):
    JaxLayer, Layer, kw, shape = LAYERS[case]
    params = _jax_params(JaxLayer, kw)
    u = np.random.default_rng(5).random(shape).astype(np.float32)
    y_ref, g_ref = _jax_run(JaxLayer(hoisted=True, hoisted_refine=refine,
                                     **kw), params, u)
    y, g = _port_run(Layer(hoisted=True, hoisted_refine=refine, **kw),
                     params, u)
    y_sweep, g_sweep = _port_run(Layer(**kw), params, u)
    assert np.max(np.abs(y - y_ref)) <= 1e-5
    assert np.max(np.abs(y - y_sweep)) <= 1e-5
    _grads_close(g, g_ref, 2e-5)
    _grads_close(g, g_sweep, 2e-5)


@pytest.mark.parametrize("case", list(LAYERS))
def test_bf16_grade_matches_jax_bf16_grade(case, _emulate_jax_bf16):
    """The bf16 hoisted layer against the JAX bf16 hoisted layer, and its
    distance from the float32 layer against the JAX grade's own."""
    JaxLayer, Layer, kw, shape = LAYERS[case]
    params = _jax_params(JaxLayer, kw, seed=1)
    u = np.random.default_rng(6).random(shape).astype(np.float32)
    y_ref, g_ref = _jax_run(JaxLayer(hoisted=True,
                                     operator_dtype=jnp.bfloat16, **kw),
                            params, u)
    y_f32, g_f32 = _jax_run(JaxLayer(**kw), params, u)
    y, g = _port_run(Layer(hoisted=True, operator_dtype=torch.bfloat16,
                           **kw), params, u)
    assert y.dtype == np.float32
    assert _rel(y, y_ref) <= 4e-3
    assert _rel(y, y_f32) <= _rel(y_ref, y_f32) + 4e-3
    for name, ref in g_ref.items():
        assert _rel(g[name], ref) <= 6e-3, name
        assert _rel(g[name], g_f32[name]) \
            <= _rel(ref, g_f32[name]) + 6e-3, name


def test_bf16_sweep_against_float32():
    """One bf16 sweep (a solve) against the float32 one, within 4e-3 of
    the largest entry, the JAX record's figure for one solve (bf16 rounds
    X and the state once each, by at most 2⁻⁸ of the value)."""
    rng = np.random.default_rng(7)
    field = torch.from_numpy((1.0 + 0.5 * rng.standard_normal((3, 12, 12)))
                             .astype(np.float32)).clamp_min(1e-6)
    u = torch.from_numpy(rng.random((5, 3, 12, 12)).astype(np.float32))
    out = {dtype: apply_sweep(sweep_operator(field, 0.0005, 1.0, eps=1e-6,
                                             dtype=dtype), u)
           for dtype in (torch.float32, torch.bfloat16)}
    assert out[torch.bfloat16].dtype == torch.float32
    assert _rel(out[torch.bfloat16], out[torch.float32]) <= 4e-3


def test_bf16_sweep_output_is_not_rounded_to_bf16():
    """The bf16 grade rounds its operands, not its GEMM's output: a
    sweep's result is the float32 sum of exact products, equal to the
    product of the bf16-rounded operands in float64 to float32 rounding,
    and most of its elements lie between bf16 values (a GEMM returning
    bf16 would put every element on one)."""
    rng = np.random.default_rng(9)
    field = torch.from_numpy((1.0 + 0.5 * rng.standard_normal((2, 12, 12)))
                             .astype(np.float32)).clamp_min(1e-6)
    u = torch.from_numpy(rng.random((4, 2, 12, 12)).astype(np.float32))
    op = sweep_operator(field, 0.0005, 1.0, eps=1e-6, dtype=torch.bfloat16)
    out = apply_sweep(op, u)
    want = torch.einsum("bcrk,crki->bcri",
                        u.bfloat16().double(), op[3].double())
    assert out.dtype == torch.float32
    assert _rel(out, want) <= 1e-6
    off_grid = (out != out.bfloat16().float()).float().mean()
    assert off_grid >= 0.9


def test_enable_amp_wiring():
    flagship = build_model("cifar10_noconv", device="cpu")
    n = enable_amp(flagship)
    assert n == len(list(iter_adi_layers(flagship))) == 3
    for layer in iter_adi_layers(flagship):
        assert layer.hoisted and layer.operator_dtype == torch.bfloat16
        assert not layer.hoisted_refine
    # the global solver default stays: per-sweep layers keep K1
    assert tridiag._DEFAULT_IMPL == "auto"
    # plain Linears stay float32
    linears = [m for m in flagship.modules()
               if isinstance(m, torch.nn.Linear)]
    assert linears and all(m.weight.dtype == torch.float32 for m in linears)
    for preset in ("mnist", "fashion_mnist", "svhn"):
        assert enable_amp(build_model(preset, device="cpu")) == 1
    # no model: no layer is found, nothing changes
    assert enable_amp() == 0 and tridiag._DEFAULT_IMPL == "auto"
    # the dense half: the port's Conv2d is cast to bf16 operands; a
    # foreign nn.Conv2d raises and nothing changes; dense=False casts none
    model = torch.nn.Sequential(Conv2d(1, 1, 3), GrayscaleDiffusion(size=8))
    assert enable_amp(model) == 1
    assert model[0].compute_dtype == torch.bfloat16 and model[1].hoisted
    model = torch.nn.Sequential(torch.nn.Conv2d(1, 1, 3), Conv2d(1, 1, 3),
                                GrayscaleDiffusion(size=8))
    with pytest.raises(TypeError, match="only the port's Conv2d"):
        enable_amp(model)
    assert not model[2].hoisted and model[1].compute_dtype is None
    assert enable_amp(model, dense=False) == 1
    assert model[1].compute_dtype is None
    # a per-sweep model beside an AMP one still solves by K1's route
    per_sweep = GrayscaleDiffusion(size=8, num_steps=2)
    u = torch.rand(2, 1, 8, 8)
    want = per_sweep(u)
    enable_amp(build_model("mnist", device="cpu"))
    assert torch.equal(per_sweep(u), want)


def test_operator_cache():
    """Pinned operators give the same logits as building them in the
    forward; training with them pinned raises until they are cleared; a
    layer whose eval runs fused is not cached."""
    torch.manual_seed(0)
    model = build_model("mnist", device="cpu",
                        generator=torch.Generator().manual_seed(0))
    enable_amp(model)
    x = torch.rand(4, 1, 28, 28)
    predict = make_predict_fn(model)
    fresh = predict(x)
    assert cache_hoisted_operators(model) == 1
    assert model.diff.operator_cache is not None
    assert torch.equal(predict(x), fresh)
    model.train()
    with pytest.raises(ValueError, match="clear_operator_cache"):
        model(x)
    assert clear_operator_cache(model) == 1
    assert clear_operator_cache(model) == 0
    model(x).sum().backward()
    assert model.diff.alpha_base.grad is not None
    fused = build_model("mnist", device="cpu", fused_inference=True)
    enable_amp(fused)
    assert cache_hoisted_operators(fused) == 0


def test_bf16_moments_track_f32_adamw():
    """OptaxAdamW with bf16 moments: m and v stored in bf16, parameters float32 and
    within 2e-4 of torch's float32 AdamW over 10 updates in two groups; and
    the update equals optax's chain (the JAX optimizer with bf16 moments)
    on the same gradients."""
    import optax

    from cnn_pde_tpu.train.optim import build_optimizer as jax_build

    rng = np.random.default_rng(8)
    init = {"alpha_base": rng.random((8, 8)).astype(np.float32),
            "w": rng.random((16, 4)).astype(np.float32)}

    def run(moment_dtype):
        model = torch.nn.Module()
        for k, v in init.items():
            model.register_parameter(k, torch.nn.Parameter(
                torch.from_numpy(v.copy())))
        opt = build_optimizer(model, groups=[ParamGroup(("alpha",), 1.0,
                                                        1e-6)],
                              default_weight_decay=1e-4,
                              default_lr_scale=0.5,
                              moment_dtype=moment_dtype)
        if moment_dtype is None:
            opt = torch.optim.AdamW(
                [{"params": g["params"], "lr_scale": g["lr_scale"],
                  "weight_decay": g["weight_decay"]}
                 for g in opt.param_groups], lr=0.0)
        for i in range(10):
            set_learning_rates(opt, 1e-3)
            for p in model.parameters():
                p.grad = 0.01 * torch.cos(p.detach() + i)
            opt.step()
        return model, opt

    lo, opt = run(torch.bfloat16)
    hi, _ = run(None)
    assert isinstance(opt, OptaxAdamW)
    for p in lo.parameters():
        state = opt.state[p]
        assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype \
            == torch.bfloat16
    for (name, p), q in zip(lo.named_parameters(), hi.parameters()):
        assert p.dtype == torch.float32
        assert float((p - q).detach().abs().max()) <= 2e-4, name

    jopt = jax_build(init, lambda s: 1e-3,
                     groups=(ParamGroup(("alpha",), 1.0, 1e-6),),
                     default_weight_decay=1e-4, default_lr_scale=0.5,
                     clip_norm=None, moment_dtype=jnp.bfloat16)
    params, state = init, jopt.init(init)
    for i in range(10):
        grads = jax.tree_util.tree_map(lambda x: 0.01 * jnp.cos(x + i),
                                       params)
        updates, state = jopt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    for name, p in lo.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), params[name],
                                   rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("preset", PRESETS)
def test_serve_cli_amp(preset, capsys):
    serve_main(["--preset", preset, "--device", "cpu", "--batch-size", "2",
                "--amp"])
    out = capsys.readouterr()
    summary = json.loads(out.out.strip().splitlines()[-1])
    assert summary["amp_cached_layers"] == (3 if preset == "cifar10_noconv"
                                            else 1)
    assert len(summary["predictions"]) == 2
    assert "bf16_rounded_f32" in out.err


@pytest.mark.parametrize("preset", PRESETS)
def test_train_cli_amp_bf16_moments(preset, capsys, monkeypatch):
    # the CLI trains one epoch and then evaluates the test split: a small
    # synthetic set keeps that evaluation short
    monkeypatch.setattr(port_data, "synthetic_dataset", functools.partial(
        port_data.synthetic_dataset, train_per_class=4, test_per_class=1))
    train_main(["--preset", preset, "--synthetic", "--epochs", "1",
                "--steps", "1", "--batch-size", "4", "--device", "cpu", "--amp",
                "--bf16-moments"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["amp_layers"] == (3 if preset == "cifar10_noconv" else 1)
    assert summary["gemm_route"] == "bf16_rounded_f32"
    assert summary["bf16_moments"] is True
    assert np.isfinite(summary["last_loss"])


def test_clis_refuse_the_cpu_without_device_flag():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    for main, args in ((serve_main, ["--batch-size", "1"]),
                       (train_main, ["--synthetic", "--steps", "1",
                                     "--bf16-moments"])):
        with pytest.raises(SystemExit, match="--device cpu"):
            main(["--preset", "svhn", "--amp", *args])
