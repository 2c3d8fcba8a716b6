"""The CIFAR-10 hybrid family in the port against the JAX package on the
CPU: SymmetricLayer, ParabolicBlock and HamiltonianBlock in both grades
(float32, and bf16 operands with float32 results), NonConvSpatialAttention,
the hybrid regulariser term by term and the preset's param groups, the
whole model from ``state_dict_from_jax`` in both grades, the preset and
one train step of it with the regulariser, and both CLIs with
``--preset cifar10_hybrid``.

Tolerances: the blocks at (2, 4, 4), outputs, gradients and BatchNorm
statistics after a train forward, within 1e-5 of max(1, largest entry) in
both grades (the port rounds where the JAX bf16 grade rounds: its K
products' operands, and the cotangents of the bf16 operands, which JAX's
transpose rule for ``dot_general(..., preferred_element_type=float32)``
forms as float32 products rounded to bf16 and sums over a call's two uses
of the cast K in bf16); the attention gate 1e-5; each regulariser term
1e-5 relative (float32 sums of up to 3,072 squares in another order);
the model's exact grade: logits 1e-4 in train and eval mode, every
gradient within 1e-4 of its largest entry, BatchNorm statistics 1e-5;
its bf16 grade: eval logits 4e-3 of the largest entry against the JAX
bf16 grade, train-mode logits 1e-2 (which runs of the port that differ
only in the order of float32 sums need, and a control whose products
return bf16 misses), and each
SymmetricLayer call of the JAX bf16 train step, replayed on the input
and output cotangent that step gave it, within one bf16 step (2⁻⁸ of its
largest entry) on its output and every gradient; the train step: loss
1e-4 relative and gradients 1e-4 of their largest entry against JAX's,
AdamW's first step 1e-6 where |g| > 1e-6.

The model runs at B = 8: at B = 4 train-mode BatchNorm over four values a
feature puts the JAX model's own float32 gradients 1.5e-4 to 5e-4 of
their largest entry from its float64 ones (the port's 2e-5 to 1.2e-4);
at B = 8 the two are within 4.5e-5 of each other.

The JAX bf16 grade is compiled with XLA's ``xla_allow_excess_precision``
off, as in test_torch_port_tiny.py: with it on, XLA's CPU compiler may
skip a bf16 rounding inside one jit.  Inputs hold no near tie in any 8 × 8
max-pool window (top-2 gap over 1e-4).
"""

import copy
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_pde_tpu.models.attention import \
    NonConvSpatialAttention as JaxAttention
from cnn_pde_tpu.models.cifar10_hybrid import \
    CIFAR10HybridPDEModel as JaxHybrid
from cnn_pde_tpu.nn import Ctx
from cnn_pde_tpu.pde.ruthotto import HamiltonianBlock as JaxHamiltonian
from cnn_pde_tpu.pde.ruthotto import ParabolicBlock as JaxParabolic
from cnn_pde_tpu.pde.ruthotto import SymmetricLayer as JaxSymmetric
from cnn_pde_tpu.train.losses import cross_entropy as jax_cross_entropy
from cnn_pde_tpu.train.losses import \
    hybrid_pde_regularization as jax_regularization
from cnn_pde_tpu.train.optim import _group_labels
from cnn_pde_tpu.utils.config import get_preset as jax_preset
import cnn_pde_tpu_torch.data as port_data
from cnn_pde_tpu_torch.compat import _flatten, _torch_key, state_dict_from_jax
from cnn_pde_tpu_torch.models import CIFAR10HybridPDEModel, build_model
from cnn_pde_tpu_torch.models.attention import NonConvSpatialAttention
from cnn_pde_tpu_torch.pde import ruthotto
from cnn_pde_tpu_torch.pde import (HamiltonianBlock, ParabolicBlock,
                                   SymmetricLayer, enable_amp)
from cnn_pde_tpu_torch.presets import PRESETS, get_preset
from cnn_pde_tpu_torch.serve_cli import main as serve_main
from cnn_pde_tpu_torch.train import hybrid_pde_regularization
from cnn_pde_tpu_torch.train.__main__ import main as train_main
from cnn_pde_tpu_torch.train.optim import ParamGroup, group_labels
from cnn_pde_tpu_torch.train.step import make_train_step


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six test
    files at once on one host, and eight threads each oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


PRESET = "cifar10_hybrid"
NO_EXCESS = {"xla_allow_excess_precision": False}
GRADES = {"float32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# biases that feed a train-mode BatchNorm, and the feature BN's bias (its
# gradient sums to zero over the batch through the BN1d head): zero in
# exact arithmetic, so held in absolute terms
ZERO_IN_EXACT_ARITHMETIC = {f"classifier.classifier.{i}.bias"
                            for i in (0, 4, 8, 12)} | {"feature_bn.bias"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _scaled_err(port, ref):
    """max |port − ref| over max(1, largest |ref|)."""
    ref = np.asarray(ref, np.float64)
    port = np.asarray(torch.as_tensor(port).detach(), np.float64)
    return float(np.max(np.abs(port - ref)) / max(1.0, np.max(np.abs(ref))))


def _rel(port, ref):
    """max |port − ref| over the largest |ref|."""
    ref = np.asarray(ref, np.float64)
    port = np.asarray(torch.as_tensor(port).detach(), np.float64)
    return float(np.max(np.abs(port - ref)) / np.max(np.abs(ref)))


def _bf16_steps(port, ref):
    """max |port − ref| in bf16 steps (2⁻⁸ relative) of the larger of the
    two largest magnitudes."""
    ref = np.asarray(ref, np.float64)
    port = np.asarray(torch.as_tensor(port).detach().float(), np.float64)
    m = max(np.max(np.abs(ref)), np.max(np.abs(port)))
    return float(np.max(np.abs(port - ref)) / np.ldexp(1.0, np.frexp(m)[1]
                                                       - 8))


def _perturb(rng, tree, scale):
    return jax.tree_util.tree_map(
        lambda v: (v + scale * rng.standard_normal(v.shape)).astype(v.dtype),
        tree)


def _symmetric_params(rng, p, s, k_scale=0.05):
    """A SymmetricLayer's JAX params and state moved off their init: K by
    ``k_scale``·N(0, 1), the norm's affine parameters and statistics by
    0.1·N(0, 1)."""
    d = p["K"]["w"].shape[0]
    p = {"K": {"w": (p["K"]["w"] + k_scale * rng.standard_normal((d, d))
                     ).astype(np.float32)},
         "norm": {"scale": (1 + 0.1 * rng.standard_normal(d)
                            ).astype(np.float32),
                  "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)}}
    s = {"norm": {"mean": (0.1 * rng.standard_normal(d)).astype(np.float32),
                  "var": (1 + 0.1 * np.abs(rng.standard_normal(d))
                          ).astype(np.float32)}}
    return p, s


def _symmetric_sd(p, s, prefix=""):
    """A SymmetricLayer's port state_dict from its JAX params and state."""
    return {f"{prefix}K.weight": torch.tensor(p["K"]["w"].T.copy()),
            f"{prefix}norm.weight": torch.tensor(p["norm"]["scale"]),
            f"{prefix}norm.bias": torch.tensor(p["norm"]["bias"]),
            f"{prefix}norm.running_mean": torch.tensor(s["norm"]["mean"]),
            f"{prefix}norm.running_var": torch.tensor(s["norm"]["var"]),
            f"{prefix}norm.num_batches_tracked": torch.tensor(0)}


BLOCKS = {
    # name: (JAX class, port class, {JAX layer key: port attribute})
    "symmetric": (JaxSymmetric, SymmetricLayer, {"": ""}),
    "parabolic": (JaxParabolic, ParabolicBlock, {"sym": "symmetric_layer"}),
    "hamiltonian": (JaxHamiltonian, HamiltonianBlock,
                    {"F_Y": "F_Y", "F_Z": "F_Z"}),
}


@pytest.mark.parametrize("grade", GRADES)
@pytest.mark.parametrize("block", BLOCKS)
def test_ruthotto_blocks_match_jax(block, grade):
    """A train-mode forward at (2, 4, 4) on a batch of 3 (3 steps at dt
    0.5 for the blocks): the output, the gradients of ⟨out, r⟩ for the
    input and every parameter, and the BatchNorm statistics after the
    forward (updated once a call: 3 times in each block layer); the
    Hamiltonian block's first F_Y call normalises Z = 0, a batch of
    variance 0."""
    jax_cls, port_cls, layers = BLOCKS[block]
    jdt, tdt = GRADES[grade]
    C, S = 2, 4
    rng = np.random.default_rng(3)
    kw = {} if block == "symmetric" else {"num_steps": 3, "dt": 0.5}
    jm = jax_cls(C, S, compute_dtype=jdt, **kw)
    p, s = _np(jm.init(jax.random.PRNGKey(1)))
    sd = {}
    for key, attr in layers.items():
        lp, ls = (p, s) if key == "" else (p[key], s[key])
        lp, ls = _symmetric_params(rng, lp, ls)
        if key == "":
            p, s = lp, ls
        else:
            p[key], s[key] = lp, ls
        sd.update(_symmetric_sd(lp, ls, f"{attr}." if attr else ""))
    x = rng.standard_normal((3, C, S, S)).astype(np.float32)
    r = rng.standard_normal((3, C, S, S)).astype(np.float32)

    def loss(p, x):
        y, ns = jm.apply(p, s, x, Ctx(train=True))
        return jnp.sum(y * r), (y, ns)

    (_, (y_ref, ns)), (gp, gx) = _np(jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)).lower(p, x).compile(NO_EXCESS)(
            p, x))
    port = port_cls(C, S, compute_dtype=tdt, **kw).train()
    port.load_state_dict(sd, strict=True)
    xt = torch.tensor(x, requires_grad=True)
    out = port(xt)
    (out * torch.from_numpy(r)).sum().backward()
    assert out.dtype == torch.float32
    assert _scaled_err(out, y_ref) <= 1e-5
    assert _scaled_err(xt.grad, gx) <= 1e-5
    calls = 1 if block == "symmetric" else 3
    for key, attr in layers.items():
        layer = port if attr == "" else getattr(port, attr)
        lg, lns = (gp, ns) if key == "" else (gp[key], ns[key])
        assert _scaled_err(layer.K.weight.grad.T, lg["K"]["w"]) <= 1e-5, key
        assert _scaled_err(layer.norm.weight.grad,
                           lg["norm"]["scale"]) <= 1e-5, key
        assert _scaled_err(layer.norm.bias.grad, lg["norm"]["bias"]) <= 1e-5
        assert _scaled_err(layer.norm.running_mean,
                           lns["norm"]["mean"]) <= 1e-5, key
        assert _scaled_err(layer.norm.running_var,
                           lns["norm"]["var"]) <= 1e-5, key
        assert int(layer.norm.num_batches_tracked) == calls


def test_block_casts_k_once_a_forward(monkeypatch):
    """The bf16 grade casts each layer's K once a block forward (XLA's
    CSE), not once a call, and its products return float32."""
    casts = []
    orig = SymmetricLayer.operand

    def counted(self):
        w = orig(self)
        casts.append(None if w is None else w.dtype)
        return w

    monkeypatch.setattr(SymmetricLayer, "operand", counted)
    block = HamiltonianBlock(2, 4, num_steps=3,
                             compute_dtype=torch.bfloat16).train()
    out = block(torch.randn(3, 2, 4, 4))
    assert casts == [torch.bfloat16, torch.bfloat16]
    assert out.dtype == torch.float32
    casts.clear()
    ParabolicBlock(2, 4, num_steps=4).train()(torch.randn(3, 2, 4, 4))
    assert casts == [None]


def test_nonconv_attention_matches_jax():
    """The gate at (3, 8, 8) (192 → 48 → 24 → 192): output and the
    gradients of ⟨out, r⟩ within 1e-5 of max(1, largest entry)."""
    rng = np.random.default_rng(4)
    jm = JaxAttention(3, 8)
    p, s = _np(jm.init(jax.random.PRNGKey(2)))
    x = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    r = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)

    def loss(p, x):
        y, _ = jm.apply(p, s, x, Ctx(train=False))
        return jnp.sum(y * r), y

    (_, y_ref), (gp, gx) = _np(jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p, x))
    port = NonConvSpatialAttention(3, 8)
    port.load_state_dict({k[len("attention."):]: v for k, v in
                          state_dict_from_jax({"attention": p}, {}, PRESET)
                          .items()}, strict=True)
    xt = torch.tensor(x, requires_grad=True)
    out = port(xt)
    (out * torch.from_numpy(r)).sum().backward()
    assert _scaled_err(out, y_ref) <= 1e-5
    assert _scaled_err(xt.grad, gx) <= 1e-5
    ref = state_dict_from_jax({"attention": gp}, {}, PRESET)
    for name, q in port.named_parameters():
        assert _scaled_err(q.grad, ref[f"attention.{name}"]) <= 1e-5, name


@pytest.fixture(scope="module")
def jax_hybrid():
    """The JAX hybrid (exact grade, dropout 0) with its diffusion fields,
    K matrices, combination weights, pos-embed and every BatchNorm moved
    off their init by seeded draws, so that a wrong key, transpose or leaf
    shows."""
    rng = np.random.default_rng(5)
    model = JaxHybrid(dropout_rate=0.0, ruthotto_dtype=jnp.float32)
    params, state = _np(jax.jit(model.init)(jax.random.PRNGKey(0)))
    fe = params["feature_extractor"]
    for i in (1, 2):
        layer = fe[f"diffusion{i}"]
        shape = layer["alpha_base"].shape
        for key in ("alpha_base", "beta_base"):
            layer[key] = (1 + 0.3 * rng.standard_normal(shape)).astype(
                np.float32)
        for key in ("alpha_time_coeff", "beta_time_coeff"):
            layer[key] = (0.5 * rng.standard_normal(shape)).astype(
                np.float32)
        layer["channel_mixing"] = (np.eye(3) + 0.05 * rng.standard_normal(
            (3, 3))).astype(np.float32)
    for block, keys in (("parabolic", ("sym",)),
                        ("hamiltonian", ("F_Y", "F_Z"))):
        for key in keys:
            # K keeps its init, I + 0.01·N(0, 1): at D = 3072 that noise
            # is already of norm about 1
            (params["feature_extractor"][block][key],
             state["feature_extractor"][block][key]) = _symmetric_params(
                rng, params["feature_extractor"][block][key],
                state["feature_extractor"][block][key], k_scale=0.0)
    fe["combination_weights"] = np.array([0.1, 0.3, 0.2, 0.4], np.float32)
    for key in ("feature_bn", "classifier"):
        params[key] = _perturb(rng, params[key], 0.1)
        state[key] = jax.tree_util.tree_map(
            lambda v: (v + 0.1 * np.abs(rng.standard_normal(v.shape))
                       ).astype(v.dtype), state[key])
    fe["feature_norm"] = _perturb(rng, fe["feature_norm"], 0.1)
    return model, params, state


def _batch():
    """8 images whose pooled features hold no near tie (``_no_near_tie``:
    the first such draw of this generator, seed 14)."""
    rng = np.random.default_rng(14)
    return (rng.random((8, 3, 32, 32)).astype(np.float32),
            rng.integers(0, 10, 8).astype(np.int32))


def _port(params, state, dtype=torch.float32):
    port = build_model(PRESET, device="cpu", dropout_rate=0.0,
                       ruthotto_dtype=dtype)
    port.load_state_dict(state_dict_from_jax(params, state, PRESET),
                         strict=True)
    return port


def _jax_loss(model, p, s, x, y, regularized=False):
    logits, ns = model.apply(p, s, x, Ctx(train=True,
                                          rng=jax.random.PRNGKey(0)))
    loss = jax_cross_entropy(logits, y, 0.1)
    if regularized:
        loss = loss + jax_regularization(p, 2e-4, 1e-4, 1e-6)
    return loss, (logits, ns)


@pytest.fixture(scope="module")
def exact_run(jax_hybrid):
    """The JAX exact grade's eval logits and, in train mode, its logits,
    regularised loss, gradients and new BatchNorm state."""
    model, params, state = jax_hybrid
    x, y = _batch()

    def run(p, s):
        logits, _ = model.apply(p, s, x, Ctx(train=False))
        return logits, jax.value_and_grad(
            lambda p, s: _jax_loss(model, p, s, x, y, True),
            has_aux=True)(p, s)

    logits, ((loss, (train_logits, ns)), grads) = _np(jax.jit(run)(
        params, state))
    return (logits, float(loss), train_logits,
            state_dict_from_jax(grads, ns, PRESET),
            state_dict_from_jax(params, ns, PRESET))


def _no_near_tie(port, x):
    """Every 4 × 4 max-pool window's top two of the pooled features stand
    more than 1e-4 apart (train and eval mode), on a copy of ``port`` (a
    train forward moves the BatchNorm statistics)."""
    for train in (True, False):
        model = copy.deepcopy(port).train(train)
        with torch.no_grad():
            f = model.feature_bn(model.attention(model.feature_extractor(
                torch.from_numpy(x))))
        windows = f.unfold(2, 4, 4).unfold(3, 4, 4).reshape(
            *f.shape[:2], 8, 8, 16)
        top2 = windows.topk(2, dim=-1).values
        assert float((top2[..., 0] - top2[..., 1]).min()) > 1e-4


def _train_loss(port, x, y):
    out = port.train()(torch.from_numpy(x).to(next(port.parameters()).dtype))
    loss = (torch.nn.functional.cross_entropy(
        out, torch.from_numpy(y).long(), label_smoothing=0.1)
        + hybrid_pde_regularization(port, 2e-4, 1e-4, 1e-6))
    loss.backward()
    return out, loss


def test_hybrid_exact_grade_matches_jax(jax_hybrid, exact_run):
    """Eval and train logits 1e-4, every gradient (cross-entropy plus the
    regulariser) within 1e-4 of its largest entry, the BatchNorm
    statistics 1e-5 and each block layer's count of updates (4, 3, 3)."""
    _, params, state = jax_hybrid
    logits, loss_ref, train_logits, grads, post = exact_run
    x, y = _batch()
    port = _port(params, state)
    _no_near_tie(port, x)
    with torch.no_grad():
        assert _scaled_err(port(torch.from_numpy(x)), logits) <= 1e-4
    out, loss = _train_loss(port, x, y)
    assert _scaled_err(out, train_logits) <= 1e-4
    assert abs(loss.item() - loss_ref) <= 1e-4 * abs(loss_ref)
    scale = max(float(g.abs().max()) for g in grads.values())
    for name, p in port.named_parameters():
        g = grads[name].numpy()
        if name in ZERO_IN_EXACT_ARITHMETIC:
            assert float(p.grad.abs().max()) <= 1e-4 * scale, name
        else:
            assert _rel(p.grad, g) <= 1e-4, name
    fe = port.feature_extractor
    for norm, n in ((fe.parabolic.symmetric_layer.norm, 4),
                    (fe.hamiltonian.F_Y.norm, 3), (fe.hamiltonian.F_Z.norm, 3),
                    (fe.feature_norm, 1), (port.feature_bn, 1)):
        assert int(norm.num_batches_tracked) == n
    for name, buf in port.named_buffers():
        if "running" in name:
            assert _scaled_err(buf, post[name]) <= 1e-5, name


@pytest.fixture(scope="module")
def bf16_run(jax_hybrid):
    """The JAX bf16 grade (the model's default), compiled without excess
    precision: eval and train logits, and for each SymmetricLayer call of
    the train step its input and output cotangent."""
    _, params, state = jax_hybrid
    model = JaxHybrid(dropout_rate=0.0)
    x, y = _batch()
    fe = model.feature_extractor
    layers = {"parabolic.symmetric_layer": fe.parabolic.sym,
              "hamiltonian.F_Y": fe.hamiltonian.F_Y,
              "hamiltonian.F_Z": fe.hamiltonian.F_Z}
    seen, taps = {}, {}

    def tapped(name, apply):
        def run(p, s, Y, ctx):
            out, ns = apply(p, s, Y, ctx)
            if ctx.train:
                key = f"{name}.{sum(k.startswith(name) for k in seen)}"
                out = out + taps[key] if key in taps else out
                seen[key] = Y
            return out, ns
        return run

    for name, layer in layers.items():
        layer.apply = tapped(name, layer.apply)
    jax.eval_shape(lambda p, s: _jax_loss(model, p, s, x, y), params, state)
    zeros = {k: jnp.zeros(v.shape, v.dtype) for k, v in seen.items()}

    def loss_fn(p, s, z):
        seen.clear()
        taps.clear()
        taps.update(z)
        loss, (logits, _) = _jax_loss(model, p, s, x, y)
        return loss, (logits, dict(seen))

    def run(p, s):
        logits, _ = model.apply(p, s, x, Ctx(train=False))
        return logits, jax.value_and_grad(loss_fn, argnums=2,
                                          has_aux=True)(p, s, zeros)

    logits, ((_, (train_logits, inputs)), cotangents) = _np(
        jax.jit(run).lower(params, state).compile(NO_EXCESS)(params, state))
    calls = {k: (inputs[k], cotangents[k]) for k in inputs}
    return logits, train_logits, calls, layers


def _pieces(product, parts):
    """``product`` with its float32 sum in another order: the contraction
    cut into ``parts`` pieces, summed apart and then added."""
    def split(a, b):
        n = a.shape[-1]
        edges = [round(i * n / parts) for i in range(parts + 1)]
        out = product(a[..., :edges[1]], b[:edges[1]])
        for lo, hi in zip(edges[1:-1], edges[2:]):
            out = out + product(a[..., lo:hi], b[lo:hi])
        return out
    return split


def test_hybrid_bf16_grade_matches_jax(jax_hybrid, bf16_run, monkeypatch):
    """The default grade against the JAX bf16 grade: eval logits within
    4e-3 of their largest entry (1.8e-3 on a CPU); train-mode logits within
    1e-2 (6.5e-3 on a CPU, against the JAX grade's own 2.6e-2 from its
    exact grade).  4e-3 is below what the grade determines in train mode:
    two float32 products that sum 3,072 terms in another order put a value
    near a bf16 midpoint on the other side now and then, and train-mode
    BatchNorm over 8 images a feature magnifies that step.  The sound runs
    show it: the port with every K product's float32 sum cut into 2, 4 or
    8 pieces (the same exact products) reads 4.4e-3, 6.8e-3 and 6.3e-3
    from the JAX grade, and 3.9e-3 to 4.8e-3 from the port's own run; each
    is held within 1e-2, and one must be over 4e-3.  A control whose K
    products return bf16 misses 1e-2 (3.3e-2).
    Each of the 10 SymmetricLayer calls of the train step (4 + 3 + 3),
    replayed on the input and output cotangent the JAX step gave it, on
    the JAX layer and on the port's, within one bf16 step on its output
    and the gradients of its input, K and norm."""
    _, params, state = jax_hybrid
    logits, train_logits, calls, layers = bf16_run
    x, _ = _batch()
    port = _port(params, state, torch.bfloat16)
    assert port.feature_extractor.parabolic.symmetric_layer.compute_dtype \
        == torch.bfloat16
    with torch.no_grad():
        assert _rel(port(torch.from_numpy(x)), logits) <= 4e-3
        assert _rel(port.train()(torch.from_numpy(x)), train_logits) <= 1e-2
        product = ruthotto._product
        sound = []
        for parts in (2, 4, 8):
            monkeypatch.setattr(ruthotto, "_product", _pieces(product, parts))
            sound.append(_rel(_port(params, state, torch.bfloat16).train()(
                torch.from_numpy(x)), train_logits))
            monkeypatch.undo()
        assert max(sound) <= 1e-2
        assert max(sound) > 4e-3
        monkeypatch.setattr(ruthotto, "_product", lambda a, b: product(
            a, b).to(torch.bfloat16).float())
        control = _port(params, state, torch.bfloat16).train()
        assert _rel(control(torch.from_numpy(x)), train_logits) > 1e-2
        monkeypatch.undo()
    assert sorted(calls) == sorted(
        [f"parabolic.symmetric_layer.{i}" for i in range(4)]
        + [f"hamiltonian.F_{f}.{i}" for f in "YZ" for i in range(3)])
    fe = port.feature_extractor
    jfe = jax_hybrid[1]["feature_extractor"]
    jfs = jax_hybrid[2]["feature_extractor"]
    replays = {}
    for key, (Y, g) in sorted(calls.items()):
        name = key.rsplit(".", 1)[0]
        block, attr = name.split(".")
        lp = jfe[block]["sym" if attr == "symmetric_layer" else attr]
        ls = jfs[block]["sym" if attr == "symmetric_layer" else attr]
        jl = layers[name]
        if name not in replays:
            replays[name] = jax.jit(lambda p, s, Y, g, jl=jl: jax.vjp(
                lambda p, Y: jl.apply(p, s, Y, Ctx(train=True))[0], p, Y)[1](
                    g) + (jl.apply(p, s, Y, Ctx(train=True))[0],)).lower(
                lp, ls, Y, g).compile(NO_EXCESS)
        gp, gY, out_ref = _np(replays[name](lp, ls, Y, g))
        layer = getattr(getattr(fe, block), attr)
        layer.zero_grad(set_to_none=True)
        Yt = torch.tensor(Y, requires_grad=True)
        out = layer(Yt)
        out.backward(torch.from_numpy(g))
        for label, got, ref in (
                ("output", out, out_ref), ("input gradient", Yt.grad, gY),
                ("K gradient", layer.K.weight.grad.T, gp["K"]["w"]),
                ("norm weight gradient", layer.norm.weight.grad,
                 gp["norm"]["scale"]),
                ("norm bias gradient", layer.norm.bias.grad,
                 gp["norm"]["bias"])):
            assert _bf16_steps(got, ref) <= 1.0, (key, label)


def test_regulariser_matches_jax_term_by_term(jax_hybrid):
    """Each parameter's own term (α3·Σp² on the α/β bases, α2·‖p − I‖² on
    the channel mixing, α2·Σp² on each K, α1·Σ|p| on the combination
    weights, nothing elsewhere) within 1e-5 relative of the JAX function on
    that parameter alone under its JAX path, and the sum over the model
    within 1e-5 relative."""
    _, params, state = jax_hybrid
    port = _port(params, state)
    alphas = (2e-4, 1e-4, 1e-6)
    named = dict(port.named_parameters())
    selected = set()
    for path, leaf in _flatten(params).items():
        name = _torch_key(path, is_state=False, preset=PRESET)
        tree = {}
        node = tree
        *heads, last = path.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(leaf)
        ref = float(jax_regularization(tree, *alphas))

        class One(torch.nn.Module):
            def named_parameters(self):
                return iter([(name, named[name])])

        with torch.no_grad():
            got = float(hybrid_pde_regularization(One(), *alphas))
        # float32 sums of up to 3,072 squares, in another order
        assert got == pytest.approx(ref, rel=1e-5, abs=0.0), name
        if ref:
            selected.add(name)
    assert selected == (
        {f"feature_extractor.diffusion{i}.{k}" for i in (1, 2)
         for k in ("alpha_base", "beta_base", "channel_mixing")}
        | {"feature_extractor.parabolic.symmetric_layer.K.weight",
           "feature_extractor.hamiltonian.F_Y.K.weight",
           "feature_extractor.hamiltonian.F_Z.K.weight",
           "feature_extractor.combination_weights"})
    total = float(jax_regularization(params, *alphas))
    with torch.no_grad():
        assert float(hybrid_pde_regularization(port, *alphas)) \
            == pytest.approx(total, rel=1e-5)


def test_hybrid_preset_and_param_groups_match_jax(jax_hybrid):
    """The preset's values, and its one group (α, β, channel mixing and
    the combination weights at lr with weight decay 1e-6) selecting the
    same tensors as the JAX path match."""
    ref = jax_preset(PRESET)
    train = get_preset(PRESET)["train"]
    defaults = {"eval_every": 1, "early_stop_patience": None}
    for key in ("epochs", "batch_size", "lr", "weight_decay", "schedule",
                "schedule_kwargs", "label_smoothing", "clip_norm",
                "default_lr_scale", "eval_every", "early_stop_patience"):
        assert train.get(key, defaults.get(key)) == getattr(ref, key), key
    assert train["regularizer"] == (2e-4, 1e-4, 1e-6)
    groups = [ParamGroup(*g) for g in train["param_groups"]]
    assert [(tuple(g.match_substrings), g.lr_scale, g.weight_decay)
            for g in groups] == [(tuple(g.match_substrings), g.lr_scale,
                                  g.weight_decay) for g in ref.param_groups]
    aug = ref.augment
    for key in ("crop_padding", "hflip", "rotation", "brightness",
                "contrast", "saturation", "hue", "erasing_p"):
        assert train["augment"][key] == getattr(aug, key), key
    assert tuple(train["augment"]["mean"]) == tuple(aug.mean)
    _, params, state = jax_hybrid
    port = _port(params, state)
    ours = group_labels(port, groups)
    theirs = {_torch_key(path, is_state=False, preset=PRESET): label
              for path, label in _flatten(
                  _group_labels(params, ref.param_groups)).items()}
    assert ours == theirs
    assert sum(label == "0" for label in ours.values()) == 11


def test_hybrid_train_step_matches_jax(jax_hybrid, exact_run):
    """One preset step (augmentation off, dropout 0, the regulariser in the
    loss before the backward) of the exact grade from the JAX weights: the
    loss within 1e-4 relative of JAX's regularised loss, every clipped
    gradient within 1e-4 of its largest entry of JAX's gradient clipped by
    its global norm, the BatchNorm statistics within 1e-5 of the JAX
    train forward's, and AdamW's first step in each parameter's group
    (α, β, channel mixing and the combination weights at lr 1e-3 with
    weight decay 1e-6, the rest at 0.8e-3 with 1e-4): p − lr·(g/(|g| +
    1e-8) + wd·p), the optax adamw update at step 1, within 1e-6 where
    the clipped |g| > 1e-6."""
    _, params, state = jax_hybrid
    x, y = _batch()
    _, loss_ref, _, grads, post = exact_run
    port = _port(params, state)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    step = make_train_step(port, dict(PRESETS[PRESET]["train"],
                                      augment=None), 3, torch.Generator())
    loss, _ = step(x, y)
    assert abs(loss.item() - loss_ref) <= 1e-4 * abs(loss_ref)
    norm = math.sqrt(sum(float(np.sum(np.square(grads[n].numpy(),
                                                 dtype=np.float64)))
                         for n, _ in port.named_parameters()))
    clip = 1.0 / norm if norm > 1.0 else 1.0
    groups = ("alpha", "beta", "channel_mixing", "combination_weights")
    for name, p in port.named_parameters():
        g = grads[name].numpy() * clip
        if name not in ZERO_IN_EXACT_ARITHMETIC:
            assert _rel(p.grad, g) <= 1e-4, name
        lr, wd = ((1e-3, 1e-6) if any(k in name for k in groups)
                  else (0.8e-3, 1e-4))
        p0 = before[name].numpy()
        expected = p0 - lr * (g / (np.abs(g) + 1e-8) + wd * p0)
        moved = np.abs(g) > 1e-6
        np.testing.assert_allclose(p.detach().numpy()[moved],
                                   expected[moved], rtol=0, atol=1e-6,
                                   err_msg=name)
    for name, buf in port.named_buffers():
        if "running" in name:
            assert _scaled_err(buf, post[name]) <= 1e-5, name


def test_enable_amp_casts_the_ruthotto_blocks():
    """enable_amp: the two diffusion layers hoisted in bf16 (2 returned)
    and every SymmetricLayer in bf16; dense=False leaves the layers at
    their grade."""
    model = build_model(PRESET, device="cpu", ruthotto_dtype=torch.float32)
    assert enable_amp(model, dense=False) == 2
    layers = [m for m in model.modules() if isinstance(m, SymmetricLayer)]
    assert len(layers) == 3
    assert all(m.compute_dtype == torch.float32 for m in layers)
    assert enable_amp(model) == 2
    assert all(m.compute_dtype == torch.bfloat16 for m in layers)
    assert isinstance(model, CIFAR10HybridPDEModel)


def test_hybrid_clis_on_the_cpu(capsys, tmp_path, monkeypatch):
    """The train CLI with --preset cifar10_hybrid: one epoch of 2 steps
    with --grad-accum 2, a checkpoint every epoch, a metrics file and a BN
    refresh, then --resume to a second epoch with --amp (the weights and
    optimizer restored into the AMP grade); serve from its checkpoint
    directory, and with --amp."""
    # each run evaluates its test split: a small synthetic set keeps that
    # short
    monkeypatch.setattr(port_data, "synthetic_dataset", functools.partial(
        port_data.synthetic_dataset, train_per_class=2, test_per_class=1))
    ckpt, metrics = tmp_path / "ckpt", tmp_path / "metrics.jsonl"
    common = ["--preset", PRESET, "--synthetic", "--steps", "2",
              "--batch-size", "8", "--grad-accum", "2", "--device", "cpu",
              "--checkpoint-dir", str(ckpt), "--checkpoint-every", "1",
              "--metrics-out", str(metrics), "--quiet"]
    train_main(common + ["--epochs", "1", "--bn-refresh", "1"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["preset"] == PRESET and summary["epochs"] == 1
    assert summary["steps"] == 2 and math.isfinite(summary["last_loss"])
    assert "bn_refresh_acc" in summary
    train_main(common + ["--epochs", "2", "--resume", "--amp"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["restored"] and summary["epochs"] == 1
    assert summary["steps"] == 2 and summary["amp_layers"] == 2
    assert math.isfinite(summary["last_loss"])
    assert {"last.ckpt", "bn_refreshed.ckpt"} <= {p.name for p in
                                                  ckpt.iterdir()}
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["epoch"] for r in records] == [1, 2]
    assert all("test_acc" in r for r in records)
    serve_main(["--preset", PRESET, "--device", "cpu", "--checkpoint-dir",
                str(ckpt), "--tag", "last", "--batch-size", "3"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["restored"] and len(summary["predictions"]) == 3
    serve_main(["--preset", PRESET, "--device", "cpu", "--amp",
                "--batch-size", "2", "--output", "logits"])
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1])[
        "amp_cached_layers"] == 2
