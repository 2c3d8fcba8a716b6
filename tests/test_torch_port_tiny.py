"""The Tiny-ImageNet family in the port against the JAX package on the CPU:
the zero-padded Laplacian and its step, ResidualDiffusion (explicit, and
implicit on the Thomas solve: K1 and K3 on the card), the port's Conv2d in
both grades, BasicBlock with and without a shortcut, the ResNet-18
classifier's weights, eval logits and train-mode gradients, the
Resize(72) + RandomCrop(64) resampling (the preset, its per-batch
OneCycle and the synthetic set: ``test_torch_port_tiny_preset.py``),
the AMP grade (bf16 convolutions; the implicit front end's bf16 operator
route) against the JAX AMP grade, and both CLIs with
``--preset tiny_imagenet``.

Tolerances: the Laplacian 1e-6; ResidualDiffusion and BasicBlock 1e-5 on
outputs and 1e-5 of max(1, largest entry) on gradients; logits 1e-4; the
loss to 1e-4 relative and every gradient within 1e-4 of its largest entry;
the resampling 1e-5; the AMP grade against
the JAX AMP grade: one convolution and its gradients within one bf16 step
(2⁻⁸) of their largest entry (bit for bit in fact), the implicit front
end's bf16 route 4e-3, the model's logits and loss 4e-3, and each of its
20 convolutions, replayed on the inputs and cotangents that the JAX AMP
grade's step gave it, within 2⁻⁸ on its output and 6e-3 on its input
and weight gradients (see test_amp_grade_against_the_jax_amp_grade for
why the model's gradients are held conv by conv).

The full model's train-mode gradients are taken at B = 8 on 32 × 32
inputs (the backbone is fully convolutional): at B = 2 the last stage's
BatchNorm normalises two values a channel (1 × 1 spatial), and the JAX
model's own float32 gradients are 5e-2 to 1e-1 of their largest entry from
its float64 ones there.  Inputs hold no ReLU pre-activation within 1e-5 of
0, where a rounding would flip the kink (as in the SVHN tests).
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cnn_pde_tpu.compat.torch_import as jax_compat
import cnn_pde_tpu_torch.data as port_data
import cnn_pde_tpu.ops.tridiag as jax_tridiag
from cnn_pde_tpu.compat.torch_import import export_state_dict
from cnn_pde_tpu.data.augment import _resize_crop as jax_resize_crop
from cnn_pde_tpu.models import BasicBlock as JaxBlock
from cnn_pde_tpu.models import TinyImageNetClassifier as JaxTiny
from cnn_pde_tpu.nn import Ctx
from cnn_pde_tpu.nn.layers import Conv2d as JaxConv2d
from cnn_pde_tpu.ops.stencil import _laplacian_conv
from cnn_pde_tpu.ops.stencil import laplacian_step as jax_laplacian_step
from cnn_pde_tpu.pde import ResidualDiffusion as JaxResidual
from cnn_pde_tpu.pde.amp import enable_amp as jax_enable_amp
from cnn_pde_tpu.train.losses import cross_entropy as jax_cross_entropy
from cnn_pde_tpu_torch.compat import state_dict_from_jax
from cnn_pde_tpu_torch.data.augment import AugmentSpec, apply_resize_crop, draw
from cnn_pde_tpu_torch.layers import Conv2d, conv2d_bf16
from cnn_pde_tpu_torch.models import BasicBlock, build_model
from cnn_pde_tpu_torch.ops import tridiag
from cnn_pde_tpu_torch.ops.stencil import laplacian, laplacian_step
from cnn_pde_tpu_torch.pde import ResidualDiffusion, enable_amp
from cnn_pde_tpu_torch.serve_cli import main as serve_main
from cnn_pde_tpu_torch.train import cross_entropy
from cnn_pde_tpu_torch.train.__main__ import main as train_main
from tests.golden.reference_numpy import residual_forward_np


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


def _rel(port, ref):
    """max |port − ref| over the largest |ref|."""
    ref = np.asarray(ref, np.float64)
    port = np.asarray(torch.as_tensor(port).detach(), np.float64)
    return float(np.max(np.abs(port - ref)) / np.max(np.abs(ref)))


def _max_err(x, y):
    return float(np.max(np.abs(np.asarray(x, np.float64)
                               - np.asarray(y, np.float64))))


def _grad(p):
    """A parameter's gradient, zero where the forward did not read it (as
    jax.grad gives it)."""
    return torch.zeros_like(p) if p.grad is None else p.grad


@pytest.mark.parametrize("shape", [(2, 3, 16, 16), (1, 2, 5, 9)])
def test_laplacian_matches_jax(shape):
    u = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ref = np.asarray(_laplacian_conv(jnp.asarray(u)))
    assert _max_err(laplacian(torch.from_numpy(u)), ref) <= 1e-6
    coeff = np.linspace(0.02, 0.15, shape[1]).astype(np.float32)
    ref = np.asarray(jax_laplacian_step(jnp.asarray(u), jnp.asarray(coeff),
                                        0.01))
    out = laplacian_step(*map(torch.from_numpy, (u, coeff)), 0.01)
    assert _max_err(out, ref) <= 1e-6


def _residual_params(rng, C):
    """α straddling both clamp bounds (−0.1 and 0.3 are clamped), β moved
    off its init, channel scales around 1."""
    return {"alpha_base": np.array([-0.1, 0.08, 0.3][:C], np.float32),
            "beta_base": (0.05 + 0.04 * rng.random(C)).astype(np.float32),
            "channel_scaling": (1 + 0.2 * rng.standard_normal(C)
                                ).astype(np.float32)}


@pytest.mark.parametrize("implicit", [False, True])
def test_residual_diffusion_matches_jax(implicit):
    """Output and the gradients of ⟨y, r⟩ at (3, 16, 16) and two steps;
    ``beta_base`` gets a zero gradient in explicit mode on both sides.
    The explicit output also against the float64 oracle."""
    rng = np.random.default_rng(1)
    params = _residual_params(rng, 3)
    u = rng.random((2, 3, 16, 16)).astype(np.float32)
    r = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    layer = JaxResidual(size=16, channels=3, num_steps=2,
                        use_implicit=implicit)

    def loss(p):
        y, _ = layer.apply(p, {}, jnp.asarray(u), Ctx(train=True))
        return jnp.sum(y * r), y

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in params.items()})
    port = ResidualDiffusion(16, 3, num_steps=2, use_implicit=implicit)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    out = port(torch.from_numpy(u))
    (out * torch.from_numpy(r)).sum().backward()
    assert _max_err(out.detach(), ref) <= 1e-5
    for name, p in port.named_parameters():
        g = np.asarray(grads[name])
        assert _max_err(_grad(p), g) / max(1.0, np.abs(g).max()) <= 1e-5, \
            name
    if not implicit:
        assert not np.any(np.asarray(grads["beta_base"]))
        assert port.beta_base.grad is None
        golden = residual_forward_np(u, params, 0.01, 2)
        assert _max_err(out.detach(), golden) <= 1e-5


def _block_tree(rng, in_planes, planes, stride):
    """A JAX BasicBlock's params and BN state with every leaf moved off
    its init, and the same as a port state_dict (the reference's keys)."""
    block = JaxBlock(in_planes, planes, stride)
    params, state = block.init(jax.random.PRNGKey(in_planes + stride))

    def perturb(x):
        return np.asarray(x + 0.1 * rng.standard_normal(np.shape(x)),
                          np.float32)
    params = jax.tree_util.tree_map(perturb, params)
    state = jax.tree_util.tree_map(lambda v: np.abs(perturb(v)), state)
    sd = state_dict_from_jax({"layer2.0": params}, {"layer2.0": state},
                             "tiny_imagenet")
    return block, params, state, {k[len("layer2.0."):]: v
                                  for k, v in sd.items()}


@pytest.mark.parametrize("in_planes,planes,stride",
                         [(8, 8, 1), (8, 16, 2)])
@pytest.mark.parametrize("train", [False, True])
def test_basic_block_matches_jax(in_planes, planes, stride, train):
    """Without (8 → 8) and with (8 → 16, stride 2) a shortcut, in eval and
    in train mode: the output, and in train mode the gradients of ⟨y, r⟩
    and the new running statistics."""
    rng = np.random.default_rng(2)
    block, params, state, sd = _block_tree(rng, in_planes, planes, stride)
    x = rng.standard_normal((4, in_planes, 8, 8)).astype(np.float32)
    r = rng.standard_normal((4, planes, 8 // stride, 8 // stride)
                            ).astype(np.float32)

    port = BasicBlock(in_planes, planes, stride).train(train)
    assert (len(port.shortcut) > 0) == (stride != 1 or in_planes != planes)
    port.load_state_dict(sd, strict=True)
    out = port(torch.from_numpy(x))
    if not train:
        ref, _ = jax.jit(lambda p, s: block.apply(
            p, s, jnp.asarray(x), Ctx(train=False)))(params, state)
        assert _max_err(out.detach(), ref) <= 1e-5
        return

    def loss(p, s):
        y, ns = block.apply(p, s, jnp.asarray(x), Ctx(train=True))
        return jnp.sum(y * r), (y, ns)

    (_, (ref, new_state)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params, state)
    assert _max_err(out.detach(), ref) <= 1e-5
    (out * torch.from_numpy(r)).sum().backward()
    gref = state_dict_from_jax(
        {"b": jax.tree_util.tree_map(np.asarray, grads)},
        {"b": jax.tree_util.tree_map(np.asarray, new_state)},
        "tiny_imagenet")
    for name, p in port.named_parameters():
        g = gref[f"b.{name}"].numpy()
        assert _max_err(p.grad, g) / max(1.0, np.abs(g).max()) <= 1e-5, \
            name
    for name, buf in port.named_buffers():
        if "running" in name:
            assert _max_err(buf, gref[f"b.{name}"]) <= 1e-5, name


def _jax_trees(model, sd, preset="tiny_imagenet"):
    """The JAX model's (params, state) filled from a reference-layout
    state_dict ``sd``: the JAX importer's key map on the tree of
    ``jax.eval_shape(model.init)``, without running the JAX init."""
    rewrites = jax_compat.TORCH_KEY_REWRITES[preset]

    def fill(tree, is_state, prefix=""):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = fill(v, is_state, path)
                continue
            t = sd[jax_compat._torch_key(path, rewrites, is_state=is_state)]
            t = np.asarray(t, np.float32)
            out[k] = np.ascontiguousarray(t.T) if (
                k == "w" and t.ndim == 2) else t
        return out

    params, state = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return fill(params, False), fill(state, True)


@pytest.fixture(scope="module")
def jax_tiny():
    """The JAX classifier (dropout 0) on weights drawn by the port's init
    from a seeded generator, with the front end's fields and every BN
    parameter and statistic moved off their init."""
    rng = np.random.default_rng(3)
    sd = build_model("tiny_imagenet", device="cpu",
                     generator=torch.Generator().manual_seed(1)).state_dict()
    sd = {k: v.numpy().copy() for k, v in sd.items()}
    for k, v in sd.items():
        if ".bn" in f".{k}" or "shortcut.1." in k:
            if k.endswith(("weight", "running_var")):
                sd[k] = np.abs(v + 0.1 * rng.standard_normal(v.shape))
            elif k.endswith(("bias", "running_mean")):
                sd[k] = v + 0.1 * rng.standard_normal(v.shape)
    diff = _residual_params(rng, 3)
    diff["alpha_base"] = np.array([0.03, 0.08, 0.12], np.float32)
    sd.update({f"diff.{k}": v for k, v in diff.items()})
    model = JaxTiny(dropout_rate=0.0)
    params, state = _jax_trees(model, sd)
    return model, params, state


# the full model's batch: B = 8 on 32 × 32, no ReLU pre-activation within
# 1e-5 of 0 (checked in test_tiny_train_grads_match_jax)
_RNG = np.random.default_rng(24)
X8 = _RNG.random((8, 3, 32, 32)).astype(np.float32)
Y8 = _RNG.integers(0, 200, 8).astype(np.int32)


def _jax_run(model, params, state):
    """Eval logits, and the loss, gradients (as a port state_dict) and new
    BN statistics of one train-mode step (label smoothing 0.1) on X8."""
    def loss_fn(p, s):
        out, ns = model.apply(p, s, X8, Ctx(train=True,
                                            rng=jax.random.PRNGKey(0)))
        return jax_cross_entropy(out, Y8, 0.1), ns

    def run(p, s):
        logits, _ = model.apply(p, s, X8, Ctx(train=False))
        return logits, jax.value_and_grad(loss_fn, has_aux=True)(p, s)

    logits, ((loss, new_state), grads) = jax.jit(run)(params, state)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads),
                              jax.tree_util.tree_map(np.asarray, new_state),
                              "tiny_imagenet")
    return np.asarray(logits), float(loss), ref


def _jax_convs(model):
    """The JAX classifier's convolutions by the port's module names."""
    convs = {"conv1": model.conv1}
    for si, stage in enumerate(model.stages):
        for bi, block in enumerate(stage):
            for jax_name, name in (("conv1", "conv1"), ("conv2", "conv2"),
                                   ("sc_conv", "shortcut.0")):
                if hasattr(block, jax_name):
                    convs[f"layer{si + 1}.{bi}.{name}"] = getattr(block,
                                                                  jax_name)
    return convs


def _jax_amp_run(model, params, state):
    """``_jax_run`` of the JAX AMP grade, and what each of its convolutions
    saw in the train-mode step: input, output and output cotangent, by the
    port's module names.

    Compiled with XLA's ``xla_allow_excess_precision`` off: with it on (the
    default), XLA's CPU compiler drops the bf16 rounding of a convolution's
    output that is cast straight back to float32 inside one jit, so the
    grade would run with float32 conv outputs, not the bf16 outputs that
    its Conv2d states (and that one convolution jitted alone returns)."""
    convs = _jax_convs(model)
    seen, taps = {}, {}

    def tapped(name, apply):
        def run(p, s, x, ctx):
            y, ns = apply(p, s, x, ctx)
            if ctx.train:
                y = y + taps[name] if name in taps else y
                seen[name] = (x, y)
            return y, ns
        return run

    for name, conv in convs.items():
        conv.apply = tapped(name, conv.apply)
    train_ctx = Ctx(train=True, rng=jax.random.PRNGKey(0))
    jax.eval_shape(lambda p, s: model.apply(p, s, X8, train_ctx),
                   params, state)
    zeros = {n: jnp.zeros(y.shape, y.dtype) for n, (_, y) in seen.items()}

    def loss_fn(p, s, z):
        taps.clear()
        taps.update(z)
        out, ns = model.apply(p, s, X8, Ctx(train=True,
                                            rng=jax.random.PRNGKey(0)))
        return jax_cross_entropy(out, Y8, 0.1), (ns, dict(seen))

    def run(p, s):
        logits, _ = model.apply(p, s, X8, Ctx(train=False))
        return logits, jax.value_and_grad(loss_fn, argnums=(0, 2),
                                          has_aux=True)(p, s, zeros)

    compiled = jax.jit(run).lower(params, state).compile(
        compiler_options={"xla_allow_excess_precision": False})
    logits, ((loss, (new_state, io)), (grads, cotangents)) = compiled(
        params, state)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads),
                              jax.tree_util.tree_map(np.asarray, new_state),
                              "tiny_imagenet")
    taps_out = {n: (np.array(io[n][0]), np.array(io[n][1]),
                    np.array(cotangents[n]), convs[n]) for n in convs}
    return np.asarray(logits), float(loss), ref, taps_out


@pytest.fixture(scope="module")
def jax_runs(jax_tiny):
    """``_jax_run`` of the exact grade and ``_jax_amp_run`` of the JAX AMP
    grade (bf16 convolutions)."""
    _, params, state = jax_tiny
    amp = JaxTiny(dropout_rate=0.0)
    assert jax_enable_amp(amp) == 0
    try:
        return {"f32": _jax_run(jax_tiny[0], params, state),
                "amp": _jax_amp_run(amp, params, state)}
    finally:
        jax_tridiag.set_default_impl("auto")


def _port(params, state, preset="tiny_imagenet", **kwargs):
    port = build_model(preset, device="cpu", dropout_rate=0.0, **kwargs)
    port.load_state_dict(state_dict_from_jax(params, state, preset),
                         strict=True)
    return port


def _port_run(port):
    """The port's counterpart of ``_jax_run`` (gradients by name, a
    parameter the forward did not read at zero)."""
    with torch.inference_mode():
        logits = port.eval()(torch.from_numpy(X8))
    port.train()
    loss = cross_entropy(port(torch.from_numpy(X8)), torch.from_numpy(Y8),
                         0.1)
    loss.backward()
    return logits, loss.item(), {n: _grad(p)
                                 for n, p in port.named_parameters()}


def test_state_dict_from_jax_equals_export(jax_tiny):
    _, params, state = jax_tiny
    sd = state_dict_from_jax(params, state, "tiny_imagenet")
    ref = export_state_dict(params, state, "tiny_imagenet")
    assert list(sd) == list(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert "layer2.0.shortcut.0.weight" in sd
    assert "layer1.0.shortcut.0.weight" not in sd
    model = build_model("tiny_imagenet", device="cpu")
    assert set(model.state_dict()) == set(sd)


def test_tiny_logits_match_jax_at_64(jax_tiny):
    """Eval logits at the preset's 64 × 64, B = 2."""
    model, params, state = jax_tiny
    x = np.random.default_rng(4).random((2, 3, 64, 64)).astype(np.float32)
    ref, _ = jax.jit(lambda p, s, v: model.apply(p, s, v, Ctx(train=False))
                     )(params, state, x)
    with torch.inference_mode():
        logits = _port(params, state)(torch.from_numpy(x)).numpy()
    assert logits.shape == (2, 200)
    assert _max_err(logits, ref) <= 1e-4


def _relu_inputs_clear_of_zero(model, x):
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: seen.append(inp[0].abs().min().item()))
        for m in model.modules() if isinstance(m, torch.nn.ReLU)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return min(seen)


def test_tiny_train_grads_match_jax(jax_tiny, jax_runs):
    """Eval logits at 32 × 32, and the loss, every gradient and the new BN
    statistics of one train-mode forward and backward (dropout 0, the
    preset's label smoothing 0.1) at B = 8 against jax.value_and_grad."""
    _, params, state = jax_tiny
    ref_logits, ref_loss, ref = jax_runs["f32"]
    port = _port(params, state).train()
    assert _relu_inputs_clear_of_zero(port, torch.from_numpy(X8)) > 1e-5
    port = _port(params, state)
    logits, loss, grads = _port_run(port)
    assert logits.shape == (8, 200)
    assert _max_err(logits, ref_logits) <= 1e-4
    assert abs(loss - ref_loss) <= 1e-4 * abs(ref_loss)
    assert not np.any(ref["diff.beta_base"].numpy())
    assert port.diff.beta_base.grad is None
    for name, g in grads.items():
        if name != "diff.beta_base":
            assert _rel(g, ref[name].numpy()) <= 1e-4, name
    for name, buf in port.named_buffers():
        if "running" in name:
            assert _max_err(buf, ref[name]) <= 1e-5, name


def test_resize_crop_matches_jax():
    """Resize(72) + RandomCrop(64) at the offsets the JAX function draws
    from its key, image by image; and the draws' ranges."""
    rng = np.random.default_rng(6)
    images = rng.random((3, 3, 64, 64)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    refs, oys, oxs = [], [], []
    for img, key in zip(images, keys):
        refs.append(np.asarray(jax_resize_crop(key, jnp.asarray(img), 72)))
        ky, kx = jax.random.split(key)
        oys.append(int(jax.random.randint(ky, (), 0, 9)))
        oxs.append(int(jax.random.randint(kx, (), 0, 9)))
    out = apply_resize_crop(torch.from_numpy(images), torch.tensor(oys),
                            torch.tensor(oxs), 72)
    assert out.shape == images.shape
    assert _max_err(out, np.stack(refs)) <= 1e-5
    d = draw(AugmentSpec(resize_crop=72), (500, 3, 64, 64),
             torch.Generator().manual_seed(0), "cpu")
    for key in ("resize_oy", "resize_ox"):
        assert int(d[key].min()) == 0 and int(d[key].max()) == 8


@pytest.fixture
def restore_impls():
    yield
    jax_tridiag.set_default_impl("auto")
    tridiag.set_default_impl("auto")


@pytest.fixture
def _emulate_jax_bf16(monkeypatch):
    """The JAX bf16 operator apply on the CPU: X and d rounded to bf16, the
    product in float32 (its bf16 × bf16 → float32 dot has no CPU kernel),
    as the JAX package's own tests run it."""
    apply = jax_tridiag._inv_apply_einsum

    def emulated(X, d, transpose):
        if X.dtype == jnp.bfloat16:
            X = X.astype(jnp.float32)
            d = d.astype(jnp.bfloat16).astype(jnp.float32)
        return apply(X, d, transpose)

    monkeypatch.setattr(jax_tridiag, "_inv_apply_einsum", emulated)


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 3)])
def test_bf16_conv_matches_jax(stride, padding):
    """One convolution of the AMP grade (bf16 operands, bf16 output cast to
    float32) and its gradients against the JAX layer's, within one bf16
    step (2⁻⁸) of the largest entry.  XLA's CPU bf16 convolution rounds as
    the plain version does: the output and the input and weight gradients
    agree bit for bit here."""
    rng = np.random.default_rng(8)
    k = 3 if padding == 1 else 7
    x = rng.standard_normal((2, 16, 12, 12)).astype(np.float32)
    w = rng.standard_normal((8, 16, k, k)).astype(np.float32)
    jax_conv = JaxConv2d(16, 8, k, stride=stride, padding=padding,
                         bias=False, compute_dtype=jnp.bfloat16)

    def f(x, p):
        return jax_conv.apply(p, {}, x, Ctx(train=False))[0]

    ref, vjp = jax.vjp(f, jnp.asarray(x), {"w": w})
    g = rng.standard_normal(ref.shape).astype(np.float32)
    gx, gp = vjp(jnp.asarray(g))
    xs, ws = (torch.from_numpy(a.copy()).requires_grad_() for a in (x, w))
    out = conv2d_bf16(xs, ws, (stride, stride), (padding, padding))
    out.backward(torch.from_numpy(g))
    assert out.dtype == torch.float32
    for got, want in ((out, ref), (xs.grad, gx), (ws.grad, gp["w"])):
        assert _rel(got, want) <= 2.0 ** -8
        assert torch.equal(got.detach(), torch.from_numpy(np.array(want)))


def _on_bf16_grid(t):
    t = t.detach()
    return torch.equal(t, t.to(torch.bfloat16).float())


def test_amp_grade_against_the_jax_amp_grade(jax_tiny, jax_runs):
    """enable_amp (bf16 convolutions) against the JAX AMP grade.

    The model: every port Conv2d in bf16, eval logits within 4e-3 of their
    largest entry, the train-mode loss within 4e-3.  Each convolution,
    replayed: the port's module, run on the input that the JAX AMP grade's
    convolution of the same name saw in the train-mode step and given its
    output cotangent, returns an output on the bf16 grid within one bf16
    step (2⁻⁸) of the JAX output, an input gradient within 6e-3 of the
    JAX layer's, and a weight gradient within 6e-3 of the JAX model's
    gradient for that weight, each of its largest entry.

    The model's gradients are compared conv by conv because two bf16
    pipelines agree only up to where a rounding falls: BatchNorm computes
    its float32 sums in another order in the two packages, a value within
    that difference of a bf16 midpoint rounds the other way, and the
    convolutions after it carry the step on; train-mode BatchNorm's
    backward then cancels the bf16 cotangents down to their rounding.  On
    this batch the JAX AMP grade's own gradients are up to 0.96 of their
    largest entry from its exact grade's, and the port's up to 0.76 from
    the JAX AMP grade's, while each convolution replayed agrees within
    2.1e-3."""
    _, params, state = jax_tiny
    ref_logits, ref_loss, ref, convs = jax_runs["amp"]
    port = _port(params, state)
    assert enable_amp(port) == 0
    assert tridiag._DEFAULT_IMPL == "auto"
    modules = {n: m for n, m in port.named_modules() if isinstance(m, Conv2d)}
    assert set(modules) == set(convs) and len(modules) == 20
    assert all(m.compute_dtype == torch.bfloat16 for m in modules.values())
    logits, loss, _ = _port_run(port)
    assert _rel(logits, ref_logits) <= 4e-3
    assert abs(loss - ref_loss) <= 4e-3 * abs(ref_loss)
    for name, (x, y, g, jax_conv) in convs.items():
        conv = modules[name]
        conv.zero_grad(set_to_none=True)
        xs = torch.from_numpy(x).requires_grad_()
        out = conv(xs)
        out.backward(torch.from_numpy(g))
        assert _on_bf16_grid(out), name
        assert _rel(out, y) <= 2.0 ** -8, name
        _, vjp = jax.vjp(lambda v: jax_conv.apply(
            {"w": jnp.asarray(conv.weight.detach().numpy())}, {}, v,
            Ctx(train=False))[0], jnp.asarray(x))
        assert _rel(xs.grad, vjp(jnp.asarray(g))[0]) <= 6e-3, name
        assert _rel(conv.weight.grad, ref[f"{name}.weight"].numpy()) <= 6e-3, \
            name


def test_enable_amp_wiring():
    model = build_model("tiny_imagenet", device="cpu", pde_implicit=True)
    convs = [m for m in model.modules() if isinstance(m, Conv2d)]
    assert len(convs) == 20
    assert enable_amp(model) == 0
    assert all(c.compute_dtype == torch.bfloat16 for c in convs)
    assert model.fc.weight.dtype == torch.float32
    assert model.diff.solve_impl == "matinv_bf16"
    assert tridiag._DEFAULT_IMPL == "auto"
    assert enable_amp(build_model("emotion", device="cpu")) == 0
    exact = build_model("tiny_imagenet", device="cpu", use_pde=False)
    assert enable_amp(exact, dense=False) == 0
    assert all(m.compute_dtype is None for m in exact.modules()
               if isinstance(m, Conv2d))


def test_implicit_front_end_takes_the_bf16_operator_route(restore_impls,
                                                          _emulate_jax_bf16):
    """Under ``solve_impl='matinv_bf16'`` the two sweeps are built as
    operators at the call and applied in bf16: the same values as the
    global 'matinv_bf16' route, the JAX layer under the JAX global, and
    not the float32 solve's."""
    rng = np.random.default_rng(10)
    params = _residual_params(rng, 3)
    u = rng.random((2, 3, 64, 64)).astype(np.float32)
    jax_tridiag.set_default_impl("matinv_bf16")
    ref, _ = jax.jit(lambda p, v: JaxResidual(use_implicit=True).apply(
        p, {}, v, Ctx(train=False)))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(u))
    layer = ResidualDiffusion(use_implicit=True)
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    with torch.no_grad():
        exact = layer(torch.from_numpy(u))
        layer.solve_impl = "matinv_bf16"
        bf16 = layer(torch.from_numpy(u))
        tridiag.set_default_impl("matinv_bf16")
        layer.solve_impl = "auto"
        global_route = layer(torch.from_numpy(u))
    assert torch.equal(bf16, global_route)
    assert _rel(bf16, ref) <= 4e-3
    assert _rel(bf16, exact) > 1e-6  # the bf16 rounding is there


def test_tiny_clis_on_the_cpu(capsys, monkeypatch):
    serve_main(["--preset", "tiny_imagenet", "--device", "cpu", "--amp",
                "--batch-size", "2", "--output", "logits"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["preset"] == "tiny_imagenet"
    assert summary["shape"] == [2, 200] and summary["amp_cached_layers"] == 0
    # the CLI trains one epoch and then evaluates the test split: eight
    # images of each split (of one a class) keep that evaluation short
    make = port_data.synthetic_dataset

    def small(name):
        ds = make(name, train_per_class=1, test_per_class=1)
        assert ds.num_classes == 200
        for split in ("train", "test"):
            for part in ("images", "labels"):
                key = f"{split}_{part}"
                setattr(ds, key, getattr(ds, key)[:8])
        return ds

    monkeypatch.setattr(port_data, "synthetic_dataset", small)
    train_main(["--preset", "tiny_imagenet", "--synthetic", "--epochs",
                "1", "--steps", "2",
                "--device", "cpu", "--batch-size", "4"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["preset"] == "tiny_imagenet" and summary["steps"] == 2
    assert math.isfinite(summary["first_loss"])
    assert math.isfinite(summary["last_loss"])
    assert summary["amp_layers"] == 0
