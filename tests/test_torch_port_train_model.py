"""The port's MixedChannelDiffusion and CIFAR-10 flagship in training against
the JAX package on the CPU, in both trainable configurations: per-sweep
(every sweep one Thomas solve and one adjoint; K1 and K3 on the card) and
``fused=True`` (one trainable whole-layer call per branch; K4 and K5 on the
card).  On the CPU both run their plain versions, and both are held against
the JAX default (XLA) path: the same function.

Tolerances.  Layer gradients: 1e-4 relative per element, with an atol of
1e-6 in units of the tensor's largest entry (at least 1).  Flagship: the
loss to 1e-4 relative; each gradient tensor to 1e-4 relative to its
largest entry, plus 1e-6; the BatchNorm running statistics to 1e-5.  The
flagship's head normalises over the batch (BN1d in train mode), which
amplifies the 1e-7 rounding differences of the two solvers (Thomas against
the JAX default's PCR) in small entries, so an elementwise relative bound
does not hold there.  A bias that feeds a train-mode BatchNorm, and the
feature BN's bias (whose gradient sums to zero over the batch through the
BN1d head), has a zero gradient in exact arithmetic: there both frameworks
must give |g| <= 1e-4, the float noise of the cancelling sums.

The flagship's inputs are chosen so that no 8x8 max-pool window holds a
near tie (top-2 gap above 1e-4): at a near tie a rounding difference of
1e-6 moves the pool's argmax and, with it, every upstream gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_pde_tpu.models import CIFAR10PDENoConv as JaxModel
from cnn_pde_tpu.nn import Ctx
from cnn_pde_tpu.pde import MixedChannelDiffusion as JaxMixed
from cnn_pde_tpu.train.losses import cross_entropy as jax_cross_entropy
from cnn_pde_tpu_torch.compat import state_dict_from_jax
from cnn_pde_tpu_torch.models import build_model
from cnn_pde_tpu_torch.models.cifar10_noconv import MultiScaleExtractor
from cnn_pde_tpu_torch.pde import MixedChannelDiffusion
from cnn_pde_tpu_torch.train import cross_entropy


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six test
    files at once on one host, and eight threads each oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SCALES = MultiScaleExtractor.SCALES
CONFIGS = ["per_sweep", "fused"]
NAMES = ["alpha_base", "alpha_time_coeff", "beta_base", "beta_time_coeff",
         "channel_mixing"]


ZERO_IN_EXACT_ARITHMETIC = {"feature_bn.bias"} | {
    f"classifier.network.{i}.bias" for i in (0, 4, 8, 12)}


def _close(port, ref, name, rtol=1e-4, atol=1e-6):
    ref = np.asarray(ref, np.float64)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(np.asarray(port, np.float64), ref, rtol=rtol,
                               atol=atol * scale, err_msg=name)


def _fields(rng, C=3, S=32):
    """Trained-looking fields: bases 1 ± 0.5, time coefficients 5·N(0, 1),
    mixing I + 0.05·N(0, 1)."""
    return {
        "alpha_base": 1.0 + 0.5 * rng.standard_normal((C, S, S)),
        "alpha_time_coeff": 5.0 * rng.standard_normal((C, S, S)),
        "beta_base": 1.0 + 0.5 * rng.standard_normal((C, S, S)),
        "beta_time_coeff": 5.0 * rng.standard_normal((C, S, S)),
        "channel_mixing": np.eye(C) + 0.05 * rng.standard_normal((C, C)),
    }


@pytest.fixture(scope="module")
def layer_grads():
    """For each flagship branch scale: params, the input, the output's
    cotangent and jax.grad of the JAX layer in u and all five params."""
    rng = np.random.default_rng(20)
    u = rng.random((2, 3, 32, 32)).astype(np.float32)
    gw = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    cases = []
    for scale in SCALES:
        params = {k: v.astype(np.float32) for k, v in _fields(rng).items()}
        layer = JaxMixed(32, 3, splitting="strang", **scale)
        grads = jax.jit(jax.grad(
            lambda p, x: jnp.sum(layer(p, {}, x)[0] * gw),
            argnums=(0, 1)))(params, u)
        cases.append((params, grads))
    return u, gw, cases


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("branch", [0, 1, 2])
def test_layer_grads_match_jax(layer_grads, branch, config):
    u, gw, cases = layer_grads
    params, (gp, gu) = cases[branch]
    layer = MixedChannelDiffusion(32, 3, splitting="strang",
                                  fused=config == "fused",
                                  **SCALES[branch]).train()
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    x = torch.from_numpy(u).requires_grad_(True)
    (layer(x) * torch.from_numpy(gw)).sum().backward()
    _close(x.grad, gu, "grad u")
    for name in NAMES:
        _close(getattr(layer, name).grad, gp[name], f"grad {name}")


@pytest.fixture(scope="module")
def flagship_step():
    """JAX flagship (dropout 0) with trained-looking PDE fields: the loss,
    every parameter's gradient and the new BN statistics of one train-mode
    forward and backward (``Trainer``'s ``loss_fn`` under
    ``Ctx(train=True)``), all in the port's state_dict names."""
    rng = np.random.default_rng(26)
    model = JaxModel(dropout_rate=0.0)
    params, state = jax.tree_util.tree_map(
        np.asarray, jax.jit(model.init)(jax.random.PRNGKey(3)))
    for i in (1, 2, 3):
        params["feature_extractor"][f"pde{i}"] = {
            k: v.astype(np.float32) for k, v in _fields(rng).items()}
    x = rng.random((8, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)

    def loss_fn(p, s):
        ctx = Ctx(train=True, rng=jax.random.PRNGKey(0))
        logits, new_state = model.apply(p, s, x, ctx)
        return jax_cross_entropy(logits, y, 0.1), new_state

    (loss, new_state), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, state)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads),
                              jax.tree_util.tree_map(np.asarray, new_state))
    return params, state, x, y, float(loss), ref


@pytest.mark.parametrize("config", CONFIGS)
def test_flagship_train_grads_match_jax(flagship_step, config):
    params, state, x, y, ref_loss, ref = flagship_step
    model = build_model("cifar10_noconv", device="cpu", dropout_rate=0.0,
                        fused_pde=config == "fused")
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    model.train()
    with torch.no_grad():
        pooled = model.feature_bn(model.feature_extractor(
            torch.from_numpy(x))).unfold(2, 8, 8).unfold(3, 8, 8)
        top2 = pooled.reshape(*pooled.shape[:4], 64).topk(2, dim=-1).values
        assert float((top2[..., 0] - top2[..., 1]).min()) > 1e-4
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    loss = cross_entropy(model(torch.from_numpy(x)), torch.from_numpy(y),
                         0.1)
    loss.backward()
    _close(loss.item(), ref_loss, "loss")
    for name, p in model.named_parameters():
        r = ref[name].double()
        if name in ZERO_IN_EXACT_ARITHMETIC:
            assert max(p.grad.abs().max().item(),
                       r.abs().max().item()) <= 1e-4, name
        else:
            err = (p.grad.double() - r).abs().max().item()
            assert err <= 1e-4 * r.abs().max().item() + 1e-6, (name, err)
    for name, buf in model.named_buffers():
        if "running" in name:
            _close(buf, ref[name], name, rtol=0, atol=1e-5)
