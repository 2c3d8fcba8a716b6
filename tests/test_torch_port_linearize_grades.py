"""Linearized serving's grades and the emotion classifier against the
JAX package on the CPU: split from ``test_torch_port_linearize.py``,
whose helpers and tolerances these tests share (``linearize_pde_layers``
with ``dtype='auto'`` and ``select_linearize_grade``; emotion's FTCS layer
at D = 48·48, its logits at 1e-4 of the largest entry)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_pde_tpu.models import EmotionClassifier as JaxEmotion
from cnn_pde_tpu.serve import linearize_pde_layers as jax_linearize
from cnn_pde_tpu.serve import make_predict_fn as jax_predict_fn
from cnn_pde_tpu_torch.compat import state_dict_from_jax
from cnn_pde_tpu_torch.models import build_model
from cnn_pde_tpu_torch.pde import MixedChannelDiffusion
from cnn_pde_tpu_torch.pde.linearize import QuantizedMatrix
import cnn_pde_tpu_torch.serve as serve_module
from cnn_pde_tpu_torch.serve import (clear_linear_cache,
                                     linearize_pde_layers, make_predict_fn,
                                     select_linearize_grade)
from tests.test_torch_port_linearize import _port_out, _rel


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six test
    files at once on one host, and eight threads each oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_emotion_linearized_logits_match_jax():
    """The emotion classifier's FTCS layer (D = 48·48) linearizes; its
    random-init logits are about 1e4, so the bound is relative to the
    largest entry and the labels must agree."""
    model = JaxEmotion()
    params, state = jax.tree_util.tree_map(
        np.asarray, jax.jit(model.init)(jax.random.PRNGKey(2)))
    port = build_model("emotion", device="cpu")
    port.load_state_dict(state_dict_from_jax(params, state, "emotion"),
                         strict=True)
    x = np.random.default_rng(7).random((4, 1, 48, 48)).astype(np.float32)
    ref = np.asarray(jax_predict_fn(model, params, state)(x))
    assert jax_linearize(model, params, state, jnp.asarray(x)) == 1
    assert linearize_pde_layers(port, x) == 1
    assert _rel(port.pde.linear_cache, model.pde.linear_cache) <= 1e-5
    out = make_predict_fn(port)(x).numpy()
    jax_out = np.asarray(jax_predict_fn(model, params, state)(x))
    assert _rel(out, jax_out) <= 1e-4 and _rel(out, ref) <= 1e-4
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))


def test_select_linearize_grade_table():
    """'auto' follows the port's own table, set from its H100 rates: int8
    won at no batch and no D there, so every batch takes bf16."""
    for batch in (1, 64, 256, 1024, 4096):
        for dim in (None, 784, 2304, 3072):
            assert select_linearize_grade(batch, dim) == torch.bfloat16


def test_linearize_auto_grade_pins_the_tables_choice(monkeypatch):
    """dtype='auto' resolves from the serving batch (default: the
    sample's) and D through the table: bf16 at every batch with the
    H100's; int8 where a table picks it."""
    big = MixedChannelDiffusion(size=32, num_steps=1).eval()  # D = 3072
    bx = np.random.default_rng(9).standard_normal((2, 3, 32, 32)).astype(
        np.float32)
    ref = _port_out(big, bx)
    assert linearize_pde_layers(big, bx, dtype="auto",
                                serve_batch_size=4096) == 1
    assert big.linear_cache.dtype == torch.bfloat16
    clear_linear_cache(big)
    asked = []
    monkeypatch.setattr(serve_module, "select_linearize_grade",
                        lambda batch, feature_dim=None: asked.append(
                            (batch, feature_dim)) or torch.int8)
    assert linearize_pde_layers(big, bx, dtype="auto",
                                serve_batch_size=256) == 1
    assert asked == [(256, 3072)]
    assert isinstance(big.linear_cache, QuantizedMatrix)
    monkeypatch.undo()
    assert _rel(_port_out(big, bx), ref) <= 2e-2
    clear_linear_cache(big)
    assert linearize_pde_layers(big, bx, dtype="auto") == 1
    assert big.linear_cache.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="dtype"):
        linearize_pde_layers(big, bx, dtype=torch.float16)
