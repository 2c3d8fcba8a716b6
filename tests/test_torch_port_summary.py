"""The port's model summary (``cnn_pde_tpu_torch/utils/summary.py``)
against ``cnn_pde_tpu.utils.summary`` on the CPU for all seven presets:
the parameter totals, the PDE groups' counts, the BatchNorm statistics'
entries and the output shape, from a forward on the meta device; and the
train CLI's ``--summary``.

Tolerance: none (counts and shapes are equal).
"""

import json

import jax
import pytest
import torch

from cnn_pde_tpu.models import MODEL_REGISTRY as JAX_MODELS
from cnn_pde_tpu.nn.core import tree_size
from cnn_pde_tpu.utils.config import get_preset as jax_preset
from cnn_pde_tpu.utils.summary import model_summary as jax_model_summary
from cnn_pde_tpu.utils.summary import \
    param_group_counts as jax_param_group_counts
from cnn_pde_tpu_torch.models import build_model
from cnn_pde_tpu_torch.presets import PRESETS, SYNTHETIC_SPECS
from cnn_pde_tpu_torch.train.__main__ import main as train_main
from cnn_pde_tpu_torch.utils import (format_summary, model_summary,
                                     param_group_counts)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six test
    files at once on one host, and eight threads each oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_summary_matches_jax(preset):
    values = PRESETS[preset]
    model = build_model(values["model"], device="cpu",
                        **values["model_kwargs"])
    ref = jax_preset(preset)
    jax_model = JAX_MODELS[ref.model](**ref.model_kwargs)
    channels, size, _ = SYNTHETIC_SPECS[values["dataset"]]
    shape = (3, channels, size, size)
    params, _ = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0))
    assert param_group_counts(model) == jax_param_group_counts(params)
    ours = model_summary(model, shape)
    theirs = jax_model_summary(jax_model, shape)
    for key in ("input_shape", "output_shape", "total_params",
                "pde_params", "pde_groups", "state_entries"):
        assert ours[key] == theirs[key], key
    assert ours["pde_params"] > 0
    assert sum(n for _, n in ours["subtrees"]) == ours["total_params"] \
        == tree_size(params)
    # shape-only: the model's own weights are untouched and stay on the CPU
    assert next(model.parameters()).device.type == "cpu"
    table = format_summary(ours)
    assert f"{ours['total_params']:,}" in table
    assert f"-> output {ours['output_shape']}" in table


def test_train_cli_prints_the_summary(capsys):
    train_main(["--preset", "mnist", "--synthetic", "--epochs", "1",
                "--steps", "1", "--batch-size", "8", "--device", "cpu",
                "--summary", "--quiet", "--no-preemption-handler"])
    out = capsys.readouterr().out
    assert "Model: 206,666 parameters (PDE groups 3,136 = 1.5%)" in out
    assert "PDE (grouped) params" in out and "diff.alpha_base" in out
    assert "input (8, 1, 28, 28) -> output (8, 10)" in out
    assert json.loads(out.strip().splitlines()[-1])["steps"] == 1
    assert torch.get_default_device().type == "cpu"
