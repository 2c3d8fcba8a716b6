"""The train CLI's Trainer flags on the CPU for every preset but the
hybrid (test_torch_port_hybrid.py runs its): epochs with a per-epoch step
cap, gradient accumulation, checkpoints, a metrics file, the BN refresh
and ``--resume``, which ends on the weights of an uninterrupted run bit
for bit; and its refusals.
"""

import functools
import json
import math
import os

import pytest
import torch

import cnn_pde_tpu_torch.data as port_data
from cnn_pde_tpu_torch.presets import PRESETS
from cnn_pde_tpu_torch.train.__main__ import main as train_main
from cnn_pde_tpu_torch.train.checkpoint import load_checkpoint


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six test
    files at once on one host, and eight threads each oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_sets(monkeypatch):
    """The CLI's synthetic sets at 5 training and 1 test image a class:
    each run evaluates its test split, and the resume equality does not
    depend on the size."""
    monkeypatch.setattr(port_data, "synthetic_dataset", functools.partial(
        port_data.synthetic_dataset, train_per_class=5, test_per_class=1))


def _summary(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# the hybrid's run through these flags is test_torch_port_hybrid.py's
@pytest.mark.parametrize("preset", sorted(set(PRESETS) - {"cifar10_hybrid"}))
def test_train_cli_checkpoints_and_resumes(preset, tmp_path, capsys,
                                           small_sets):
    """Every preset through the CLI on the CPU: one epoch of 2 steps with
    --grad-accum 2, a checkpoint directory, a metrics file and a BN
    refresh; then --resume with --epochs 2 runs the second epoch only, and
    ends on the weights of an uninterrupted two-epoch run: held bit for
    bit on five presets; tiny_imagenet, the slowest on a CPU, runs the
    first two (test_torch_port_trainer.py holds a SIGTERM'd run's resume
    bit for bit)."""
    ckpt, whole = tmp_path / "ckpt", tmp_path / "whole"
    common = ["--preset", preset, "--synthetic", "--steps", "2",
              "--batch-size", "16", "--grad-accum", "2", "--device", "cpu",
              "--quiet", "--checkpoint-every", "1"]
    train_main(common + ["--epochs", "1", "--checkpoint-dir", str(ckpt),
                         "--metrics-out", str(tmp_path / "m.jsonl"),
                         "--bn-refresh", "1"])
    summary = _summary(capsys)
    assert summary["preset"] == preset and summary["epochs"] == 1
    assert summary["steps"] == 2 and math.isfinite(summary["last_loss"])
    assert "bn_refresh_acc" in summary
    # a 'best' checkpoint comes with a test accuracy above 0
    assert {"last.ckpt", "bn_refreshed.ckpt"} <= set(os.listdir(ckpt))
    assert ("best.ckpt" in os.listdir(ckpt)) == (summary["best_acc"] > 0)
    assert len((tmp_path / "m.jsonl").read_text().splitlines()) == 1
    train_main(common + ["--epochs", "2", "--checkpoint-dir", str(ckpt),
                         "--resume"])
    summary = _summary(capsys)
    assert summary["restored"] and summary["epochs"] == 1
    assert summary["steps"] == 2
    assert load_checkpoint(str(ckpt), "last")["step"] == 4
    if preset == "tiny_imagenet":
        return
    train_main(common + ["--epochs", "2", "--checkpoint-dir", str(whole)])
    assert _summary(capsys)["steps"] == 4
    resumed = load_checkpoint(str(ckpt), "last")
    reference = load_checkpoint(str(whole), "last")
    assert resumed["step"] == reference["step"] == 4
    for k, v in reference["model"].items():
        assert torch.equal(resumed["model"][k], v), k


def test_train_cli_refusals(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    with pytest.raises(SystemExit, match="--device cpu"):
        train_main(["--preset", "cifar10_hybrid", "--synthetic", "--epochs",
                    "1", "--steps", "1"])
    with pytest.raises(SystemExit, match="no PyTorch counterpart"):
        train_main(["--preset", "mnist", "--synthetic", "--device", "cpu",
                    "--checkpoint-backend", "orbax", "--checkpoint-dir",
                    str(tmp_path)])
