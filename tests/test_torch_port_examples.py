"""The port's examples (examples/torch_0[1-4]_*.py) stay runnable: each as
a subprocess on the CPU (``--device cpu``; 04 as two gloo ranks), as
tests/test_examples.py runs the JAX ones, with its expected lines."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(name, *args, timeout=300):
    """examples/``name`` with ``--device cpu`` and ``args``, two intra-op
    threads (Tier-1 runs six test processes at once): its output, after
    checking that it exited 0."""
    p = subprocess.run(
        [sys.executable, os.path.join("examples", name), "--device", "cpu",
         *args], cwd=REPO, text=True, timeout=timeout,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert p.returncode == 0, p.stdout
    return p.stdout


def test_torch_example_train_preset(tmp_path):
    out = _run("torch_01_train_preset.py", "mnist", "1", "--data-dir",
               str(tmp_path / "absent"))
    assert re.search(r"^mnist \(synthetic data, cpu\): [\d,]+ params "
                     r"\([\d,]+ in PDE groups\) -> \(128, 10\)$", out, re.M)
    assert re.search(r"^best test acc: \d+\.\d\d%$", out, re.M), out


def test_torch_example_custom_pde_layer():
    out = _run("torch_02_custom_pde_layer.py")
    final = re.search(r"^final loss (\S+); learned alpha=(\S+) beta=(\S+)$",
                      out, re.M)
    assert final, out
    assert float(final[1]) < 1.0
    # softplus(0) + 1e-3 at the start: the anisotropy moved
    assert abs(float(final[2]) - 0.694) > 1e-3 and float(final[3]) > 0


def test_torch_example_serving():
    out = _run("torch_03_serving.py")
    ref = re.search(r"^sequential predictions: \[([\d ]+)\]$", out, re.M)
    int8 = re.search(r"^linearized 3 PDE branches; int8 predictions: "
                     r"\[([\d ]+)\]$", out, re.M)
    assert ref and int8, out
    assert ref[1].split() == int8[1].split() and len(ref[1].split()) == 8
    assert "reloaded logits shape (8, 10)" in out


def test_torch_example_multichip_two_gloo_ranks():
    out = _run("torch_04_multichip.py", "--ranks", "2")
    losses = re.findall(r"^step (\d): loss (\S+) \(batch 16 over 2 data "
                        r"shards, cpu\)$", out, re.M)
    assert [s for s, _ in losses] == ["0", "1", "2"], out
    assert all(0 < float(v) < 10 for _, v in losses)
