"""The port's analysis and tooling (``cnn_pde_tpu_torch/utils/analysis.py``,
``utils/viz.py``, ``utils/sweep.py``, ``analyze.py``) against the JAX
package's on the CPU.

The numpy diagnostics are held against JAX's on the same arrays (1e-12
relative: the same float64 arithmetic).  The evolution spectra of mnist
(D = 784) and fashion_mnist, per-sweep and ``fused_inference``, are held
against JAX's ``model_evolution_spectra`` on the same weights (trained-
looking fields): spectral radius, σ_max, σ_min and non-normality within
1e-4 relative, and the |λ| of the top eigenvalues, sorted, within 1e-4.
The flagship (D = 3,072) is not linearized here: its basis runs on the
card (``chip_smoke.py``).  The analyze CLI runs on the synthetic fixture
as ``tests/test_analyze_cli.py`` runs the JAX one, three processes at
once.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from cnn_pde_tpu.utils import analysis as jana
from cnn_pde_tpu_torch.compat import state_dict_from_jax
from cnn_pde_tpu_torch.models import build_model
from cnn_pde_tpu_torch.utils import analysis as pana
from cnn_pde_tpu_torch.utils.sweep import (compare_configs,
                                           compare_spatial_discretizations,
                                           format_table)


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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC_TOL = 1e-4


def _fields(rng, shape):
    return {"alpha_base": rng.uniform(0.2, 2.0, shape),
            "alpha_time_coeff": rng.normal(0.0, 0.5, shape),
            "beta_base": rng.uniform(0.2, 2.0, shape),
            "beta_time_coeff": rng.normal(0.0, 0.5, shape)}


def _close(a, b, tol=1e-12):
    """Nested dicts and lists of numbers, equal within ``tol`` relative."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k], tol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, tol)
    elif isinstance(a, (bool, str, np.bool_)) or a is None:
        assert a == b
    else:
        assert abs(float(a) - float(b)) <= tol * max(1.0, abs(float(b)))


@pytest.mark.parametrize("shape", [(28, 28), (3, 32, 32)])
def test_cfl_evolution_and_anisotropy_match_jax(shape):
    f = _fields(np.random.default_rng(1), shape)
    kw = dict(dt=0.01, dx=1.0, dy=0.5)
    _close(pana.cfl_report(*f.values(), num_steps=10, **kw),
           jana.cfl_report(*f.values(), num_steps=10, **kw))
    _close(pana.coefficient_time_evolution(*f.values(), dt=0.01,
                                           num_steps=10),
           jana.coefficient_time_evolution(*f.values(), dt=0.01,
                                           num_steps=10))
    _close(pana.anisotropy_analysis(f["alpha_base"], f["beta_base"],
                                    dx=1.0, dy=0.5),
           jana.anisotropy_analysis(f["alpha_base"], f["beta_base"],
                                    dx=1.0, dy=0.5))
    m = np.random.default_rng(2).normal(size=(3, 3))
    assert pana.coupling_strength(m) == jana.coupling_strength(m)


def test_evaluation_summary_and_operator_spectrum_match_jax():
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 10, 200)
    preds = np.where(rng.random(200) < 0.6, labels, rng.integers(0, 10, 200))
    names = [f"c{i}" for i in range(10)]
    _close(pana.evaluation_summary(labels, preds, 10, names),
           jana.evaluation_summary(labels, preds, 10, names))
    mat = rng.normal(size=(50, 50)).astype(np.float32) / 10
    _close(pana.operator_spectrum(torch.from_numpy(mat), top_k=5),
           jana.operator_spectrum(mat, top_k=5))


@pytest.fixture(scope="module")
def gray_weights():
    """JAX weights of mnist and fashion_mnist with trained-looking fields,
    and JAX's spectra of each model."""
    from cnn_pde_tpu.models import FashionClassifier, MNISTClassifier

    out = {}
    for name, cls in (("mnist", MNISTClassifier),
                      ("fashion_mnist", FashionClassifier)):
        model = cls()
        params, state = jax.tree_util.tree_map(
            np.asarray, jax.jit(model.init)(jax.random.PRNGKey(2)))
        params = dict(params, diff={
            k: v.astype(np.float32) for k, v in
            _fields(np.random.default_rng(4), (28, 28)).items()})
        spectra = jana.model_evolution_spectra(model, params, state,
                                               (1, 28, 28))
        out[name] = (state_dict_from_jax(params, state, name), spectra)
    return out


def _abs_top(spec):
    return sorted(abs(complex(*e)) for e in spec["top_eigenvalues"])


@pytest.mark.parametrize("name", ["mnist", "fashion_mnist"])
@pytest.mark.parametrize("fused", [False, True])
def test_model_evolution_spectra_match_jax(gray_weights, name, fused):
    weights, ref = gray_weights[name]
    model = build_model(name, device="cpu", fused_inference=fused)
    model.load_state_dict(weights, strict=True)
    model.train()  # the analysis runs the eval forward and restores this
    spectra = pana.model_evolution_spectra(model, (1, 28, 28))
    assert model.training
    mats = [m for _, m in pana.evolution_matrices(model, (1, 28, 28))]
    assert [c for c, _ in spectra] == [c for c, _ in ref] == [
        "GrayscaleDiffusion"]
    assert mats[0].shape == (784, 784) and mats[0].dtype == torch.float32
    got, want = spectra[0][1], ref[0][1]
    assert got["dim"] == want["dim"] == 784
    assert got["stable"] == want["stable"]
    for key in ("spectral_radius", "sigma_max", "sigma_min",
                "non_normality"):
        assert abs(got[key] - want[key]) <= SPEC_TOL * abs(want[key]), key
    np.testing.assert_allclose(_abs_top(got), _abs_top(want), rtol=SPEC_TOL,
                               atol=0)
    # one layer alone, and the max_dim gate (the layer is skipped, or a
    # layer refused)
    alone = pana.evolution_spectrum(model.diff, (1, 28, 28))
    assert alone["spectral_radius"] == got["spectral_radius"]
    assert pana.model_evolution_spectra(model, (1, 28, 28),
                                        max_dim=783) == []
    with pytest.raises(ValueError, match="exceeds max_dim"):
        pana.evolution_spectrum(model.diff, (1, 28, 28), max_dim=783)


@pytest.fixture(scope="module")
def analyze_runs(tmp_path_factory):
    """The analyze CLI on the synthetic fixture, three presets at once:
    {preset: (completed process, output dir)}."""
    runs = {"mnist": ["--spectrum"], "svhn": [], "fashion_mnist": []}
    procs = {}
    for preset, extra in runs.items():
        out = tmp_path_factory.mktemp(preset)
        procs[preset] = (subprocess.Popen(
            [sys.executable, "-m", "cnn_pde_tpu_torch.analyze", "--preset",
             preset, "--synthetic", "--output-dir", str(out), "--device",
             "cpu", *extra], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, OMP_NUM_THREADS="2")), out)
    done = {}
    for preset, (proc, out) in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        done[preset] = (proc.returncode, stdout, stderr, out)
    return done


def test_analyze_cli_mnist_spectrum(analyze_runs):
    rc, stdout, stderr, out = analyze_runs["mnist"]
    assert rc == 0, stderr[-2000:]
    for line in ("Test Accuracy:", "CFL:", "Anisotropy ratio:",
                 "spectral radius"):
        assert line in stdout
    for suffix in ("confusion.png", "per_class_acc.png", "coefficients.png",
                   "predictions.png", "panel.png", "report.json"):
        path = out / f"mnist_{suffix}"
        assert path.exists() and path.stat().st_size > 0, suffix
    report = json.loads((out / "mnist_report.json").read_text())
    assert set(report) == {"accuracy", "per_class_accuracy", "cfl",
                           "anisotropy", "evolution_spectra",
                           "evolution_spectrum"}
    spec = report["evolution_spectrum"]
    assert spec["dim"] == 784 and spec["stable"]
    # Neumann boundaries: the constant mode is conserved, so the implicit
    # diffusion's spectral radius is 1 (to float32 composition)
    assert abs(spec["spectral_radius"] - 1.0) < 1e-3
    assert report["evolution_spectra"][0]["layer"] == "GrayscaleDiffusion"


def test_analyze_cli_svhn_and_fashion_panels(analyze_runs):
    rc, _, stderr, out = analyze_runs["svhn"]
    assert rc == 0, stderr[-2000:]
    for suffix in ("confusion.png", "per_class_acc.png", "panel.png",
                   "predictions.png", "report.json"):
        path = out / f"svhn_{suffix}"
        assert path.exists() and path.stat().st_size > 0, suffix
    report = json.loads((out / "svhn_report.json").read_text())
    assert set(report) == {"accuracy", "per_class_accuracy"}
    assert len(report["per_class_accuracy"]) == 10
    rc, stdout, stderr, out = analyze_runs["fashion_mnist"]
    assert rc == 0, stderr[-2000:]
    assert "CFL:" in stdout and "spectral radius" not in stdout
    for suffix in ("per_class_acc.png", "panel.png", "coefficients.png"):
        path = out / f"fashion_mnist_{suffix}"
        assert path.exists() and path.stat().st_size > 0, suffix


def test_analyze_cli_refuses_cpu_without_device_flag():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "-m", "cnn_pde_tpu_torch.analyze",
                           "--preset", "mnist", "--synthetic"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "--device cpu" in proc.stderr


def test_viz_panels(tmp_path):
    from cnn_pde_tpu_torch.utils import viz

    rng = np.random.default_rng(5)
    imgs = rng.random((8, 3, 32, 32)).astype(np.float32)
    labels, preds = np.arange(8) % 10, np.array([0, 1, 2, 0, 4, 5, 6, 1])
    alpha, beta = rng.random((3, 32, 32)), rng.random((3, 32, 32))
    paths = [
        viz.save_prediction_panel(str(tmp_path / "p.png"), imgs, labels,
                                  preds, diffused=imgs),
        viz.save_coefficient_heatmaps(str(tmp_path / "c.png"),
                                      [("a", alpha[0]), ("b", beta[0])]),
        viz.save_confusion_matrix(str(tmp_path / "m.png"),
                                  np.eye(10, dtype=int) * 5),
        viz.save_training_curves(str(tmp_path / "t.png"), [2.0, 1.0],
                                 [30, 60]),
        viz.save_per_class_accuracy_bars(str(tmp_path / "b.png"),
                                         np.linspace(0, 100, 10)),
        viz.save_mnist_panel(str(tmp_path / "mn.png"), imgs[:, :1], labels,
                             preds, imgs[:, :1], alpha[0], beta[0], alpha[1],
                             beta[1]),
        viz.save_fashion_panel(str(tmp_path / "f.png"), imgs[:, :1], labels,
                               preds, imgs[:, :1], alpha[0], beta[0],
                               alpha[1], beta[1]),
        viz.save_svhn_panel(str(tmp_path / "s.png"), imgs, labels, preds,
                            imgs, alpha, beta, rng.random((3, 3)),
                            rng.random(3), np.eye(10, dtype=int) * 5,
                            np.linspace(0, 100, 10))]
    for p in paths:
        assert os.path.getsize(p) > 1000


def test_sweep_harness(capsys):
    def run_one(cfg):
        if cfg.get("boom"):
            raise RuntimeError("kaboom")
        return 42.0

    res = compare_configs(run_one, [{"a": 1}, {"boom": True}])
    assert [r["accuracy"] for r in res] == [42.0, 0.0]
    assert "RuntimeError: kaboom" in capsys.readouterr().err
    assert "42.00%" in format_table(res)
    # the reference's dx/dy sweep, one step a configuration on the CPU
    res = compare_spatial_discretizations(epochs=1, steps=1, device="cpu",
                                          batch_size=16)
    assert [r["config"] for r in res] == [
        {"dx": 1.0, "dy": 1.0}, {"dx": 1.0, "dy": 0.5},
        {"dx": 0.5, "dy": 1.0}, {"dx": 2.0, "dy": 1.0}]
    assert all(0.0 <= r["accuracy"] <= 100.0 for r in res)
    assert "traceback" not in capsys.readouterr().err.lower()
    assert "Coarse X resolution" in format_table(res)
