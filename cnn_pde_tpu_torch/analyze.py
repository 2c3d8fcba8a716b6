"""Evaluation and analysis CLI of the port — counterpart of
``cnn_pde_tpu/analyze.py``.

    python -m cnn_pde_tpu_torch.analyze --preset mnist [--checkpoint-dir ckpt]
        [--synthetic] [--output-dir reports] [--spectrum] [--device cuda]

Runs on the card unless ``--device cpu`` is given; without CUDA it exits
non-zero rather than carry on on the CPU.  ``--checkpoint-dir`` restores
the 'best' checkpoint the train CLI wrote there.  Prints the test
accuracy and the classification report; where the model's PDE layer
carries per-pixel fields, the CFL check, the coefficients' evolution and
the anisotropy ratio; with ``--spectrum`` the exact spectrum of every
PDE layer's trained evolution (``utils/analysis.py::
model_evolution_spectra``: its matrix built by the layer's kernels on the
card).  Writes ``<preset>_{confusion,per_class_acc,coefficients,
predictions,panel}.png`` (those that apply) and ``<preset>_report.json``
under ``--output-dir``, with the JAX report's keys.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

# display class names per dataset (digit and object datasets use index
# labels)
_CLASS_NAMES = {
    "fashion_mnist": ["T-shirt/top", "Trouser", "Pullover", "Dress", "Coat",
                      "Sandal", "Shirt", "Sneaker", "Bag", "Ankle boot"],
    "emotion": ["angry", "disgust", "fear", "happy", "sad", "surprise",
                "neutral"],
    "cifar10": ["plane", "car", "bird", "cat", "deer", "dog", "frog",
                "horse", "ship", "truck"],
}


def _final_fields(fields, t_final):
    """The clamped α and β of a PDE layer's fields at ``t_final``."""
    alpha = np.maximum(fields["alpha_base"]
                       + fields["alpha_time_coeff"] * t_final, 1e-6)
    beta = np.maximum(fields["beta_base"]
                      + fields["beta_time_coeff"] * t_final, 1e-6)
    return alpha, beta


def main(argv=None):
    ap = argparse.ArgumentParser(description="cnn_pde_tpu_torch analyzer")
    ap.add_argument("--preset", required=True)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--data-dir", default="./data")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--output-dir", default="reports")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spectrum", action="store_true",
                    help="exact stability analysis: the eigen and singular "
                         "spectrum of each PDE layer's composed evolution "
                         "(utils.analysis.model_evolution_spectra)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default), 'cuda:N' or 'cpu'")
    args = ap.parse_args(argv)

    import torch

    from .data import load_dataset, synthetic_dataset
    from .data.real import NORMALIZATION
    from .models import build_model
    from .presets import get_preset
    from .train import TrainConfig, Trainer
    from .train.checkpoint import restore_state
    from .train.metrics import format_report
    from .utils.analysis import (anisotropy_analysis, cfl_report,
                                 coefficient_time_evolution,
                                 evaluation_summary, model_evolution_spectra)
    from .utils.viz import (save_coefficient_heatmaps, save_confusion_matrix,
                            save_fashion_panel, save_mnist_panel,
                            save_per_class_accuracy_bars,
                            save_prediction_panel, save_svhn_panel)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("cnn_pde_tpu_torch.analyze: no CUDA device is available; "
                 "pass --device cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        sys.exit(f"cnn_pde_tpu_torch.analyze: unsupported device {device}")

    preset = get_preset(args.preset)
    values = preset["train"]
    dataset = (synthetic_dataset(preset["dataset"]) if args.synthetic else
               load_dataset(preset["dataset"], args.data_dir,
                            synthetic_ok=True))
    model = build_model(preset["model"], device=device,
                        generator=torch.Generator().manual_seed(args.seed),
                        **preset["model_kwargs"])
    trainer = Trainer(model, TrainConfig.from_preset(values,
                                                     seed=args.seed), values)
    state = trainer.init_state(dataset.steps_for_batch(values["batch_size"]))
    if args.checkpoint_dir:
        restore_state(state, args.checkpoint_dir, tag="best")
        print(f"Restored best checkpoint (step {state.step})")

    ev = trainer.evaluate(state, dataset)
    summary = evaluation_summary(ev["labels"], ev["predictions"],
                                 dataset.num_classes)
    print(f"Test Accuracy: {summary['accuracy']:.2f}%")
    print(format_report(summary["report"]))

    os.makedirs(args.output_dir, exist_ok=True)
    out = {"accuracy": summary["accuracy"]}
    name = preset["name"]

    def path(suffix):
        return os.path.join(args.output_dir, f"{name}_{suffix}")

    save_confusion_matrix(path("confusion.png"), summary["confusion_matrix"])
    cm = np.asarray(summary["confusion_matrix"], dtype=float)
    per_class = 100.0 * np.diag(cm) / np.maximum(cm.sum(axis=1), 1.0)
    class_names = _CLASS_NAMES.get(preset["dataset"])
    save_per_class_accuracy_bars(path("per_class_acc.png"), per_class,
                                 class_names)
    out["per_class_accuracy"] = [round(float(a), 2) for a in per_class]

    # the PDE layer's analysis where it carries per-pixel fields (the
    # params the JAX models keep under "diff")
    pde = getattr(model, "diff", None)
    fields = None
    if pde is not None:
        fields = {k: v.detach().cpu().numpy()
                  for k, v in pde.named_parameters()}
    if (fields is not None and "alpha_base" in fields
            and hasattr(pde, "dt") and hasattr(pde, "num_steps")
            and fields["alpha_base"].ndim == 2):
        dt, steps = pde.dt, pde.num_steps
        dxv = getattr(pde, "dx", 1.0)
        dyv = getattr(pde, "dy", 1.0)
        cfl = cfl_report(fields["alpha_base"], fields["alpha_time_coeff"],
                         fields["beta_base"], fields["beta_time_coeff"],
                         dt=dt, dx=dxv, dy=dyv, num_steps=steps)
        print(f"CFL: x={cfl['cfl_x']:.4f} {'✓' if cfl['stable_x'] else '⚠'} "
              f"y={cfl['cfl_y']:.4f} {'✓' if cfl['stable_y'] else '⚠'}")
        evo = coefficient_time_evolution(
            fields["alpha_base"], fields["alpha_time_coeff"],
            fields["beta_base"], fields["beta_time_coeff"],
            dt=dt, num_steps=steps)
        for row in evo:
            print(f"t={row['t']:.3f}: α={row['alpha_mean']:.3f}"
                  f"±{row['alpha_std']:.3f} β={row['beta_mean']:.3f}"
                  f"±{row['beta_std']:.3f}")
        alpha_f, beta_f = _final_fields(fields, steps * dt)
        aniso = anisotropy_analysis(alpha_f, beta_f, dx=dxv, dy=dyv)
        print(f"Anisotropy ratio: {aniso['anisotropy_ratio']:.3f}")
        out["cfl"] = cfl
        out["anisotropy"] = aniso
        save_coefficient_heatmaps(
            path("coefficients.png"),
            [("Final Alpha", alpha_f), ("Final Beta", beta_f),
             ("Alpha Time Coeff", fields["alpha_time_coeff"]),
             ("Beta Time Coeff", fields["beta_time_coeff"])])

    # the exact spectrum of every trained evolution operator (opt-in: dense
    # (D, D) eigen decompositions on the host, D = C·H·W of each layer's
    # input; the matrices built on the model's device)
    if args.spectrum:
        spectra = model_evolution_spectra(model,
                                          dataset.test_images.shape[1:])
        if not spectra:
            print("spectrum: no linearizable PDE layer ≤ max_dim "
                  "(tiny_imagenet's D=12288 operator is skipped by size)")
        for i, (cls, spec) in enumerate(spectra):
            lam = spec["top_eigenvalues"][0]
            print(f"Evolution operator {i} ({cls}, D={spec['dim']}): "
                  f"spectral radius {spec['spectral_radius']:.6f} "
                  f"{'✓ non-amplifying' if spec['stable'] else '⚠ AMPLIFYING'}"
                  f", σ_max={spec['sigma_max']:.4f}, "
                  f"λ₁={lam[0]:.4f}{lam[1]:+.4f}i")
        out["evolution_spectra"] = [
            {"layer": cls, **spec} for cls, spec in spectra]
        if spectra:
            out["evolution_spectrum"] = spectra[0][1]

    # the prediction panel, with the after-PDE images of the model's own
    # PDE layer in eval
    n_vis = min(8, dataset.test_images.shape[0])
    images = dataset.test_images[:n_vis]
    vis_labels = dataset.test_labels[:n_vis]
    norm_images = next(dataset.eval_batches(n_vis))[0]
    model.eval()
    with torch.no_grad():
        x = torch.as_tensor(norm_images).to(device)
        preds = model(x).argmax(dim=-1).cpu().numpy()
        diffused = None
        if pde is not None:
            diffused = pde(x).cpu().numpy()
    if diffused is not None:
        # denormalised for display, as the reference does
        mean, std = NORMALIZATION.get(preset["dataset"], (None, None))
        if mean is not None:
            shape = (1, -1, 1, 1)
            diffused = np.clip(
                diffused * np.reshape(std, shape) + np.reshape(mean, shape),
                0.0, 1.0)
    save_prediction_panel(path("predictions.png"), images, vis_labels, preds,
                          diffused=diffused)

    # the datasets' mega-panels
    if (diffused is not None and fields is not None
            and "alpha_time_coeff" in fields):
        alpha_f, beta_f = _final_fields(fields, pde.num_steps * pde.dt)
        if preset["dataset"] == "mnist" and alpha_f.ndim == 2:
            save_mnist_panel(
                path("panel.png"), images, vis_labels, preds, diffused,
                alpha_f, beta_f, fields["alpha_time_coeff"],
                fields["beta_time_coeff"], dx=getattr(pde, "dx", 1.0),
                dy=getattr(pde, "dy", 1.0))
        if preset["dataset"] == "fashion_mnist" and alpha_f.ndim == 2:
            save_fashion_panel(
                path("panel.png"), images, vis_labels, preds, diffused,
                alpha_f, beta_f, fields["alpha_time_coeff"],
                fields["beta_time_coeff"], class_names=class_names)
        if "channel_coupling" in fields and alpha_f.ndim == 3:
            save_svhn_panel(
                path("panel.png"), images, vis_labels, preds, diffused,
                alpha_f, beta_f, fields["channel_coupling"],
                fields["alpha_time_coeff"].mean(axis=(1, 2)),
                summary["confusion_matrix"], per_class,
                class_names=class_names)

    with open(path("report.json"), "w") as f:
        json.dump(out, f, indent=2, default=float)
    print(f"Artifacts written to {args.output_dir}/")


if __name__ == "__main__":
    main()
