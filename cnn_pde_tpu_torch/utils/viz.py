"""Visualization panels — port of ``cnn_pde_tpu/utils/viz.py``: headless
matplotlib (Agg) versions of the reference's figures, written to PNG
files (numpy arrays in, no tensor): the sample grid with predictions and
after-PDE images, coefficient-field heatmaps, the confusion matrix,
per-class accuracy bars, training curves and the three datasets'
mega-panels.  matplotlib is imported at the first panel, not with the
module.
"""

from __future__ import annotations

import numpy as np

__all__ = ["save_prediction_panel", "save_coefficient_heatmaps",
           "save_confusion_matrix", "save_training_curves",
           "save_per_class_accuracy_bars", "save_mnist_panel",
           "save_fashion_panel", "save_svhn_panel"]


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_prediction_panel(path, images, labels, predictions, diffused=None,
                          n=6, class_names=None):
    """Rows: original+true, original+pred (green/red), after-PDE."""
    plt = _plt()
    n = min(n, images.shape[0])
    rows = 3 if diffused is not None else 2
    fig, axes = plt.subplots(rows, n, figsize=(2.2 * n, 2.2 * rows))
    axes = np.atleast_2d(axes)
    name = (lambda i: class_names[i]) if class_names else str
    for i in range(n):
        img = np.asarray(images[i]).transpose(1, 2, 0).squeeze()
        axes[0, i].imshow(img, cmap="gray")
        axes[0, i].set_title(f"True: {name(int(labels[i]))}", fontsize=8)
        axes[1, i].imshow(img, cmap="gray")
        ok = int(predictions[i]) == int(labels[i])
        axes[1, i].set_title(f"Pred: {name(int(predictions[i]))}",
                             color="green" if ok else "red", fontsize=8)
        if diffused is not None:
            dimg = np.asarray(diffused[i]).transpose(1, 2, 0).squeeze()
            axes[2, i].imshow(dimg, cmap="gray")
            axes[2, i].set_title("After PDE", fontsize=8)
        for r in range(rows):
            axes[r, i].axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def save_coefficient_heatmaps(path, named_fields):
    """named_fields: list of (title, 2-D array) — RdBu_r heatmaps with
    colorbars (mnist_test.py:426-440)."""
    plt = _plt()
    n = len(named_fields)
    fig, axes = plt.subplots(1, n, figsize=(3.2 * n, 3.2))
    axes = np.atleast_1d(axes)
    for ax, (title, field) in zip(axes, named_fields):
        im = ax.imshow(np.asarray(field), cmap="RdBu_r")
        fig.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
        ax.set_title(title, fontsize=9)
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def save_confusion_matrix(path, cm, class_names=None):
    plt = _plt()
    cm = np.asarray(cm)
    fig, ax = plt.subplots(figsize=(8, 6))
    im = ax.imshow(cm, cmap="Blues")
    fig.colorbar(im, ax=ax)
    ticks = class_names or [str(i) for i in range(cm.shape[0])]
    if len(ticks) <= 20:
        ax.set_xticks(range(len(ticks)), ticks, rotation=45, fontsize=7)
        ax.set_yticks(range(len(ticks)), ticks, fontsize=7)
        for i in range(cm.shape[0]):
            for j in range(cm.shape[1]):
                ax.text(j, i, str(cm[i, j]), ha="center", va="center",
                        fontsize=6)
    ax.set_xlabel("Predicted Label")
    ax.set_ylabel("True Label")
    ax.set_title("Confusion Matrix")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def save_per_class_accuracy_bars(path, per_class_acc, class_names=None,
                                 title="Per-Class Accuracy"):
    """Viridis-colored per-class accuracy bars with value labels
    (SVHN.py:563-578)."""
    plt = _plt()
    acc = np.asarray(per_class_acc, dtype=float)
    n = acc.shape[0]
    fig, ax = plt.subplots(figsize=(max(6, 0.8 * n), 4.5))
    bars = ax.bar(range(n), acc, color=plt.cm.viridis(acc / 100.0))
    ticks = class_names or [str(i) for i in range(n)]
    ax.set_xticks(range(n), ticks,
                  rotation=45 if max(len(t) for t in ticks) > 3 else 0,
                  fontsize=8)
    ax.set_xlabel("Class")
    ax.set_ylabel("Accuracy (%)")
    ax.set_title(title)
    ax.set_ylim(0, 100)
    for bar, h in zip(bars, acc):
        ax.text(bar.get_x() + bar.get_width() / 2.0, h + 1, f"{h:.1f}%",
                ha="center", va="bottom", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def _sample_rows(plt, n_cols, images, labels, predictions, diffused, name,
                 sub):
    """Three 8-wide sample rows shared by the A2/A3 panels: original+true,
    original+pred (green/red), after-PDE."""
    k = min(n_cols, images.shape[0])
    for i in range(k):
        img = np.asarray(images[i]).transpose(1, 2, 0).squeeze()
        ax = sub(0, i)
        ax.imshow(np.clip(img, 0, 1), cmap="gray")
        ax.axis("off")
        ax.set_title(f"True: {name(int(labels[i]))}", fontsize=8)
        ax = sub(1, i)
        ax.imshow(np.clip(img, 0, 1), cmap="gray")
        ax.axis("off")
        ok = int(predictions[i]) == int(labels[i])
        ax.set_title(f"Pred: {name(int(predictions[i]))}",
                     color="green" if ok else "red", fontsize=8)
        ax = sub(2, i)
        dimg = np.asarray(diffused[i]).transpose(1, 2, 0).squeeze()
        ax.imshow(np.clip(dimg, 0, 1), cmap="gray")
        ax.axis("off")
        ax.set_title("After PDE", fontsize=8)


def save_mnist_panel(path, images, labels, predictions, diffused,
                     alpha_final, beta_final, alpha_time, beta_time,
                     dx=1.0, dy=1.0):
    """The A1 6×6 mega-panel (mnist_test.py:400-444): three 6-wide sample
    rows (original+true / original+pred / after-PDE) plus the six parameter
    matrices the reference shows at grid positions 19/20, 25/26, 31/32 —
    final α (annotated with dx), final β (dy), effective diffusion rates
    α/dx² and β/dy², and the two time-coefficient fields."""
    plt = _plt()
    fig = plt.figure(figsize=(20, 15))
    gs = fig.add_gridspec(6, 6)
    _sample_rows(plt, 6, images, labels, predictions, diffused, str,
                 lambda r, c: fig.add_subplot(gs[r, c]))
    alpha_final = np.asarray(alpha_final)
    beta_final = np.asarray(beta_final)
    fields = [(alpha_final, f"Final Alpha Matrix\n(dx={dx})", (3, 0)),
              (beta_final, f"Final Beta Matrix\n(dy={dy})", (3, 1)),
              (alpha_final / dx**2, "Effective Diffusion X", (4, 0)),
              (beta_final / dy**2, "Effective Diffusion Y", (4, 1)),
              (np.asarray(alpha_time), "Alpha Time Coeff", (5, 0)),
              (np.asarray(beta_time), "Beta Time Coeff", (5, 1))]
    for field, title, (r, c) in fields:
        ax = fig.add_subplot(gs[r, c])
        im = ax.imshow(field, cmap="RdBu_r")
        fig.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
        ax.set_title(title, fontsize=9)
        ax.axis("off")
    fig.suptitle(f"Enhanced PDE Diffusion: dx={dx}, dy={dy}", fontsize=16)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def save_fashion_panel(path, images, labels, predictions, diffused,
                       alpha_final, beta_final, alpha_time, beta_time,
                       class_names=None):
    """The A2 6×8 mega-panel (fashion_mnist.py:396-441): three 8-wide sample
    rows (original / prediction / after-PDE) plus the four coefficient-field
    heatmaps (final α, final β, α/β time coefficients)."""
    plt = _plt()
    fig = plt.figure(figsize=(20, 14))
    gs = fig.add_gridspec(6, 8)
    name = (lambda i: class_names[i]) if class_names else str
    _sample_rows(plt, 8, images, labels, predictions, diffused, name,
                 lambda r, c: fig.add_subplot(gs[r, c]))
    # positions 25/26/33/34 in the reference's 6x8 numbering → (3,0)(3,1)(4,0)(4,1)
    fields = [(alpha_final, "Final Alpha Matrix", (3, 0)),
              (beta_final, "Final Beta Matrix", (3, 1)),
              (alpha_time, "Alpha Time Coeff", (4, 0)),
              (beta_time, "Beta Time Coeff", (4, 1))]
    for field, title, (r, c) in fields:
        ax = fig.add_subplot(gs[r, c])
        im = ax.imshow(np.asarray(field), cmap="RdBu_r")
        fig.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
        ax.set_title(title, fontsize=10)
        ax.axis("off")
    fig.suptitle("PDE Diffusion Network on Fashion-MNIST\n"
                 "Time-Dependent Matrix Coefficients", fontsize=16)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def save_svhn_panel(path, images, labels, predictions, diffused,
                    alpha_final, beta_final, coupling, time_coeff_by_channel,
                    confusion, per_class_acc, class_names=None):
    """The A3 7×8 mega-panel (SVHN.py:483-580): three 8-wide sample rows,
    per-channel final α/β heatmaps, the channel-coupling matrix heatmap,
    mean time-coefficient bars per channel, the confusion matrix and the
    per-class accuracy bars."""
    plt = _plt()
    fig = plt.figure(figsize=(24, 20))
    gs = fig.add_gridspec(7, 8)
    name = (lambda i: class_names[i]) if class_names else str
    _sample_rows(plt, 8, images, labels, predictions, diffused, name,
                 lambda r, c: fig.add_subplot(gs[r, c]))

    alpha_final = np.asarray(alpha_final)
    beta_final = np.asarray(beta_final)
    for c in range(3):  # α ch0-2 then β ch0-2 on row 4 (ref positions 25-30)
        ax = fig.add_subplot(gs[3, c])
        im = ax.imshow(alpha_final[c], cmap="RdBu_r")
        fig.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
        ax.set_title(f"α Matrix Ch{c}", fontsize=10)
        ax.axis("off")
        ax = fig.add_subplot(gs[3, 3 + c])
        im = ax.imshow(beta_final[c], cmap="RdBu_r")
        fig.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
        ax.set_title(f"β Matrix Ch{c}", fontsize=10)
        ax.axis("off")

    ax = fig.add_subplot(gs[3, 6])  # ref position 31
    im = ax.imshow(np.asarray(coupling), cmap="RdBu_r")
    fig.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
    ax.set_title("Channel Coupling", fontsize=10)

    ax = fig.add_subplot(gs[3, 7])  # ref position 32
    ax.bar(["R", "G", "B"], np.asarray(time_coeff_by_channel),
           color=["red", "green", "blue"], alpha=0.7)
    ax.set_title("Time Coeffs by Channel", fontsize=10)

    cm = np.asarray(confusion)
    ax = fig.add_subplot(gs[4:7, 0:4])  # bottom: large confusion matrix
    im = ax.imshow(cm, interpolation="nearest", cmap="Blues")
    fig.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
    ax.set_title("Confusion Matrix", fontsize=14)
    ticks = class_names or [str(i) for i in range(cm.shape[0])]
    ax.set_xticks(range(len(ticks)), ticks, fontsize=8)
    ax.set_yticks(range(len(ticks)), ticks, fontsize=8)
    ax.set_xlabel("Predicted Label", fontsize=12)
    ax.set_ylabel("True Label", fontsize=12)
    thresh = cm.max() / 2.0
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, str(int(cm[i, j])), ha="center", va="center",
                    color="white" if cm[i, j] > thresh else "black",
                    fontsize=8)

    acc = np.asarray(per_class_acc, dtype=float)
    ax = fig.add_subplot(gs[4:7, 4:8])  # bottom: per-class accuracy bars
    bars = ax.bar(range(len(acc)), acc, color=plt.cm.viridis(acc / 100.0))
    ax.set_xticks(range(len(acc)), ticks, fontsize=9)
    ax.set_xlabel("Class", fontsize=12)
    ax.set_ylabel("Accuracy (%)", fontsize=12)
    ax.set_title("Per-Class Accuracy", fontsize=14)
    ax.set_ylim(0, 100)
    for bar, h in zip(bars, acc):
        ax.text(bar.get_x() + bar.get_width() / 2.0, h + 1, f"{h:.1f}%",
                ha="center", va="bottom", fontsize=8)

    fig.suptitle("PDE Diffusion Neural Network on SVHN Dataset", fontsize=16)
    fig.tight_layout()
    fig.savefig(path, dpi=90)
    plt.close(fig)
    return path


def save_training_curves(path, losses, accuracies):
    plt = _plt()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 4))
    ax1.plot(losses)
    ax1.set_title("Training Loss")
    ax1.set_xlabel("Epoch")
    ax1.set_ylabel("Loss")
    ax2.plot(accuracies)
    ax2.set_title("Training Accuracy")
    ax2.set_xlabel("Epoch")
    ax2.set_ylabel("Accuracy (%)")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
