"""Evaluation metrics — port of ``cnn_pde_tpu/train/metrics.py``:
per-class accuracy, the confusion matrix and a classification report, in
numpy (the analysis the reference scripts print)."""

from __future__ import annotations

import numpy as np

__all__ = ["confusion_matrix", "per_class_accuracy", "classification_report"]


def confusion_matrix(labels, predictions, num_classes):
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (np.asarray(labels), np.asarray(predictions)), 1)
    return cm


def per_class_accuracy(labels, predictions, num_classes):
    cm = confusion_matrix(labels, predictions, num_classes)
    totals = cm.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = np.where(totals > 0, np.diag(cm) / np.maximum(totals, 1), 0.0)
    return acc


def classification_report(labels, predictions, num_classes, class_names=None):
    """precision/recall/f1/support per class + macro & weighted averages."""
    cm = confusion_matrix(labels, predictions, num_classes)
    support = cm.sum(axis=1)
    tp = np.diag(cm).astype(np.float64)
    pred_totals = cm.sum(axis=0)
    precision = np.where(pred_totals > 0, tp / np.maximum(pred_totals, 1), 0.0)
    recall = np.where(support > 0, tp / np.maximum(support, 1), 0.0)
    denom = precision + recall
    f1 = np.where(denom > 0, 2 * precision * recall / np.maximum(denom, 1e-12), 0.0)
    names = class_names or [str(i) for i in range(num_classes)]
    rows = {
        names[i]: {"precision": float(precision[i]), "recall": float(recall[i]),
                   "f1": float(f1[i]), "support": int(support[i])}
        for i in range(num_classes)
    }
    total = support.sum()
    rows["macro avg"] = {
        "precision": float(precision.mean()), "recall": float(recall.mean()),
        "f1": float(f1.mean()), "support": int(total),
    }
    w = support / max(total, 1)
    rows["weighted avg"] = {
        "precision": float((precision * w).sum()),
        "recall": float((recall * w).sum()),
        "f1": float((f1 * w).sum()), "support": int(total),
    }
    rows["accuracy"] = float(tp.sum() / max(total, 1))
    return rows


def format_report(report, digits=3):
    lines = [f"{'':>14} {'precision':>9} {'recall':>9} {'f1':>9} {'support':>9}"]
    for name, row in report.items():
        if name == "accuracy":
            lines.append(f"{'accuracy':>14} {row:>39.{digits}f}")
            continue
        lines.append(
            f"{name:>14} {row['precision']:>9.{digits}f} "
            f"{row['recall']:>9.{digits}f} {row['f1']:>9.{digits}f} "
            f"{row['support']:>9d}")
    return "\n".join(lines)
