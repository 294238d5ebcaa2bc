"""Classification metrics from the confusion matrix, without sklearn.

Copy of `leaffliction_tpu/utils/metrics.py`: the key set of the reference's
sklearn metrics (accuracy, macro/weighted f1, precision and recall, binary_*
for two classes, per-class `f1_<label>`, `precision_<label>`,
`recall_<label>`), with sklearn's zero_division=0 convention.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def confusion_counts(y_true: Sequence[int], y_pred: Sequence[int],
                     num_classes: int) -> np.ndarray:
    """cm[true][pred] counts."""
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (np.asarray(y_true, np.int64),
                   np.asarray(y_pred, np.int64)), 1)
    return cm


def _prf_from_cm(cm: np.ndarray):
    tp = np.diag(cm).astype(np.float64)
    pred_n = cm.sum(axis=0).astype(np.float64)
    true_n = cm.sum(axis=1).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_n > 0, tp / np.maximum(pred_n, 1), 0.0)
        recall = np.where(true_n > 0, tp / np.maximum(true_n, 1), 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0,
                      2 * precision * recall / np.maximum(denom, 1e-12), 0.0)
    return precision, recall, f1, true_n


def compute_classification_metrics(y_true: Sequence[int],
                                   y_pred: Sequence[int], labels: List[str]
                                   ) -> Dict[str, float]:
    num_classes = len(labels)
    cm = confusion_counts(y_true, y_pred, num_classes)
    precision, recall, f1, support = _prf_from_cm(cm)
    total = cm.sum()
    weights = support / max(total, 1)

    metrics: Dict[str, float] = {
        "accuracy": float(np.trace(cm) / max(total, 1)),
        "macro_f1": float(f1.mean()),
        "weighted_f1": float((f1 * weights).sum()),
        "macro_precision": float(precision.mean()),
        "weighted_precision": float((precision * weights).sum()),
        "macro_recall": float(recall.mean()),
        "weighted_recall": float((recall * weights).sum()),
    }
    if num_classes == 2:
        # sklearn 'binary' = stats of the positive class (index 1)
        metrics["binary_f1"] = float(f1[1])
        metrics["binary_precision"] = float(precision[1])
        metrics["binary_recall"] = float(recall[1])
    for i, label in enumerate(labels):
        metrics[f"f1_{label}"] = float(f1[i])
        metrics[f"precision_{label}"] = float(precision[i])
        metrics[f"recall_{label}"] = float(recall[i])
    return metrics
