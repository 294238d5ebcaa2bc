"""Classification metrics from the confusion matrix, without sklearn.

Copy of `leaffliction_tpu/utils/metrics.py`: the key set of the reference's
sklearn metrics (accuracy, macro/weighted f1, precision and recall, binary_*
for two classes, per-class `f1_<label>`, `precision_<label>`,
`recall_<label>`), with sklearn's zero_division=0 convention, and the
writers: `metrics.json`, the log summary, and both together
(`compute_evaluation_metrics`).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
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


def save_metrics_json(metrics: Dict[str, float], out_path: Path) -> None:
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with out_path.open("w", encoding="utf-8") as f:
        json.dump(metrics, f, indent=2)


def log_metrics_summary(metrics: Dict[str, float], labels: List[str]) -> None:
    """Key-metrics log block (reference `metrics.py:103-121`)."""
    logger = logging.getLogger(__name__)
    logger.info("Classification Metrics Summary:")
    logger.info("  Accuracy: %.4f", metrics["accuracy"])
    logger.info("  Macro F1: %.4f", metrics["macro_f1"])
    logger.info("  Weighted F1: %.4f", metrics["weighted_f1"])
    for label in labels:
        key = f"f1_{label}"
        if key in metrics:
            logger.info("  %s: %.4f", label, metrics[key])


def compute_evaluation_metrics(y_true: Sequence[int], y_pred: Sequence[int],
                               labels: List[str], out_dir: Path
                               ) -> Dict[str, float]:
    """Compute, save (`metrics.json`) and log the metrics (reference
    `metrics.py:123-155`, from predictions in place of a Keras model and
    generator)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    metrics = compute_classification_metrics(y_true, y_pred, labels)
    save_metrics_json(metrics, out_dir / "metrics.json")
    log_metrics_summary(metrics, labels)
    return metrics
