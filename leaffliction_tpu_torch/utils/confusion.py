"""Confusion-matrix artifacts: JSON (`{"matrix", "labels"}`) and a Blues
heatmap PNG where matplotlib is installed.

Copy of `leaffliction_tpu/utils/confusion.py`.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from leaffliction_tpu_torch.core.logging import get_logger
from leaffliction_tpu_torch.utils.metrics import confusion_counts

LOGGER = get_logger(__name__)


def save_confusion_json(cm: Sequence[Sequence[int]], labels: List[str],
                        out_path: Path) -> None:
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    matrix = [[int(v) for v in row] for row in cm]
    with out_path.open("w", encoding="utf-8") as f:
        json.dump({"matrix": matrix, "labels": list(labels)}, f, indent=2)


def plot_confusion_png(cm, labels: List[str], out_path: Path) -> None:
    """The row-normalised matrix as a heatmap."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as exc:
        LOGGER.warning("matplotlib unavailable, skipping confusion PNG: %s",
                       exc)
        return

    num_classes = len(labels)
    cm_np = np.asarray(cm, float)
    cm_plot = cm_np / np.maximum(cm_np.sum(axis=1, keepdims=True), 1.0)

    fig, ax = plt.subplots(figsize=(8, 6), dpi=150)
    im = ax.imshow(cm_plot, cmap="Blues")
    plt.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
    ax.set_xticks(range(num_classes))
    ax.set_yticks(range(num_classes))
    ax.set_xticklabels(labels, rotation=45, ha="right")
    ax.set_yticklabels(labels)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    ax.set_title("Confusion Matrix (normalized)")
    for i in range(num_classes):
        for j in range(num_classes):
            ax.text(j, i, f"{cm_plot[i, j]:.2f}", ha="center", va="center",
                    color="black", fontsize=8)
    fig.tight_layout()
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)


def export_confusion(y_true, y_pred, labels: List[str], out_dir: Path
                     ) -> Tuple[Path, Path]:
    """Compute and write confusion_matrix.{json,png}; returns the paths."""
    out_dir = Path(out_dir)
    cm = confusion_counts(y_true, y_pred, len(labels))
    json_path = out_dir / "confusion_matrix.json"
    png_path = out_dir / "confusion_matrix.png"
    save_confusion_json(cm.tolist(), labels, json_path)
    plot_confusion_png(cm, labels, png_path)
    return json_path, png_path
