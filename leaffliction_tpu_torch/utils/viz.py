"""Batch-prediction dashboard and the system image viewer.

Copy of `leaffliction_tpu/utils/viz.py`: the batch dashboard (prediction
distribution, confidence histogram, probability heatmap, lowest-confidence
bars and, with evaluation metrics, metric bars) where matplotlib is
installed, and `create_confusion_matrix` from batch results (its JSON
always; its PNG where matplotlib is installed, else skipped with one
warning).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from leaffliction_tpu_torch.core.logging import get_logger

LOGGER = get_logger(__name__)


def open_image_viewer(image_path: Path) -> None:
    """Open the OS image viewer; skipped in headless environments."""
    if os.environ.get("LEAF_NO_VIEWER") or not os.environ.get("DISPLAY", ""):
        if sys.platform.startswith("linux"):
            return
    try:
        if sys.platform == "darwin":
            subprocess.Popen(["open", str(image_path)])
        elif sys.platform.startswith("linux"):
            subprocess.Popen(["xdg-open", str(image_path)])
        elif sys.platform == "win32":
            os.startfile(str(image_path))  # type: ignore[attr-defined]
    except OSError as exc:
        LOGGER.warning("Could not open image viewer: %s", exc)


def create_confusion_matrix(results: List[Dict],
                            output_path: Path) -> Optional[Path]:
    """Confusion matrix from batch prediction results, with ground truth read
    from each image's parent directory name (reference
    `visualization_utils.py:40-88`)."""
    from leaffliction_tpu_torch.utils.confusion import (
        plot_confusion_png,
        save_confusion_json,
    )
    from leaffliction_tpu_torch.utils.metrics import confusion_counts

    if not results:
        LOGGER.warning("No results to create confusion matrix")
        return None
    y_true_names = [Path(str(r["image_path"])).parent.name for r in results]
    y_pred_names = [r["top_prediction"] for r in results]
    labels = sorted(set(y_true_names) | set(y_pred_names))
    idx = {lab: i for i, lab in enumerate(labels)}
    cm = confusion_counts([idx[t] for t in y_true_names],
                          [idx[p] for p in y_pred_names], len(labels))
    output_path = Path(output_path)
    save_confusion_json(cm.tolist(), labels,
                        output_path.with_suffix(".json"))
    plot_confusion_png(cm, labels, output_path)
    return output_path


def create_batch_dashboard(results: List[Dict], output_path: Path,
                           eval_metrics: Optional[Dict[str, float]] = None
                           ) -> Optional[Path]:
    if not results:
        return None
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as exc:
        LOGGER.warning("matplotlib unavailable, skipping dashboard: %s", exc)
        return None

    preds = [r["top_prediction"] for r in results]
    confs = np.asarray([r["confidence"] for r in results])
    classes = sorted(set(preds))

    n_panels = 5 if eval_metrics else 4
    fig, axes = plt.subplots(1, n_panels, figsize=(5 * n_panels, 4.5),
                             dpi=120)

    # 1. prediction distribution
    axes[0].bar(range(len(classes)), [preds.count(c) for c in classes])
    axes[0].set_xticks(range(len(classes)))
    axes[0].set_xticklabels(classes, rotation=45, ha="right", fontsize=7)
    axes[0].set_title("Prediction distribution")

    # 2. confidence histogram
    axes[1].hist(confs, bins=20, range=(0, 1))
    axes[1].axvline(confs.mean(), color="red", linestyle="--",
                    label=f"mean {confs.mean():.2f}")
    axes[1].legend()
    axes[1].set_title("Confidence histogram")

    # 3. probability heatmap (images × classes, first 40 rows)
    all_labels = sorted(results[0]["all_probabilities"])
    probs = np.asarray([[r["all_probabilities"][lab] for lab in all_labels]
                        for r in results[:40]])
    im = axes[2].imshow(probs, aspect="auto", cmap="viridis")
    axes[2].set_xticks(range(len(all_labels)))
    axes[2].set_xticklabels(all_labels, rotation=45, ha="right", fontsize=6)
    axes[2].set_title("Probability heatmap")
    fig.colorbar(im, ax=axes[2], fraction=0.046)

    # 4. lowest-confidence images
    order = np.argsort(confs)[:10]
    names = [Path(str(results[i]["image_path"])).name[:18] for i in order]
    axes[3].barh(range(len(order)), confs[order])
    axes[3].set_yticks(range(len(order)))
    axes[3].set_yticklabels(names, fontsize=6)
    axes[3].invert_yaxis()
    axes[3].set_title("Lowest confidence")

    # 5. evaluation metrics
    if eval_metrics:
        keys = [k for k in ("accuracy", "macro_f1", "weighted_f1",
                            "macro_precision", "macro_recall")
                if k in eval_metrics]
        axes[4].bar(range(len(keys)), [eval_metrics[k] for k in keys])
        axes[4].set_xticks(range(len(keys)))
        axes[4].set_xticklabels(keys, rotation=45, ha="right", fontsize=7)
        axes[4].set_ylim(0, 1)
        axes[4].set_title("Evaluation metrics")

    fig.tight_layout()
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_path)
    plt.close(fig)
    LOGGER.info("Dashboard saved to %s", output_path)
    return output_path
