"""Prediction evaluation against ground truth.

Port of `leaffliction_tpu/predict/evaluation.py` (same schema: the metrics
dict of `compute_classification_metrics`, and `evaluation_results.json` with
{metrics, evaluation_info, detailed_results}) over the port's `Predictor`,
and `evaluate_from_manifest`, which scores one split of a manifest.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from leaffliction_tpu_torch.core.logging import get_logger
from leaffliction_tpu_torch.predict.predictor import Predictor
from leaffliction_tpu_torch.utils.metrics import compute_classification_metrics

LOGGER = get_logger(__name__)


class PredictionEvaluator:
    def __init__(self, predictor: Predictor) -> None:
        self.predictor = predictor

    def evaluate_predictions(
        self,
        image_paths: Sequence[Path],
        true_labels: Sequence[str],
        output_dir: Optional[Path] = None,
        predictions: Optional[List[Dict]] = None,
    ) -> Dict[str, float]:
        """Score predictions against ground truth.

        Predictions are paired to labels BY IMAGE PATH, not position:
        `predict_batch` skips unreadable images, so a positional zip (the
        reference's approach, `srcs/predict/evaluation.py:40-52`) misaligns
        every pair after the first skip. Pass `predictions` to reuse an
        existing `predict_batch` result instead of re-predicting (the
        reference predicts the same sample twice, `srcs/cli/predict.py:305-388`).
        """
        if len(image_paths) != len(true_labels):
            raise ValueError("Number of images must match number of true labels")
        LOGGER.info("Evaluating %d predictions", len(image_paths))

        if predictions is None:
            predictions = self.predictor.predict_batch(image_paths)
        truth_by_path = {
            str(Path(p)): lab for p, lab in zip(image_paths, true_labels)
        }
        labels = self.predictor.model_loader.labels
        label_to_idx = {lab: i for i, lab in enumerate(labels)}

        y_true: List[int] = []
        y_pred: List[int] = []
        valid: List[Dict] = []
        valid_true: List[str] = []
        for pred in predictions:
            true_label = truth_by_path.get(str(pred["image_path"]))
            pred_label = pred["top_prediction"]
            if true_label is None:
                LOGGER.warning("No ground truth for %s; skipping",
                               pred["image_path"])
                continue
            if true_label not in label_to_idx or pred_label not in label_to_idx:
                LOGGER.warning("Skipping unknown label: %s or %s",
                               true_label, pred_label)
                continue
            y_true.append(label_to_idx[true_label])
            y_pred.append(label_to_idx[pred_label])
            valid.append(pred)
            valid_true.append(true_label)

        if not y_true:
            LOGGER.error("No valid predictions to evaluate")
            return {}

        metrics = compute_classification_metrics(y_true, y_pred, labels)

        if output_dir:
            output_dir = Path(output_dir)
            output_dir.mkdir(parents=True, exist_ok=True)
            eval_results = {
                "metrics": metrics,
                "evaluation_info": {
                    "total_images": len(image_paths),
                    "valid_predictions": len(valid),
                    "class_labels": labels,
                },
                "detailed_results": [
                    {
                        "image_path": str(pred["image_path"]),
                        "true_label": true_label,
                        "predicted_label": pred["top_prediction"],
                        "confidence": pred["confidence"],
                        "correct": true_label == pred["top_prediction"],
                    }
                    for pred, true_label in zip(valid, valid_true)
                ],
            }
            results_path = output_dir / "evaluation_results.json"
            with results_path.open("w", encoding="utf-8") as f:
                json.dump(eval_results, f, indent=2)
            LOGGER.info("Evaluation results saved to: %s", results_path)
        return metrics


def evaluate_from_manifest(predictor: Predictor, manifest_path: Path,
                           split: str = "test",
                           output_dir: Optional[Path] = None
                           ) -> Dict[str, float]:
    """Filter the manifest's items by split, then evaluate them
    (`srcs/predict/evaluation.py:109-144`)."""
    with Path(manifest_path).open("r", encoding="utf-8") as f:
        data = json.load(f)
    items = data["items"] if isinstance(data, dict) and "items" in data \
        else data
    selected = [it for it in items if it.get("split") == split]
    if not selected:
        LOGGER.error("No items found for split '%s' in manifest", split)
        return {}
    image_paths = [Path(it["src"]) for it in selected]
    true_labels = [it.get("label", it.get("class")) for it in selected]
    return PredictionEvaluator(predictor).evaluate_predictions(
        image_paths, true_labels, output_dir)
