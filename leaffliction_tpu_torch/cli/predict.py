"""`python -m leaffliction_tpu_torch.cli.predict` — prediction on a GPU.

The PyTorch counterpart of `leaffliction-predict`
(`leaffliction_tpu/cli/predict.py`), with the same flags, modes and
artifacts: single mode (montage with the leaf mask), batch mode
(`batch_results.json` with {batch_results, summary}) and `--evaluate`
sampling-enforced mode (exit 2 when the target accuracy is not reached).
`--device` picks the device (default `cuda`; without CUDA the run fails
instead of falling back to the CPU). `--mesh-data N` serves on the first N
visible CUDA devices (-1: all of them), a model replica on each and every
64-image chunk split over them (`Predictor(devices=...)`); N above the
visible count exits 1 with the JAX CLI's "does not cover" error, and so does
a multi-process launch ("mesh serving is single-process"). The input
checks, file listing,
manifest sampling and result writers are copies of the JAX CLI's, so
`batch_results.json` has its schema.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path
from typing import List, Optional

from leaffliction_tpu_torch.core.logging import get_logger, setup_logging
from leaffliction_tpu_torch.utils.viz import (
    create_batch_dashboard,
    open_image_viewer,
)

LOGGER = get_logger(__name__)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Predict leaf disease from image(s)")
    p.add_argument("image_path")
    p.add_argument("-learnings", "--learnings-dir", default="artifacts/models")
    p.add_argument("-out", "--output-dir",
                   default="artifacts/prediction_output")
    p.add_argument("-json", "--json-output",
                   default="artifacts/prediction_output/batch_results.json")
    p.add_argument("-batch", "--batch-mode", action="store_true")
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--manifest")
    p.add_argument("--split", default="val")
    p.add_argument("--sample-size", type=int, default=100)
    p.add_argument("--target-acc", type=float, default=0.90)
    p.add_argument("--max-attempts", type=int, default=5)
    p.add_argument("--mesh-data", type=int, default=1,
                   help="Devices to shard serving batches over: the first N "
                        "visible CUDA devices (-1: all of them; with "
                        "--device cpu, N replicas on the CPU)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


def validate_inputs(args):
    image_path = Path(args.image_path)
    learnings_dir = Path(args.learnings_dir)
    if not image_path.exists():
        raise FileNotFoundError(f"Path not found: {image_path}")
    if args.batch_mode and not image_path.is_dir():
        raise ValueError(f"Batch mode requires a directory, got: {image_path}")
    if not args.batch_mode and not image_path.is_file():
        raise ValueError(
            f"Single mode requires an image file, got: {image_path}")
    if not learnings_dir.exists():
        raise FileNotFoundError(
            f"Learnings directory not found: {learnings_dir}")
    if not (learnings_dir / "meta.json").exists():
        raise FileNotFoundError(
            f"Meta file not found: {learnings_dir / 'meta.json'}")
    if args.evaluate:
        if not args.batch_mode:
            raise ValueError("--evaluate requires --batch-mode")
        if not args.manifest:
            raise ValueError("--evaluate requires --manifest")
        if not Path(args.manifest).exists():
            raise FileNotFoundError(f"Manifest not found: {args.manifest}")
    return image_path, learnings_dir


def get_image_files(directory: Path) -> List[Path]:
    return sorted(
        p for p in Path(directory).rglob("*")
        if p.is_file() and p.suffix.lower() in {".jpg", ".jpeg", ".png"})


def create_batch_summary(results, processing_time):
    """The summary block of batch_results.json."""
    if not results:
        return {"total_images": 0,
                "processing_time": f"{processing_time:.2f}s"}
    counts: dict = {}
    for r in results:
        counts[r["top_prediction"]] = counts.get(r["top_prediction"], 0) + 1
    avg_conf = sum(r["confidence"] for r in results) / len(results)
    return {
        "total_images": len(results),
        "processing_time": f"{processing_time:.2f}s",
        "average_confidence": f"{avg_conf:.2%}",
        "prediction_distribution": counts,
    }


def save_batch_results_json(results, processing_time, output_path) -> Path:
    output_path = Path(output_path)
    if not output_path.is_absolute() and not str(output_path).startswith(
            "artifacts/"):
        output_path = Path("artifacts/prediction_output") / output_path.name
    payload = {
        "batch_results": [
            {
                "image_path": str(r["image_path"]),
                "top_prediction": r["top_prediction"],
                "confidence": r["confidence"],
                "all_probabilities": r["all_probabilities"],
            }
            for r in results
        ],
        "summary": create_batch_summary(results, processing_time),
    }
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with output_path.open("w") as f:
        json.dump(payload, f, indent=2)
    return output_path


def _load_manifest_items(manifest_path, split):
    with open(manifest_path, "r") as f:
        data = json.load(f)
    raw_items = (data.get("items", []) if isinstance(data, dict)
                 else data if isinstance(data, list) else [])
    if split is None:
        return list(raw_items)
    items = [it for it in raw_items if it.get("split") == split]
    if not items:
        LOGGER.warning("No items for split '%s'; using all items", split)
        items = list(raw_items)
    return items


def _item_path(item, manifest_path: Path, image_dir: Path) -> Optional[Path]:
    for key in ("src", "id", "path", "filepath", "file", "image", "img_path"):
        if key in item:
            p = Path(item[key])
            if p.is_absolute():
                return p if p.exists() else None
            for base in (manifest_path.parent, image_dir):
                if (base / p).exists():
                    return base / p
            return p if p.exists() else None
    return None


def run_sampling_enforced_batch(
    predictor, image_dir: Path, manifest_path: Path, split: str,
    sample_size: int, target_acc: float, max_attempts: int,
    json_output, output_dir: Path,
) -> bool:
    """Retry sampled evaluation until accuracy ≥ target."""
    from leaffliction_tpu_torch.predict.evaluation import PredictionEvaluator

    best = 0.0
    items = _load_manifest_items(manifest_path, split)
    for attempt in range(1, max_attempts + 1):
        LOGGER.info("Sampling attempt %d/%d (n=%d)", attempt, max_attempts,
                    sample_size)
        rng = random.Random(int(time.time()) % 1_000_000 + attempt)
        sampled = rng.sample(items, min(sample_size, len(items))) if items else []
        paths, labels = [], []
        for it in sampled:
            p = _item_path(it, manifest_path, image_dir)
            if p is not None and p.exists():
                paths.append(p)
                labels.append(it.get("label", it.get("class")))
        if not paths:
            LOGGER.warning("Sampling produced no valid images; retrying...")
            continue
        start = time.time()
        results = predictor.predict_batch(paths)
        proc_time = time.time() - start
        if not results:
            continue
        label_by_path = {str(p): lab for p, lab in zip(paths, labels)}
        correct = sum(
            1 for r in results
            if r["top_prediction"] == label_by_path.get(str(r["image_path"]))
        )
        acc = correct / len(results)
        LOGGER.info("Sample accuracy: %.4f on %d images", acc, len(results))
        if acc >= target_acc:
            LOGGER.info("Target accuracy reached (>= %.2f). Emitting outputs.",
                        target_acc)
            if json_output:
                out = save_batch_results_json(results, proc_time, json_output)
                LOGGER.info("Results saved to: %s", out)
            try:
                eval_metrics = PredictionEvaluator(predictor).evaluate_predictions(
                    paths, labels, output_dir=output_dir / "evaluation",
                    predictions=results)
            except Exception as exc:
                LOGGER.warning("Detailed evaluation failed: %s", exc)
                eval_metrics = {"accuracy": acc}
            dash = create_batch_dashboard(
                results, output_dir / "batch_dashboard.png", eval_metrics)
            if dash:
                open_image_viewer(dash)
            LOGGER.info("Batch prediction completed successfully")
            return True
        best = max(best, acc)
    LOGGER.error(
        "Failed to reach target accuracy %.2f after %d attempts (best=%.4f). "
        "No outputs emitted.", target_acc, max_attempts, best)
    return False


def _handle_batch_mode(args, predictor, image_path: Path) -> None:
    LOGGER.info("Processing directory: %s", image_path)
    output_dir = Path(args.output_dir)
    if args.evaluate:
        if not run_sampling_enforced_batch(
                predictor, image_path, Path(args.manifest), args.split,
                args.sample_size, args.target_acc, args.max_attempts,
                args.json_output, output_dir):
            sys.exit(2)
        return
    files = get_image_files(image_path)
    if not files:
        LOGGER.error("No images found or processed successfully.")
        sys.exit(1)
    start = time.time()
    results = predictor.predict_batch(files)
    proc_time = time.time() - start
    if not results:
        LOGGER.error("No images found or processed successfully.")
        sys.exit(1)
    summary = create_batch_summary(results, proc_time)
    LOGGER.info("Batch Processing Summary:")
    LOGGER.info("  Total images processed: %d", summary["total_images"])
    LOGGER.info("  Processing time: %s", summary["processing_time"])
    LOGGER.info("  Average confidence: %s", summary["average_confidence"])
    for pred, count in summary["prediction_distribution"].items():
        LOGGER.info("  %s: %d images", pred, count)
    if args.json_output:
        out = save_batch_results_json(results, proc_time, args.json_output)
        LOGGER.info("Results saved to: %s", out)
    dash = create_batch_dashboard(results, output_dir / "batch_dashboard.png",
                                  None)
    if dash:
        open_image_viewer(dash)
    LOGGER.info("Batch prediction completed successfully")


def _handle_single_mode(args, predictor, image_path: Path) -> None:
    from leaffliction_tpu_torch.predict.visualizer import PredictionVisualizer

    LOGGER.info("Processing image: %s", image_path)
    result = predictor.predict_single(image_path, use_transform=True)
    LOGGER.info("Image: %s", result["image_path"])
    LOGGER.info("Prediction: %s (%.2f%%)", result["top_prediction"],
                result["confidence"] * 100)
    top3 = sorted(result["all_probabilities"].items(),
                  key=lambda kv: -kv[1])[:3]
    LOGGER.info("Top 3 predictions:")
    for i, (name, prob) in enumerate(top3):
        LOGGER.info("  %s %s: %.2f%%", "→" if i == 0 else " ", name,
                    prob * 100)
    if args.output_dir:
        out_file = Path(args.output_dir) / f"{image_path.stem}_prediction.png"
        PredictionVisualizer().create_montage(result, out_file)
        LOGGER.info("Montage saved: %s", out_file)
        open_image_viewer(out_file)
    LOGGER.info("Prediction completed successfully")


def serving_mesh(n: int, device):
    """`--mesh-data n` → the serving devices: the first n visible CUDA
    devices (-1: all), or n CPU replicas with `--device cpu`. Raises
    `MeshSpec.resolve`'s ValueError when n exceeds the visible devices, as
    the JAX CLI's `make_mesh` does."""
    import torch

    from leaffliction_tpu_torch.parallel.mesh import MeshSpec

    if n == 1:
        return [device]
    if device.type == "cpu":
        return [device] * max(n, 1)
    visible = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    n = n if n > 0 else len(visible)
    MeshSpec(data=n, model=1).resolve(len(visible[:n]))
    LOGGER.info("Serving mesh: %d-way data parallel", n)
    return visible[:n]


def main(argv=None) -> None:
    setup_logging()
    try:
        args = parse_args(argv)
        image_path, learnings_dir = validate_inputs(args)

        from leaffliction_tpu_torch.core.device import resolve_device
        from leaffliction_tpu_torch.predict.predictor import Predictor

        try:
            device = resolve_device(args.device)
        except RuntimeError as exc:
            LOGGER.error("Device error: %s", exc)
            sys.exit(1)
        devices = serving_mesh(args.mesh_data, device)
        predictor = Predictor(learnings_dir, devices=devices).load()
        LOGGER.info("Model loaded: %d classes on %s",
                    predictor.model_loader.num_classes, device)
        if args.batch_mode:
            _handle_batch_mode(args, predictor, image_path)
        else:
            _handle_single_mode(args, predictor, image_path)
    except (FileNotFoundError, ValueError, NotImplementedError) as exc:
        LOGGER.error("Input error: %s", exc)
        sys.exit(1)


if __name__ == "__main__":
    main()
