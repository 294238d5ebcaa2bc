"""`python -m leaffliction_tpu_torch.cli.augment` — single-image examples or
dataset balancing, on one CUDA device (or the CPU, when asked for by name).

Port of `leaffliction_tpu/cli/augment.py`, with `--device` (cuda by
default; `core/device.py`). Single-image mode writes `original_<name>` and
the six `<transform>_<name>` files to artifacts/example: op i (in
`TRANSFORMATIONS` order) draws from `numpy.random.default_rng([seed, i])`
and runs as a batch of one on the device (rotate through K2, cropped to
PIL's expanded size; shear through K3). Dataset mode balances into
artifacts/augmented_directory with `data/balancer.DatasetBalancer`, writes
manifest_augmented.json, and analyses the balanced tree into
artifacts/distribution/balanced_distribution.csv. Paths are relative to
the working directory, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path
from typing import Callable, Optional

from leaffliction_tpu_torch.core.logging import get_logger, setup_logging

LOGGER = get_logger(__name__)

SUPPORTED_IMAGE_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".tiff"}
DEFAULT_DATASET_OUTPUT = "artifacts/augmented_directory"
DEFAULT_SINGLE_OUTPUT = "artifacts/example"
DEFAULT_SEED = 42


class AugmentationError(Exception):
    pass


class InputValidationError(AugmentationError):
    pass


class ProcessingError(AugmentationError):
    pass


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description=("Apply augmentations to balance a dataset, or generate "
                     "the 6 example transforms for a single image.")
    )
    parser.add_argument("input_path")
    parser.add_argument("-out", "--output", default=None)
    parser.add_argument("-seed", "--seed", type=int, default=DEFAULT_SEED)
    parser.add_argument("--workers", type=int, default=None,
                        help="Kept for reference-flag parity (batching is "
                             "on-device; decode threads are automatic)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def single_image_mode(args, image_path: Path, device,
                      draw: Optional[Callable] = None) -> None:
    """`draw(transform, i, (h, w), device)` → the op's parameters; the
    port's own `default_rng([seed, i])` draws by default."""
    import numpy as np
    import torch
    from PIL import Image

    from leaffliction_tpu_torch.data.balancer import (
        TRANSFORMATIONS,
        crop_canvas,
    )
    from leaffliction_tpu_torch.ops.augment import BATCH_KERNELS, DRAWS

    if draw is None:
        def draw(transform, i, hw, dev):
            rng = np.random.default_rng([args.seed % 2 ** 64, i])
            return DRAWS[transform]([rng], hw, dev)

    output_dir = Path(args.output) if args.output else Path(DEFAULT_SINGLE_OUTPUT)
    output_dir.mkdir(parents=True, exist_ok=True)
    LOGGER.info("Processing single image: %s", image_path)

    original_output = output_dir / f"original_{image_path.name}"
    shutil.copy2(image_path, original_output)
    LOGGER.info("Original image copied: %s", original_output)

    with Image.open(image_path) as im:
        arr = np.array(im.convert("RGB"), np.uint8)
    h0, w0 = arr.shape[:2]
    batch = torch.from_numpy(arr)[None].to(device)

    for i, transform in enumerate(TRANSFORMATIONS):
        params = draw(transform, i, (h0, w0), device)
        out = BATCH_KERNELS[transform](batch, **params)[0].cpu().numpy()
        if transform == "rotate":
            out = crop_canvas(out, float(params["angles"][0]), h0, w0)
        out_path = output_dir / f"{transform}_{image_path.name}"
        Image.fromarray(out).save(out_path, quality=95)
        LOGGER.info("%s applied: %s", transform.capitalize(), out_path)
    LOGGER.info("Single image augmentation completed successfully")


def dataset_mode_dir(args, source_dir: Path, device) -> None:
    from leaffliction_tpu_torch.data.balancer import DatasetBalancer

    target_dir = Path(args.output) if args.output else Path(DEFAULT_DATASET_OUTPUT)
    LOGGER.info("Processing dataset directory: %s", source_dir)
    LOGGER.info("Target directory: %s", target_dir)
    DatasetBalancer(
        source_dir=source_dir, target_dir=target_dir, seed=args.seed,
        device=device,
    ).run()
    LOGGER.info("Dataset augmentation completed successfully")
    try:
        analyze_distribution(target_dir)
    except Exception as exc:
        LOGGER.warning("Distribution analysis failed: %s", exc)


def analyze_distribution(target_dir: Path) -> None:
    from leaffliction_tpu_torch.cli.distribution import (
        count_images,
        merge_csv,
        plot_per_plant,
    )

    if not target_dir.exists():
        LOGGER.warning("Target directory doesn't exist: %s", target_dir)
        return
    LOGGER.info("Analyzing distribution of balanced dataset...")
    rows = count_images(target_dir, None)
    if not rows:
        LOGGER.warning("No images found in target directory")
        return
    out_dir = Path("artifacts") / "distribution"
    merge_csv(rows, out_dir / "balanced_distribution.csv")
    plot_per_plant(rows, out_dir)
    LOGGER.info("Total balanced images: %d", sum(n for _, _, n in rows))


def main(argv=None) -> None:
    setup_logging()
    try:
        from leaffliction_tpu_torch.core.device import resolve_device

        args = parse_args(argv)
        input_path = Path(args.input_path)
        if not input_path.exists():
            raise InputValidationError(f"Input path not found: {input_path}")
        device = resolve_device(args.device)
        if (input_path.is_file()
                and input_path.suffix.lower() in SUPPORTED_IMAGE_EXTENSIONS):
            single_image_mode(args, input_path, device)
            return
        if input_path.is_dir():
            dataset_mode_dir(args, input_path, device)
            return
        raise InputValidationError(
            "Unsupported input. Provide a dataset directory or an image file.")
    except InputValidationError as exc:
        LOGGER.error("Input validation error: %s", exc)
        sys.exit(1)
    except ProcessingError as exc:
        LOGGER.error("Processing error: %s", exc)
        sys.exit(1)
    except Exception as exc:  # reference catch-all, Augmentation.py:114-116
        LOGGER.error("Unexpected error: %s", exc)
        sys.exit(1)


if __name__ == "__main__":
    main()
