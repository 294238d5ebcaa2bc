"""`python -m leaffliction_tpu_torch.cli.split` — build the train/val manifest
and its summary CSV.

Copy of `leaffliction_tpu/cli/split.py` (host only: no tensor is made): the
same flags and defaults (src=artifacts/augmented_directory,
out=artifacts/datasets, min-val=100, val-ratio=0.2, seed=32), the same
`manifest_split.json` meta and `split_summary.csv` (`write_summary`, which
the fused balance shares). With `--val-ratio` defaulting to 0.2 the ratio
allocator is the one a user reaches; the minimal-even one (`--min-val`) is
kept as the JAX CLI has it.
"""

from __future__ import annotations

import argparse
import csv
import sys
from datetime import datetime, timezone
from pathlib import Path

from leaffliction_tpu_torch.core.logging import get_logger, setup_logging
from leaffliction_tpu_torch.data.manifest import save_manifest
from leaffliction_tpu_torch.data.scan import (
    count_by_label,
    is_image,
    scan_dataset,
)
from leaffliction_tpu_torch.data.split import (
    allocate_validation_by_ratio,
    allocate_validation_counts,
    apply_split,
    build_split_map,
    group_by_label,
)

LOGGER = get_logger(__name__)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description=(
            "Minimal balanced split: smallest validation set meeting --min-val "
            "(even across classes, keeps >=1 train). Writes manifest + summary."
        )
    )
    parser.add_argument("--src", type=Path,
                        default=Path("artifacts/augmented_directory"))
    parser.add_argument("--out", type=Path, default=Path("artifacts/datasets"))
    parser.add_argument("--min-val", type=int, default=100)
    parser.add_argument("--val-ratio", type=float, default=0.2,
                        help="Per-class validation ratio; overrides --min-val.")
    parser.add_argument("--out-manifest", type=Path, default=None)
    parser.add_argument("--seed", type=int, default=32)
    parser.add_argument("--reset", action="store_true")
    return parser.parse_args(argv)


def validate_source_structure(root: Path) -> None:
    if not root.exists():
        LOGGER.error("Source directory does not exist: %s", root)
        sys.exit(1)
    plant_dirs = [p for p in root.iterdir() if p.is_dir()]
    if not plant_dirs:
        LOGGER.error("No subdirectories found under source root: %s", root)
        sys.exit(1)
    class_dirs = [c for p in plant_dirs for c in p.iterdir() if c.is_dir()]
    if not class_dirs:
        LOGGER.error("No class directories found inside plants under: %s", root)
        sys.exit(1)
    empty = [c for c in class_dirs if not any(is_image(f) for f in c.iterdir())]
    if empty:
        LOGGER.warning("Empty class directories (ignored): %s",
                       ", ".join(d.as_posix() for d in empty[:15]))


def reset_split_outputs(out_root: Path) -> None:
    for name in ("manifest_split.json", "split_summary.csv"):
        target = out_root / name
        if target.is_file():
            target.unlink()
            LOGGER.info("Reset: removed %s", target)


def write_summary(out_path: Path, items) -> None:
    """split_summary.csv: label,n_train,n_val,total and a _TOTAL_ row."""
    out_path.parent.mkdir(parents=True, exist_ok=True)
    grouped = group_by_label(items)
    n_train = n_val = 0
    with out_path.open("w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow(["label", "n_train", "n_val", "total"])
        for lab in sorted(grouped):
            vals = sum(1 for it in grouped[lab] if it.split == "val")
            trains = len(grouped[lab]) - vals
            writer.writerow([lab, trains, vals, len(grouped[lab])])
            n_train += trains
            n_val += vals
        writer.writerow(["_TOTAL_", n_train, n_val, n_train + n_val])
    LOGGER.info("Summary CSV written: %s (train=%d, val=%d)",
                out_path.resolve(), n_train, n_val)


def main(argv=None) -> None:
    args = parse_args(argv)
    setup_logging()
    validate_source_structure(args.src)
    if args.reset:
        reset_split_outputs(args.out)

    items = scan_dataset(args.src)
    if not items:
        LOGGER.error("No images discovered after scan (.jpg only)")
        sys.exit(1)

    counts = count_by_label(items)
    if args.val_ratio is not None:
        alloc = allocate_validation_by_ratio(counts, args.val_ratio)
        LOGGER.info("Using ratio-based allocation: val_ratio=%.3f", args.val_ratio)
    else:
        alloc = allocate_validation_counts(counts, args.min_val)
    for lab in sorted(counts):
        LOGGER.info("  %s: %d/%d val", lab, alloc.get(lab, 0), counts[lab])

    split_map = build_split_map(group_by_label(items), alloc, args.seed)
    if len(split_map) != len(items):
        LOGGER.error("Split map size mismatch (%d vs %d)",
                     len(split_map), len(items))
        sys.exit(1)
    items = apply_split(items, split_map)

    manifest_path = args.out_manifest or (args.out / "manifest_split.json")
    save_manifest(
        manifest_path,
        meta={
            "created_at": datetime.now(tz=timezone.utc).isoformat(),
            "seed": args.seed,
            "strategy": "minimal-even >= min_val",
            "min_val": (int(args.val_ratio * 100) if args.val_ratio is not None
                        else args.min_val),
            "src_root": str(args.src.resolve()),
        },
        items=items,
    )
    LOGGER.info("Manifest written: %s", Path(manifest_path).resolve())
    write_summary(args.out / "split_summary.csv", items)
    LOGGER.info("Split completed.")


if __name__ == "__main__":
    main()
