"""`python -m leaffliction_tpu_torch.cli.distribution` — dataset
distribution analysis.

Copy of `leaffliction_tpu/cli/distribution.py` (host only: no tensor is
made): merge-updated `artifacts/plots/distribution.csv` (plant,class,count),
per-plant `<PLANT>_bar.png` / `<PLANT>_pie.png`, `--plants` subset filter,
`--no-plots`. Without matplotlib the PNGs are skipped with a warning, as the
JAX CLI skips them.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from leaffliction_tpu_torch.core.logging import get_logger, setup_logging
from leaffliction_tpu_torch.data.scan import scan_dataset

LOGGER = get_logger(__name__)

Row = Tuple[str, str, int]


def count_images(root: Path, plants: Optional[Iterable[str]]) -> List[Row]:
    plant_filter = set(plants) if plants else None
    counts: Dict[Tuple[str, str], int] = {}
    for it in scan_dataset(root):
        if plant_filter and it.plant not in plant_filter:
            continue
        counts[(it.plant, it.cls)] = counts.get((it.plant, it.cls), 0) + 1
    return sorted((p, c, n) for (p, c), n in counts.items())


def merge_csv(rows: List[Row], csv_path: Path) -> None:
    """Merge new counts into an existing distribution.csv (same header rules
    as reference `Distribution.py:52-88`: incompatible headers are replaced)."""
    existing: Dict[Tuple[str, str], int] = {}
    if csv_path.exists():
        try:
            with csv_path.open("r", encoding="utf-8") as f:
                reader = csv.DictReader(f)
                header = [h.lower() for h in (reader.fieldnames or [])]
                if header == ["plant", "class", "count"]:
                    for row in reader:
                        try:
                            existing[(row["plant"], row["class"])] = int(row["count"])
                        except (KeyError, ValueError):
                            continue
                else:
                    LOGGER.warning("Replacing incompatible CSV header: %s", csv_path)
        except OSError as exc:
            LOGGER.warning("Unable to read existing CSV (%s), recreating", exc)
    for plant, cls, count in rows:
        existing[(plant, cls)] = count
    csv_path.parent.mkdir(parents=True, exist_ok=True)
    with csv_path.open("w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow(["plant", "class", "count"])
        for plant, cls in sorted(existing):
            writer.writerow([plant, cls, existing[(plant, cls)]])


def plot_per_plant(rows: List[Row], out_dir: Path) -> None:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception as exc:  # matplotlib genuinely absent
        LOGGER.warning("matplotlib unavailable, skipping plots (%s)", exc)
        return

    per_plant: Dict[str, List[Tuple[str, int]]] = {}
    for plant, cls, n in rows:
        per_plant.setdefault(plant, []).append((cls, n))
    out_dir.mkdir(parents=True, exist_ok=True)
    for plant, entries in per_plant.items():
        labels = [c for c, _ in entries]
        values = [n for _, n in entries]

        fig = plt.figure()
        plt.title(f"Distribution — {plant} (bar)")
        plt.bar(labels, values)
        plt.xlabel("Class")
        plt.ylabel("Images")
        plt.xticks(rotation=45, ha="right")
        fig.tight_layout()
        fig.savefig(str(out_dir / f"{plant}_bar.png"), dpi=150)
        plt.close(fig)

        fig = plt.figure()
        plt.title(f"Distribution — {plant} (pie)")
        plt.pie(values, labels=labels, autopct="%1.1f%%")
        fig.tight_layout()
        fig.savefig(str(out_dir / f"{plant}_pie.png"), dpi=150)
        plt.close(fig)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Analyze dataset distribution (root/PLANT/CLASS/*.jpg)."
    )
    parser.add_argument("root", nargs="?", default=None)
    parser.add_argument("--plants", nargs="+", default=None)
    parser.add_argument("--no-plots", action="store_true")
    parser.add_argument("--out-dir", type=Path, default=Path("artifacts/plots"))
    return parser.parse_args(argv)


def resolve_root(arg_root: Optional[str]) -> Path:
    if arg_root:
        return Path(arg_root)
    default = Path("images")
    return default if default.exists() else Path.cwd()


def main(argv=None) -> None:
    args = parse_args(argv)
    setup_logging()
    root = resolve_root(args.root)
    if not root.exists():
        LOGGER.error("Root directory does not exist: %s", root)
        return

    all_plants = {p.name for p in root.iterdir() if p.is_dir()}
    plants_filter = None
    if args.plants:
        missing = sorted(set(args.plants) - all_plants)
        if missing:
            for m in missing:
                LOGGER.warning("Plant directory not found: %s", m)
            LOGGER.error("Aborting due to unknown plant(s). Available: %s",
                         ", ".join(sorted(all_plants)))
            return
        plants_filter = set(args.plants)

    rows = count_images(root, plants_filter)
    if not rows:
        LOGGER.warning("No images found (.jpg only)")
        return

    csv_path = args.out_dir / "distribution.csv"
    merge_csv(rows, csv_path)
    LOGGER.info("CSV written/updated: %s", csv_path.resolve())
    if not args.no_plots:
        plot_per_plant(rows, args.out_dir)
        LOGGER.info("Plots written to: %s", args.out_dir.resolve())
    LOGGER.info("Total images counted: %d", sum(n for _, _, n in rows))


if __name__ == "__main__":
    main()
