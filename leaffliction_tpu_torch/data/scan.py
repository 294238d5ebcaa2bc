"""Dataset tree scanning: root/PLANT/CLASS/*.jpg.

Copy of `leaffliction_tpu/data/scan.py`: `.jpg`-only whitelist
(case-insensitive suffix), sorted traversal, labels `PLANT__CLASS`, stable
relative ids `plant/class/filename`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

from leaffliction_tpu_torch.data.manifest import ManifestItem

IMAGE_EXTS = {".jpg"}


def is_image(path: Path) -> bool:
    return path.is_file() and path.suffix.lower() in IMAGE_EXTS


def scan_dataset(root: str | Path) -> List[ManifestItem]:
    root = Path(root)
    items: List[ManifestItem] = []
    if not root.exists():
        return items
    for plant_dir in sorted(p for p in root.iterdir() if p.is_dir()):
        for class_dir in sorted(c for c in plant_dir.iterdir() if c.is_dir()):
            label = f"{plant_dir.name}__{class_dir.name}"
            for img in sorted(class_dir.iterdir()):
                if not is_image(img):
                    continue
                items.append(ManifestItem(
                    plant=plant_dir.name,
                    cls=class_dir.name,
                    label=label,
                    split="train",
                    src=img.resolve().as_posix(),
                    id=f"{plant_dir.name}/{class_dir.name}/{img.name}",
                    augmented="_aug_" in img.stem,
                ))
    return items


def count_by_label(items: List[ManifestItem]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for it in items:
        counts[it.label] = counts.get(it.label, 0) + 1
    return counts


def count_by_plant_class(items: List[ManifestItem]
                         ) -> Dict[str, Dict[str, int]]:
    out: Dict[str, Dict[str, int]] = {}
    for it in items:
        out.setdefault(it.plant, {})
        out[it.plant][it.cls] = out[it.plant].get(it.cls, 0) + 1
    return out
