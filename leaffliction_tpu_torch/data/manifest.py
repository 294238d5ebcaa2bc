"""Manifest schema and IO, and the split manifest in one call.

Copy of `leaffliction_tpu/data/manifest.py` (byte-compatible with the
reference manifest JSON):

    {"meta": {"created_at", "seed", "strategy", "min_val", "src_root"},
     "items": [{"plant", "class", "label", "split", "src", "id"
                [, "augmented"]}]}

Labels are `PLANT__CLASS`; the label→index mapping is over sorted labels.
`write_split_manifest` writes the manifest that the split CLI
(`leaffliction-split --val-ratio`) writes, for scripts such as
`chip_smoke.py`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence


@dataclass(frozen=True)
class ManifestItem:
    plant: str
    cls: str
    label: str
    split: str
    src: str
    id: str
    augmented: bool = False

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "plant": self.plant,
            "class": self.cls,
            "label": self.label,
            "split": self.split,
            "src": self.src,
            "id": self.id,
        }
        if self.augmented:
            d["augmented"] = True
        return d

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "ManifestItem":
        return ManifestItem(
            plant=d.get("plant", ""),
            cls=d.get("class", ""),
            label=d["label"],
            split=d.get("split", "train"),
            src=str(d.get("src", d.get("path", ""))),
            id=str(d.get("id", d.get("src", ""))),
            augmented=bool(d.get("augmented", False)),
        )


def load_manifest(path: str | Path) -> tuple[Dict[str, Any],
                                             List[ManifestItem]]:
    """Read a manifest file → (meta dict, items)."""
    with Path(path).open("r", encoding="utf-8") as f:
        raw = json.load(f)
    meta = raw.get("meta", {})
    items = [ManifestItem.from_json(d) for d in raw.get("items", [])]
    return meta, items


def save_manifest(path: str | Path, meta: Mapping[str, Any],
                  items: Sequence[ManifestItem]) -> None:
    payload = {"meta": dict(meta), "items": [it.to_json() for it in items]}
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, ensure_ascii=False)


def select_items(items: Sequence[ManifestItem], split: Optional[str] = None
                 ) -> List[ManifestItem]:
    """Filter by split name; None returns everything."""
    if split is None:
        return list(items)
    return [it for it in items if it.split == split]


def build_label_mapping(items: Sequence[ManifestItem]) -> Dict[str, int]:
    """Sorted unique labels → contiguous indices."""
    labels = sorted({it.label for it in items})
    return {lab: i for i, lab in enumerate(labels)}


def write_split_manifest(src: Path, path: Path, val_ratio: float = 0.2,
                         seed: int = 32) -> int:
    """Scan the `PLANT/CLASS/*.jpg` tree `src`, hold out `val_ratio` of each
    class (seeded as the split CLI does) and save the manifest to `path`.
    Returns the number of items."""
    from leaffliction_tpu_torch.data.scan import count_by_label, scan_dataset
    from leaffliction_tpu_torch.data.split import (
        allocate_validation_by_ratio,
        apply_split,
        build_split_map,
        group_by_label,
    )

    src = Path(src)
    items = scan_dataset(src)
    if not items:
        raise ValueError(f"no images under {src}")
    alloc = allocate_validation_by_ratio(count_by_label(items), val_ratio)
    items = apply_split(items, build_split_map(group_by_label(items), alloc,
                                               seed))
    save_manifest(path, meta={
        "created_at": datetime.now(tz=timezone.utc).isoformat(),
        "seed": seed,
        "strategy": "minimal-even >= min_val",
        "min_val": int(val_ratio * 100),
        "src_root": str(src.resolve()),
    }, items=items)
    return len(items)
