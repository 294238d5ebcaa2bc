"""Train/val split allocation.

Copy of `leaffliction_tpu/data/split.py`'s two strategies: by ratio (per
label, round-half-up of n*ratio, capped at n-1, 0 for singletons) and
minimal-even (`allocate_validation_counts`: round-robin +1 per eligible
label until `min_total` is reached or every label keeps one train image).
The shuffle is host Python `random.Random(seed)`, as in the reference, so
the split decisions are the same.
"""

from __future__ import annotations

import random
from typing import Dict, List, Mapping, Sequence

from leaffliction_tpu_torch.data.manifest import ManifestItem


def allocate_validation_by_ratio(by_label_counts: Mapping[str, int],
                                 ratio: float) -> Dict[str, int]:
    if not (0.0 < ratio < 1.0):
        raise ValueError("val-ratio must be in (0, 1)")
    alloc: Dict[str, int] = {}
    for lab, n in by_label_counts.items():
        if n <= 1:
            alloc[lab] = 0
            continue
        desired = int(n * ratio + 0.5)  # round-half-up
        alloc[lab] = max(0, min(desired, n - 1))
    return alloc


def allocate_validation_counts(by_label_counts: Mapping[str, int],
                               min_total: int) -> Dict[str, int]:
    if min_total < 0:
        raise ValueError("min_total must be >= 0")
    labels = sorted(by_label_counts)
    capacity = {lab: max(by_label_counts[lab] - 1, 0) for lab in labels}
    eligible = [lab for lab in labels if capacity[lab] > 0]
    total_capacity = sum(capacity[lab] for lab in eligible)

    alloc = dict.fromkeys(labels, 0)
    if not eligible or total_capacity <= 0:
        return alloc
    if total_capacity < min_total:
        for lab in eligible:
            alloc[lab] = capacity[lab]
        return alloc

    remaining = min_total
    active = list(eligible)
    while remaining > 0 and active:
        for lab in list(active):
            if remaining == 0:
                break
            if alloc[lab] < capacity[lab]:
                alloc[lab] += 1
                remaining -= 1
            if alloc[lab] >= capacity[lab]:
                active.remove(lab)
    return alloc


def group_by_label(items: Sequence[ManifestItem]
                   ) -> Dict[str, List[ManifestItem]]:
    grouped: Dict[str, List[ManifestItem]] = {}
    for it in items:
        grouped.setdefault(it.label, []).append(it)
    return grouped


def build_split_map(items_by_label: Mapping[str, List[ManifestItem]],
                    alloc_val: Mapping[str, int], seed: int
                    ) -> Dict[str, str]:
    """id → 'train'|'val', deterministic under `seed`."""
    rng = random.Random(seed)
    split_map: Dict[str, str] = {}
    for lab, items in items_by_label.items():
        files = list(items)
        rng.shuffle(files)
        k_val = min(alloc_val.get(lab, 0), len(files))
        val_ids = {f.id for f in files[:k_val]}
        for f in files:
            split_map[f.id] = "val" if f.id in val_ids else "train"
    return split_map


def apply_split(items: Sequence[ManifestItem], split_map: Mapping[str, str]
                ) -> List[ManifestItem]:
    return [
        ManifestItem(
            plant=it.plant, cls=it.cls, label=it.label,
            split=split_map.get(it.id, it.split), src=it.src, id=it.id,
            augmented=it.augmented,
        )
        for it in items
    ]
