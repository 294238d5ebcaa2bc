"""Split manifests, through the JAX package's host modules (no JAX import).

`load_manifest`, `select_items` and `build_label_mapping` read a manifest as
the train CLI needs it. `write_split_manifest` writes the manifest that the
split CLI (`leaffliction_tpu.cli.split`, itself free of JAX) writes with
`--val-ratio`, as one function call for scripts such as `chip_smoke.py`.
"""

from __future__ import annotations

from datetime import datetime, timezone
from pathlib import Path

from leaffliction_tpu.data.manifest import (
    build_label_mapping,
    load_manifest,
    save_manifest,
    select_items,
)
from leaffliction_tpu.data.scan import count_by_label, scan_dataset
from leaffliction_tpu.data.split import (
    allocate_validation_by_ratio,
    apply_split,
    build_split_map,
    group_by_label,
)

__all__ = ["build_label_mapping", "load_manifest", "select_items",
           "write_split_manifest"]


def write_split_manifest(src: Path, path: Path, val_ratio: float = 0.2,
                         seed: int = 32) -> int:
    """Scan the `PLANT/CLASS/*.jpg` tree `src`, hold out `val_ratio` of each
    class (seeded as the split CLI does) and save the manifest to `path`.
    Returns the number of items."""
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
