"""Fused balance → train: augmented pixels are made on the device and stay
there.

Port of `leaffliction_tpu/data/fused_balance.py`. The host side is a copy
of the JAX package's: the scan, the per-plant plan (`data/balancer`,
deficit split over the six transforms), the task list with its names and
per-task seeds (`build_fused_tasks`), the decode (`decode_batch_with_fallback`)
and the in-memory split with its artifacts (`split_fused_result`), so the
manifests, the summary and the task list are the JAX package's bytes. The
device side:

    decode the originals once at img_size → upload them once (uint8)
      → per transform, chunks of `device_batch` tasks: gather the source
        rows, draw the parameters, run the batch op (rotate: kernel K2, then
        a per-image lanczos3 crop-resize of the expanded canvas back to
        img_size; shear: kernel K3; distortion under LEAF_PALLAS_DISTORT=1:
        kernel K6)
      → put the rows back in task order, append them to the originals.

Each task draws from its own `numpy` generator seeded with (seed,
task_seed) (`data/balancer.task_rngs`), so the bytes depend on the seed and
the task, not on the chunking. `manifest_augmented.json` has the JAX
writer's schema; the JPEG tree of the classic balancer is written only with
`materialize=True`.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import random
import shutil
import time
from dataclasses import dataclass, field
from datetime import datetime, timezone
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from leaffliction_tpu_torch.cli.split import write_summary
from leaffliction_tpu_torch.core.logging import get_logger
from leaffliction_tpu_torch.data.balancer import (
    DEVICE_BATCH,
    TRANSFORMATIONS,
    calculate_plan,
    own_draws,
    sync_device,
)
from leaffliction_tpu_torch.data.manifest import ManifestItem, save_manifest
from leaffliction_tpu_torch.data.native import decode_batch_with_fallback
from leaffliction_tpu_torch.data.scan import (
    count_by_plant_class,
    scan_dataset,
)
from leaffliction_tpu_torch.data.split import (
    allocate_validation_by_ratio,
    apply_split,
    build_split_map,
    group_by_label,
)
from leaffliction_tpu_torch.ops.augment import BATCH_KERNELS
from leaffliction_tpu_torch.ops.resample import scale_translate_warp
from leaffliction_tpu_torch.utils.image_io import ImageLoader

LOGGER = get_logger(__name__)


@dataclass
class FusedTask:
    source_row: int          # row in the original-image device array
    item: ManifestItem       # the augmented item (target-tree path identity)
    transform: str
    task_seed: int


# (transform, tasks of one chunk, (h, w), device) → the op's parameters
Draw = Callable[[str, List[FusedTask], Tuple[int, int], torch.device],
                Dict[str, object]]


@dataclass
class FusedBalanceResult:
    """Balanced dataset on the device: `device_images` rows align with
    `items` and `labels`, originals first (scan order), then the augmented
    rows in task order."""

    items: List[ManifestItem]
    labels: np.ndarray           # [N] int32
    label2idx: Dict[str, int]
    device_images: Optional[torch.Tensor]   # uint8 [N, S, S, 3]
    n_original: int
    n_generated: int
    balance_time_s: float
    stages: Dict[str, float] = field(default_factory=dict)


def build_fused_tasks(items: List[ManifestItem],
                      plan: Dict[str, Dict[str, int]], target_dir: Path,
                      seed: int) -> List[FusedTask]:
    """Task list with the balancer's RNG semantics: one `random.Random(seed)`
    stream draws a source per task (`rng.choice` over the class's images in
    scan order) and a derived seed per task (`rng.randint`). Names follow
    the reference convention `<stem>_aug_<transform>_<i+1>`. Sources are
    keyed by bare class name, the last plant winning on duplicates, as the
    reference's balancer keys them."""
    rng = random.Random(seed)
    per_plant_class: Dict[tuple, List[int]] = {}
    for row, it in enumerate(items):
        per_plant_class.setdefault((it.plant, it.cls), []).append(row)
    rows_by_class = {cls: rows for (_plant, cls), rows
                     in per_plant_class.items()}

    tasks: List[FusedTask] = []
    for class_name, transforms in plan.items():
        rows = rows_by_class.get(class_name, [])
        if not rows:
            LOGGER.warning("No images found for class '%s'", class_name)
            continue
        for transform, count in transforms.items():
            for i in range(count):
                src_row = rng.choice(rows)
                src_item = items[src_row]
                src_path = Path(src_item.src)
                name = (f"{src_path.stem}_aug_{transform}_{i + 1}"
                        f"{src_path.suffix}")
                out_path = (target_dir / src_item.plant / src_item.cls
                            / name)
                tasks.append(FusedTask(
                    source_row=src_row,
                    item=ManifestItem(
                        plant=src_item.plant, cls=src_item.cls,
                        label=src_item.label, split="train",
                        src=out_path.resolve().as_posix(),
                        id=f"{src_item.plant}/{src_item.cls}/{name}",
                        augmented=True),
                    transform=transform,
                    task_seed=rng.randint(0, 1_000_000),
                ))
    return tasks


def resize_rotated(canvas_u8: torch.Tensor, angles: torch.Tensor,
                   img_size: int) -> torch.Tensor:
    """Centre-crop each expanded canvas to its continuous PIL expand size
    (S·cos θ + S·sin θ, square inputs) and resize it to S² with lanczos3 and
    edge clamp → uint8 [n, S, S, 3]."""
    ch, cw = canvas_u8.shape[1], canvas_u8.shape[2]
    theta = torch.deg2rad(angles.to(canvas_u8.device, torch.float32).abs())
    ew = img_size * torch.cos(theta) + img_size * torch.sin(theta)
    eh = ew
    ax = ew / img_size
    ay = eh / img_size
    left = (cw - ew) / 2.0
    top = (ch - eh) / 2.0
    out = scale_translate_warp(
        canvas_u8, torch.stack([ax, ay], 1),
        torch.stack([left + 0.5 * ax - 0.5, top + 0.5 * ay - 0.5], 1),
        (img_size, img_size), fill=None, kernel="lanczos3")
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def _augment_on_device(orig: torch.Tensor, tasks: List[FusedTask],
                       img_size: int, device_batch: int,
                       draw: Draw) -> torch.Tensor:
    """All tasks → uint8 [n_tasks, S, S, 3] on `orig`'s device, in task
    order. Chunks are per transform (tasks are class-major, so a chunk can
    mix classes); one gather at the end restores task order."""
    chunks: List[torch.Tensor] = []
    emit_pos: List[int] = []
    by_transform: Dict[str, List[Tuple[int, FusedTask]]] = {}
    for pos, t in enumerate(tasks):
        by_transform.setdefault(t.transform, []).append((pos, t))
    hw = (img_size, img_size)
    for transform in TRANSFORMATIONS:
        group = by_transform.get(transform, [])
        for start in range(0, len(group), device_batch):
            chunk = group[start:start + device_batch]
            chunk_tasks = [t for _, t in chunk]
            sel = torch.tensor([t.source_row for t in chunk_tasks],
                               device=orig.device)
            params = draw(transform, chunk_tasks, hw, orig.device)
            out = BATCH_KERNELS[transform](orig.index_select(0, sel),
                                           **params)
            if transform == "rotate":
                out = resize_rotated(out, params["angles"], img_size)
            chunks.append(out)
            emit_pos.extend(pos for pos, _ in chunk)
    if not chunks:
        return orig.new_zeros((0, img_size, img_size, 3))
    inv = np.empty((len(tasks),), np.int64)
    inv[np.asarray(emit_pos, np.int64)] = np.arange(len(tasks))
    return torch.cat(chunks).index_select(
        0, torch.from_numpy(inv).to(orig.device))


def balance_to_device(
    source_dir: str | Path,
    img_size: int,
    seed: int = 42,
    target_dir: str | Path = "augmented_directory",
    manifest_out_dir: str | Path = "artifacts/datasets",
    decode_workers: int = 8,
    device_batch: int = DEVICE_BATCH,
    materialize: bool = False,
    write_artifacts: bool = True,
    device: str | torch.device = "cuda",
    draw: Optional[Draw] = None,
) -> FusedBalanceResult:
    """Scan → plan → decode the originals once → augment on `device` →
    `manifest_augmented.json` (and the JPEG tree with `materialize`).
    `draw` replaces the port's own parameter draws (the parity tests hand
    in the JAX package's). Items are all split="train"; split them with
    `split_fused_result`. `stages` holds decode_s, upload_s and augment_s
    (the device synchronised at each boundary)."""
    t0 = time.perf_counter()
    device = torch.device(device)
    source_dir = Path(source_dir)
    target_dir = Path(target_dir)
    if not source_dir.exists():
        raise FileNotFoundError(f"Dataset directory not found: {source_dir}")
    items = scan_dataset(source_dir)
    if not items:
        raise ValueError(f"No images found under {source_dir}")
    plan = calculate_plan(count_by_plant_class(items))
    LOGGER.info("Fused balancing: %d originals, %d augmentations planned",
                len(items), sum(sum(t.values()) for t in plan.values()))

    orig, valid = decode_batch_with_fallback(
        [it.src for it in items], img_size, workers=decode_workers)
    keep = np.nonzero(valid)[0]
    if len(keep) == 0:
        raise ValueError(f"No decodable images under {source_dir} "
                         f"({len(items)} files all failed to decode)")
    if len(keep) < len(items):
        items = [items[i] for i in keep]
        orig = orig[keep]
    t_decoded = time.perf_counter()

    tasks = build_fused_tasks(items, plan, target_dir, seed)
    orig_dev = torch.from_numpy(np.ascontiguousarray(orig)).to(device)
    sync_device(device)
    t_uploaded = time.perf_counter()

    aug_dev = _augment_on_device(orig_dev, tasks, img_size, device_batch,
                                 draw or own_draws(seed))
    all_dev = torch.cat([orig_dev, aug_dev]) if tasks else orig_dev
    sync_device(device)
    t_augmented = time.perf_counter()
    stages = {"decode_s": t_decoded - t0, "upload_s": t_uploaded - t_decoded,
              "augment_s": t_augmented - t_uploaded}
    LOGGER.info("Fused balancing stages: decode %.2fs, upload %.0f MB in "
                "%.3fs, augment %d images in %.3fs", stages["decode_s"],
                orig.nbytes / 1e6, stages["upload_s"], len(tasks),
                stages["augment_s"])

    all_items = items + [t.item for t in tasks]
    label2idx = {lab: i for i, lab in
                 enumerate(sorted({it.label for it in all_items}))}
    labels = np.asarray([label2idx[it.label] for it in all_items], np.int32)

    if write_artifacts:
        manifest_out_dir = Path(manifest_out_dir)
        manifest_out_dir.mkdir(parents=True, exist_ok=True)
        aug_manifest = {
            "meta": {
                "created_at": None,
                "augmented_at": datetime.now(timezone.utc).isoformat(),
                "original_seed": None,
                "augmentation_seed": seed,
                "workers": 1,
                "src_root": str(target_dir),
                "total_images": len(all_items),
                "original_images": len(items),
                "augmented_images": len(tasks),
                "fused_device_resident": not materialize,
            },
            "items": [it.to_json() for it in all_items],
        }
        with (manifest_out_dir / "manifest_augmented.json").open(
                "w", encoding="utf-8") as f:
            json.dump(aug_manifest, f, indent=2, ensure_ascii=False)
        if materialize:
            _materialize_jpegs(all_dev[len(items):], tasks, source_dir,
                               target_dir)

    dt = time.perf_counter() - t0
    LOGGER.info("Fused balancing complete: %d generated on %s in %.1fs "
                "(%.1f img/s)", len(tasks), device, dt,
                len(tasks) / max(dt, 1e-9))
    return FusedBalanceResult(
        items=all_items, labels=labels, label2idx=label2idx,
        device_images=all_dev, n_original=len(items),
        n_generated=len(tasks), balance_time_s=dt, stages=stages)


def _materialize_jpegs(aug_dev: torch.Tensor, tasks: List[FusedTask],
                       source_dir: Path, target_dir: Path) -> None:
    """The classic balancer's tree: the originals copied, the augmented
    rows JPEG-encoded under their task names."""
    if target_dir.exists():
        shutil.rmtree(target_dir)
    shutil.copytree(source_dir, target_dir)
    if not tasks:
        return
    aug_np = aug_dev.cpu().numpy()

    def _write(i: int) -> None:
        ImageLoader.save_array(aug_np[i], Path(tasks[i].item.src))

    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(_write, range(len(tasks))))
    LOGGER.info("Materialized %d augmented JPEGs to %s", len(tasks),
                target_dir)


def split_fused_result(result: FusedBalanceResult, val_ratio: float = 0.2,
                       split_seed: int = 32,
                       manifest_out_dir: str | Path = "artifacts/datasets",
                       src_root: str | Path = "augmented_directory",
                       write_artifacts: bool = True
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """In-memory split over the balanced items, with the split CLI's ratio
    allocator and seeded shuffle, writing `manifest_split.json` and
    `split_summary.csv` (unless `write_artifacts` is False). Sets
    `result.items` to the split items.

    → (train_rows, val_rows): int32 row indices into
    `result.device_images` and `result.labels`."""
    grouped = group_by_label(result.items)
    alloc = allocate_validation_by_ratio(
        {lab: len(v) for lab, v in grouped.items()}, val_ratio)
    split_items = apply_split(result.items,
                              build_split_map(grouped, alloc, split_seed))

    if write_artifacts:
        manifest_out_dir = Path(manifest_out_dir)
        manifest_out_dir.mkdir(parents=True, exist_ok=True)
        save_manifest(manifest_out_dir / "manifest_split.json", {
            "created_at": datetime.now(timezone.utc).isoformat(),
            "seed": split_seed,
            "strategy": "ratio",
            "val_ratio": val_ratio,
            "src_root": str(src_root),
        }, split_items)
        write_summary(manifest_out_dir / "split_summary.csv", split_items)

    train_rows = np.asarray(
        [i for i, it in enumerate(split_items) if it.split == "train"],
        np.int32)
    val_rows = np.asarray(
        [i for i, it in enumerate(split_items) if it.split == "val"],
        np.int32)
    result.items = split_items
    return train_rows, val_rows
