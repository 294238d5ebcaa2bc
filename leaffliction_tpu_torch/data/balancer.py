"""Class-balancing: the plan and the JPEG-materialising balancer.

Port of `leaffliction_tpu/data/balancer.py`. The plan (per plant, each
class's deficit to the plant's largest class, split evenly over the six
transforms with the remainder to the first ones), the task list
(`random.Random(seed)`: a source per task, names
`<stem>_aug_<op>_<i><suffix>`, a task seed; classes keyed by directory
name across plants, as the reference keys them) and the augmented manifest
are the JAX package's. `DatasetBalancer` copies the tree, then executes the
tasks on the device:

    decode each unique source once at its own size (8 threads; the native
    decoder when built and LEAF_NATIVE_DECODE allows it, else PIL)
      → group the tasks by (transform, shape); upload one uint8 pool per
        shape
      → chunks of 64: gather the sources by index, draw the parameters
        (`draw`; the port's own by default), run the batch op (rotate: K2,
        whose canvas is cropped on the host to `pil_expanded_size` of the
        f32 angle K2 was given; shear: K3; distortion under
        LEAF_PALLAS_DISTORT=1: K6)
      → copy each chunk into pinned host memory (non_blocking, an event a
        chunk, at most PIPELINE_DEPTH chunks in flight)
      → JPEG q95 on 8 threads.

`LEAF_BALANCE_BACKEND=host` runs the same tasks on the host pool
(`data/host_augment.py`). Each task draws from its own generator seeded
with (seed, task_seed) (`task_rngs`, shared with the fused path), so the
pixels depend on the seed and the task, not on the chunking.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import random
import shutil
import time
from collections import defaultdict, deque
from dataclasses import dataclass
from datetime import datetime, timezone
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from leaffliction_tpu_torch.core.device import resolve_device
from leaffliction_tpu_torch.core.logging import get_logger
from leaffliction_tpu_torch.data import native
from leaffliction_tpu_torch.data.host_augment import (
    execute_tasks_host,
    resolve_backend,
)
from leaffliction_tpu_torch.data.scan import (
    count_by_plant_class,
    scan_dataset,
)
from leaffliction_tpu_torch.ops.augment import (
    BATCH_KERNELS,
    DRAWS,
    pil_expanded_size,
)

LOGGER = get_logger(__name__)

TRANSFORMATIONS = ("flip", "rotate", "skew", "shear", "crop", "distortion")
DEVICE_BATCH = 64
PIPELINE_DEPTH = 8

# (transform, tasks of one chunk, (h, w), device) → the op's parameters
Draw = Callable[[str, list, Tuple[int, int], torch.device],
                Dict[str, object]]


@dataclass
class AugTask:
    source_img: Path
    output_path: Path
    transform: str
    task_seed: int


def calculate_plan(counts: Dict[str, Dict[str, int]]
                   ) -> Dict[str, Dict[str, int]]:
    """class → {transform: count}; deficit split //6 with remainder to the
    first transforms."""
    deficits: Dict[str, int] = {}
    for _plant, classes in counts.items():
        plant_max = max(classes.values())
        for class_name, count in classes.items():
            deficit = plant_max - count
            if deficit > 0:
                deficits[class_name] = deficit
    plan: Dict[str, Dict[str, int]] = {}
    for class_name, deficit in deficits.items():
        base, remainder = divmod(deficit, 6)
        plan[class_name] = {}
        for i, transform in enumerate(TRANSFORMATIONS):
            n = base + (1 if i < remainder else 0)
            if n > 0:
                plan[class_name][transform] = n
    return plan


def task_rng(seed: int, task_seed: int) -> np.random.Generator:
    """A task's generator, seeded with (seed, task_seed) only."""
    return np.random.default_rng([seed % 2 ** 64, task_seed])


def task_rngs(seed: int, tasks) -> List[np.random.Generator]:
    """One generator per task (`task_rng`)."""
    return [task_rng(seed, t.task_seed) for t in tasks]


def own_draws(seed: int) -> Draw:
    def draw(transform, tasks, hw, device):
        return DRAWS[transform](task_rngs(seed, tasks), hw, device)

    return draw


def crop_canvas(canvas: np.ndarray, angle_deg: float, h: int, w: int
                ) -> np.ndarray:
    """The centre of K2's canvas at PIL's expanded size for `angle_deg`."""
    ew, eh = pil_expanded_size(angle_deg, w, h)
    top = max((canvas.shape[0] - eh) // 2, 0)
    left = max((canvas.shape[1] - ew) // 2, 0)
    return canvas[top:top + eh, left:left + ew]


def sync_device(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A CPU tensor as it is; a CUDA one copied into pinned memory on the
    current stream, without waiting (read it after an event on that
    stream)."""
    if t.device.type == "cpu":
        return t
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return buf.copy_(t, non_blocking=True)


class DatasetBalancer:
    """Balance `source_dir` into `target_dir` (a copy of the tree plus the
    augmented JPEGs) and write `manifest_augmented.json` into
    `manifest_out_dir`. `device` is resolved by `core/device.resolve_device`
    (cuda by default: it raises without CUDA); `draw` replaces the port's
    own parameter draws (the parity tests hand in the JAX package's);
    `on_array(task, uint8 [h, w, 3])` sees each generated image before its
    encode. After `run`, `stages` holds the seconds of each stage and the
    counts."""

    def __init__(
        self,
        source_dir: str | Path = "images",
        target_dir: str | Path = "augmented_directory",
        seed: int = 42,
        manifest_out_dir: Optional[Path] = None,
        device: str | torch.device = "cuda",
        draw: Optional[Draw] = None,
        on_array: Optional[Callable[[AugTask, np.ndarray], None]] = None,
    ) -> None:
        self.source_dir = Path(source_dir)
        self.target_dir = Path(target_dir)
        self.seed = seed
        self.manifest_out_dir = Path(manifest_out_dir or "artifacts/datasets")
        self.device = resolve_device(device)
        self.draw = draw or own_draws(seed)
        self.on_array = on_array
        self.counts: Dict[str, Dict[str, int]] = {}
        self.plan: Dict[str, Dict[str, int]] = {}
        self.stages: Dict[str, float] = {}

    # --- analysis / planning ----------------------------------------------

    def analyze_distribution(self) -> Dict[str, Dict[str, int]]:
        if not self.source_dir.exists():
            raise FileNotFoundError(
                f"Dataset directory not found: {self.source_dir}")
        self.counts = count_by_plant_class(scan_dataset(self.source_dir))
        for plant, classes in sorted(self.counts.items()):
            LOGGER.info("%s:", plant)
            for cls, n in sorted(classes.items()):
                LOGGER.info("  %s: %d images", cls, n)
        return self.counts

    def calculate_plan(self) -> Dict[str, Dict[str, int]]:
        self.plan = calculate_plan(self.counts)
        if not self.plan:
            LOGGER.info("Dataset already balanced - no augmentations needed")
        for class_name, transforms in sorted(self.plan.items()):
            LOGGER.info("  Class: %s - %d images needed", class_name,
                        sum(transforms.values()))
        return self.plan

    # --- execution ---------------------------------------------------------

    def _prepare_target_directory(self) -> None:
        LOGGER.info("Preparing target directory: %s", self.target_dir)
        if self.target_dir.exists():
            shutil.rmtree(self.target_dir)
        shutil.copytree(self.source_dir, self.target_dir)

    def _build_tasks(self) -> List[AugTask]:
        rng = random.Random(self.seed)
        images_by_class: Dict[str, List[Path]] = defaultdict(list)
        for plant_dir in self.target_dir.iterdir():
            if not plant_dir.is_dir():
                continue
            for class_dir in plant_dir.iterdir():
                if not class_dir.is_dir():
                    continue
                images = sorted(
                    p for p in class_dir.iterdir()
                    if p.suffix.lower() == ".jpg"
                )
                images_by_class[class_dir.name] = images

        tasks: List[AugTask] = []
        for class_name, transforms in self.plan.items():
            source_images = images_by_class.get(class_name, [])
            if not source_images:
                LOGGER.warning("No images found for class '%s'", class_name)
                continue
            class_dir = source_images[0].parent
            for transform, count in transforms.items():
                for i in range(count):
                    src = rng.choice(source_images)
                    name = f"{src.stem}_aug_{transform}_{i + 1}{src.suffix}"
                    tasks.append(AugTask(
                        source_img=src,
                        output_path=class_dir / name,
                        transform=transform,
                        task_seed=rng.randint(0, 1_000_000),
                    ))
        return tasks

    def _execute_tasks(self, tasks: List[AugTask]) -> Tuple[int, int]:
        from PIL import Image

        if resolve_backend() == "host":
            LOGGER.info("Executing %d tasks on the host pool backend",
                        len(tasks))
            t0 = time.perf_counter()
            done = execute_tasks_host(tasks, self.seed)
            self.stages["host_pool_s"] = time.perf_counter() - t0
            return done

        use_native = native.native_enabled()

        def read_rgb(path: Path) -> np.ndarray:
            if use_native:
                return native.decode_full(str(path))
            with Image.open(path) as im:
                return np.asarray(im.convert("RGB"), np.uint8)

        def write_jpeg(path: Path, arr: np.ndarray) -> bool:
            try:
                if use_native:
                    native.encode(str(path), arr, 95)
                else:
                    Image.fromarray(arr).save(path, quality=95)
                return True
            except Exception as exc:
                LOGGER.error("Failed: %s (%s)", path, exc)
                return False

        total = len(tasks)
        device = self.device
        LOGGER.info("Starting batched augmentation on %s: %d images to "
                    "generate", device, total)

        # decode unique sources on a thread pool (JPEG codecs release the GIL)
        t0 = time.perf_counter()
        unique_srcs = list({t.source_img for t in tasks})
        decoded: Dict[Path, Optional[np.ndarray]] = {}

        def _decode(path: Path) -> None:
            try:
                decoded[path] = read_rgb(path)
            except Exception as exc:
                LOGGER.error("Failed to read %s: %s", path, exc)
                decoded[path] = None

        with cf.ThreadPoolExecutor(max_workers=8) as pool:
            list(pool.map(_decode, unique_srcs))
        t_decoded = time.perf_counter()

        # group by (transform, source image shape) for static-shape batching
        groups: Dict[tuple, List[AugTask]] = defaultdict(list)
        completed = failed = 0
        for task in tasks:
            arr = decoded.get(task.source_img)
            if arr is None:
                failed += 1
                continue
            groups[(task.transform, arr.shape)].append(task)

        # one uint8 pool per shape on the device: tasks re-pick the same
        # sources, so each unique source is uploaded once and the chunks
        # are gathered from it by index
        srcs_by_shape: Dict[tuple, set] = defaultdict(set)
        for (_transform, shape), group in groups.items():
            srcs_by_shape[shape].update(t.source_img for t in group)
        pools: Dict[tuple, tuple] = {}
        for shape, paths in srcs_by_shape.items():
            uniq = sorted(paths)
            host = torch.from_numpy(np.stack([decoded[p] for p in uniq]))
            if device.type == "cuda":
                host = host.pin_memory()
            pools[shape] = (host.to(device, non_blocking=True),
                            {p: i for i, p in enumerate(uniq)})
        sync_device(device)
        t_uploaded = time.perf_counter()

        # windowed pipeline: up to PIPELINE_DEPTH chunks in flight, so the
        # kernels and downloads overlap the encodes (8 writer threads)
        pending: deque = deque()
        write_futures: List[cf.Future] = []
        wait_s = 0.0

        def collect_one(writer: cf.Executor) -> None:
            nonlocal wait_s
            chunk, (h0, w0), out, angles, event = pending.popleft()
            if event is not None:
                t_wait = time.perf_counter()
                event.synchronize()
                wait_s += time.perf_counter() - t_wait
            out = out.numpy()
            for j, task in enumerate(chunk):
                img = out[j]
                if angles is not None:
                    img = crop_canvas(img, float(angles[j]), h0, w0)
                if self.on_array is not None:
                    self.on_array(task, img)
                write_futures.append(
                    writer.submit(write_jpeg, task.output_path, img))
                if len(write_futures) % 500 == 0:
                    LOGGER.info("Progress: %d/%d (%.1f%%) dispatched to "
                                "encode", len(write_futures), total,
                                100.0 * len(write_futures) / max(total, 1))

        with cf.ThreadPoolExecutor(max_workers=8) as writer:
            for (transform, shape), group in groups.items():
                op = BATCH_KERNELS[transform]
                pool_dev, src_idx = pools[shape]
                for start in range(0, len(group), DEVICE_BATCH):
                    chunk = group[start:start + DEVICE_BATCH]
                    sel = torch.tensor([src_idx[t.source_img]
                                        for t in chunk], device=device)
                    params = self.draw(transform, chunk, shape[:2], device)
                    out = op(pool_dev.index_select(0, sel), **params)
                    angles = (_to_host(params["angles"])
                              if transform == "rotate" else None)
                    out = _to_host(out)
                    event = None
                    if device.type == "cuda":
                        event = torch.cuda.Event()
                        event.record()
                    pending.append((chunk, shape[:2], out, angles, event))
                    if len(pending) > PIPELINE_DEPTH:
                        collect_one(writer)
            while pending:
                collect_one(writer)
            t_dispatched = time.perf_counter()
            for fut in write_futures:
                if fut.result():
                    completed += 1
                else:
                    failed += 1
        t_encoded = time.perf_counter()
        self.stages.update(
            decode_s=t_decoded - t0, upload_s=t_uploaded - t_decoded,
            device_s=t_dispatched - t_uploaded, download_wait_s=wait_s,
            encode_s=t_encoded - t_dispatched, sources=len(unique_srcs),
            groups=len(groups))
        LOGGER.info("Augmentation complete: %d images generated, %d failed",
                    completed, failed)
        return completed, failed

    def _generate_augmented_manifest(self) -> Path:
        """Rescan target → manifest_augmented.json (the reference schema)."""
        items = []
        for it in scan_dataset(self.target_dir):
            items.append({
                "plant": it.plant,
                "class": it.cls,
                "label": it.label,
                "split": "train",
                "src": it.src,
                "id": it.id,
                "augmented": it.augmented,
            })
        manifest = {
            "meta": {
                "created_at": None,
                "augmented_at": datetime.now(timezone.utc).isoformat(),
                "original_seed": None,
                "augmentation_seed": self.seed,
                "workers": 1,
                "src_root": str(self.target_dir),
                "total_images": len(items),
                "original_images": len([i for i in items if not i["augmented"]]),
                "augmented_images": len([i for i in items if i["augmented"]]),
            },
            "items": items,
        }
        self.manifest_out_dir.mkdir(parents=True, exist_ok=True)
        out_path = self.manifest_out_dir / "manifest_augmented.json"
        with out_path.open("w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=2, ensure_ascii=False)
        LOGGER.info("Augmented manifest saved: %s", out_path)
        LOGGER.info("  Total images: %d", manifest["meta"]["total_images"])
        LOGGER.info("  Original: %d", manifest["meta"]["original_images"])
        LOGGER.info("  Augmented: %d", manifest["meta"]["augmented_images"])
        return out_path

    def run(self) -> Dict[str, float]:
        """Analyse, plan, copy, generate, write the manifest → `stages`."""
        LOGGER.info("=== Dataset Balancing System ===")
        t0 = time.perf_counter()
        self.stages = {}
        self.analyze_distribution()
        self.calculate_plan()
        if self.plan:
            self._prepare_target_directory()
            t_copied = time.perf_counter()
            tasks = self._build_tasks()
            n_done, n_failed = self._execute_tasks(tasks)
            t_done = time.perf_counter()
            self._generate_augmented_manifest()
            dt = time.perf_counter() - t0
            self.stages.update(copy_s=t_copied - t0,
                               generate_s=t_done - t_copied,
                               manifest_s=time.perf_counter() - t_done,
                               wall_s=dt, generated=n_done, failed=n_failed)
            LOGGER.info("=== Balancing Complete (%d images in %.1fs, "
                        "%.1f img/s) ===", n_done, dt, n_done / max(dt, 1e-9))
        else:
            self.stages.update(wall_s=time.perf_counter() - t0, generated=0,
                               failed=0)
            LOGGER.info("=== Balancing Complete ===")
        return self.stages
