"""`python -m leaffliction_tpu_torch.cli.transform` — the PlantCV-style
analysis filters, on one CUDA device (or the CPU, when asked for by name).

Port of `leaffliction_tpu/cli/transform.py`: the same flags plus `--device`
(cuda by default; `core/device.py`), the same `<stem>__T_<Type>.jpg` names
and 3-column mosaic. Single-image mode writes to
artifacts/transformations/<N>/ (`--preview` always rewrites and prints the
paths). Folder mode (-src/-dst) runs in two phases: the masks of every image
in device chunks of 16 per image shape (`segment/mask.make_mask_batch_async`:
one K4 or K5 launch per step for the whole chunk; no GrabCut, as in the JAX
CLI), then the filters dispatched over windows of 32 images before any is
read back, drawn and encoded. `main` returns the folder run's image count
and stage seconds (decode, masks, filters, encode) for the caller to log.
"""

from __future__ import annotations

import argparse
import re
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from leaffliction_tpu_torch.core.logging import get_logger, setup_logging
from leaffliction_tpu_torch.segment.config import (
    TransformConfig,
    default_config_path,
    load_config,
)

LOGGER = get_logger(__name__)

IMAGE_EXTS = {".jpg"}
DEFAULT_TYPES = ("Blur", "Mask", "ROI", "Analyze", "Landmarks", "Hist", "Brown")
CANONICAL_TYPES: Dict[str, str] = {
    "blur": "Blur", "mask": "Mask", "roi": "ROI", "analyze": "Analyze",
    "analyse": "Analyze", "landmarks": "Landmarks",
    "pseudolandmarks": "Landmarks", "pseudo-landmarks": "Landmarks",
    "hist": "Hist", "histogram": "Hist", "brown": "Brown",
    "disease": "Brown", "spots": "Brown",
}
MASK_TYPES = {"Mask", "ROI", "Analyze", "Landmarks", "Brown", "Blur"}
DEVICE_BATCH, WINDOW = 16, 32


@dataclass(frozen=True)
class ProcessArgs:
    img_path: Path
    out_dir: Path
    types: Tuple[str, ...]
    cfg: TransformConfig
    skip_existing: bool = False
    overwrite: bool = False
    device: object = "cuda"
    stage_s: Dict[str, float] = field(default_factory=dict, compare=False)


def is_image(path: Path) -> bool:
    return path.is_file() and path.suffix.lower() in IMAGE_EXTS


def build_types_filter(arg: Optional[str]) -> Tuple[str, ...]:
    if not arg:
        return DEFAULT_TYPES
    result: List[str] = []
    for item in str(arg).split(","):
        key = item.strip().lower()
        if not key:
            continue
        if key in CANONICAL_TYPES:
            name = CANONICAL_TYPES[key]
            if name not in result:
                result.append(name)
        else:
            LOGGER.warning("Unknown transform type skipped: %s", item.strip())
    return tuple(result) if result else DEFAULT_TYPES


def output_names(stem: str) -> Dict[str, str]:
    return {t: f"{stem}__T_{t}.jpg" for t in DEFAULT_TYPES}


def pil_read_rgb(path: Path) -> np.ndarray:
    from PIL import Image, ImageOps

    with Image.open(path) as im:
        im = ImageOps.exif_transpose(im)
        return np.array(im.convert("RGB"), np.uint8)


def imwrite_rgb(path: Path, rgb: Optional[np.ndarray]) -> None:
    if rgb is None:
        return
    from PIL import Image

    path.parent.mkdir(parents=True, exist_ok=True)
    arr = np.asarray(rgb)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    Image.fromarray(arr.astype(np.uint8)).save(path, quality=95)


def create_mosaic(original_rgb: np.ndarray,
                  filter_results: Dict[str, np.ndarray]) -> np.ndarray:
    """3-column grid, 300px tiles, dimmed title bars
    (`Transformation.py:208-263`); the tiles are resized on the host."""
    import torch

    from leaffliction_tpu_torch.ops.image import resize
    from leaffliction_tpu_torch.utils import draw

    target = 300

    def tile(img: np.ndarray) -> np.ndarray:
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, -1)
        out = resize(torch.from_numpy(arr.astype(np.float32)),
                     (target, target, 3), "linear").numpy()
        return np.clip(np.round(out), 0, 255).astype(np.uint8)

    images = [("Original", tile(original_rgb))]
    images += [(name, tile(img)) for name, img in filter_results.items()
               if img is not None]

    cols = 3
    rows = (len(images) + cols - 1) // cols
    mosaic = np.zeros((rows * target, cols * target, 3), np.uint8)
    for idx, (title, img) in enumerate(images):
        r, c = divmod(idx, cols)
        y, x = r * target, c * target
        mosaic[y:y + target, x:x + target] = img
        # dimmed title bar + white text
        bar = mosaic[y:y + 25, x:x + target].astype(np.float32)
        mosaic[y:y + 25, x:x + target] = (bar * 0.7).astype(np.uint8)
        mosaic = draw.text(mosaic, title, (x + 10, y + 6), (255, 255, 255))
    return mosaic


class TransformPipeline:
    """Filter dispatch bound to one config and device (reference
    `TransformPipeline`, `Transformation.py:326-390`)."""

    def __init__(self, cfg: TransformConfig, device="cuda") -> None:
        self.cfg = cfg
        self.device = device

    def _dev(self, arr):
        import torch

        return torch.tensor(np.asarray(arr)).to(self.device)

    def make_mask(self, rgb: np.ndarray):
        from leaffliction_tpu_torch.segment.mask import make_mask

        return make_mask(rgb, self.cfg, self.device)

    def create_masked_rgb(self, rgb, mask):
        from leaffliction_tpu_torch.segment.mask import apply_mask_white

        if mask is None:
            return rgb
        out = apply_mask_white(self._dev(rgb), self._dev(mask > 0))
        return np.clip(out.cpu().numpy(), 0, 255).astype(np.uint8)

    def mask_vis(self, rgb, mask):
        """Black-background masked RGB (`mask.py:585-607`)."""
        from leaffliction_tpu_torch.segment.mask import apply_mask_black

        out = apply_mask_black(self._dev(rgb), self._dev(mask > 0))
        return np.clip(out.cpu().numpy(), 0, 255).astype(np.uint8)

    def blur(self, rgb, mask):
        from leaffliction_tpu_torch.segment.blur import blur_filter

        out = blur_filter(self._dev(rgb), self._dev(mask > 0), self.cfg)
        return out.cpu().numpy().astype(np.uint8)

    def pseudolandmarks(self, rgb, contour):
        from leaffliction_tpu_torch.segment.landmarks import landmarks_filter

        return landmarks_filter(rgb, contour, self.cfg, self.make_mask,
                                self.device)


def dispatch_filters(rgb_dev, mask_img, contour, types, cfg
                     ) -> Dict[str, object]:
    """Phase 1 of the folder pipeline: queue every device computation the
    selected filters need for one image (uint8 [h, w, 3] on the device),
    reading nothing back, so a window of images queues before any is
    drawn. `apply_mask_white` over uint8 gives integral float32, so the
    filters see the same values as the uint8 `masked_rgb` of phase 2."""
    import torch

    from leaffliction_tpu_torch.segment.analyze import analyze_dispatch
    from leaffliction_tpu_torch.segment.blur import blur_filter
    from leaffliction_tpu_torch.segment.brown import brown_regions
    from leaffliction_tpu_torch.segment.hist import hist_dispatch
    from leaffliction_tpu_torch.segment.landmarks import landmarks_dispatch
    from leaffliction_tpu_torch.segment.mask import (
        apply_mask_black,
        apply_mask_white,
    )
    from leaffliction_tpu_torch.segment.roi import roi_dispatch

    handles: Dict[str, object] = {}
    if mask_img is None:
        return handles
    mask_dev = torch.from_numpy(mask_img > 0).to(rgb_dev.device)
    masked_dev = apply_mask_white(rgb_dev, mask_dev)  # integral f32
    handles["masked"] = masked_dev
    if "Mask" in types:
        handles["maskvis"] = apply_mask_black(rgb_dev, mask_dev)
    if "Blur" in types:
        handles["blur"] = blur_filter(masked_dev, mask_dev, cfg)
    if "ROI" in types:
        handles["roi"] = roi_dispatch(masked_dev, contour, cfg)
    if "Analyze" in types:
        handles["edges"] = analyze_dispatch(masked_dev)
    if "Landmarks" in types:
        handles["lm"] = landmarks_dispatch(
            masked_dev, contour, cfg, lambda _rgb: (mask_img, contour),
            rgb_dev.device)
    if "Hist" in types:
        handles["stats"] = hist_dispatch(masked_dev)
    if "Brown" in types:
        handles["brown"] = brown_regions(masked_dev, mask_dev, cfg)
    return handles


def process_single_image(params: ProcessArgs, rgb=None,
                         precomputed_mask=None, handles=None) -> List[Path]:
    """Run the selected filters for one image.

    `precomputed_mask` is an optional (mask, contour) pair (folder mode
    computes the masks of the whole directory in device chunks first);
    `handles` is the optional output of `dispatch_filters`, with which this
    function only reads back, draws and saves (phase 2). The seconds spent
    encoding go to `params.stage_s["encode"]`."""
    if rgb is None:
        try:
            rgb = pil_read_rgb(params.img_path)
        except Exception as exc:
            LOGGER.error("Failed to read %s (%s)", params.img_path, exc)
            return []

    cfg, device = params.cfg, params.device
    pipe = TransformPipeline(cfg, device)
    saved: List[Path] = []
    filter_results: Dict[str, np.ndarray] = {}
    names = output_names(params.img_path.stem)

    def want_write(out: Path) -> bool:
        return params.overwrite or (not params.skip_existing or not out.exists())

    def save(out: Path, img) -> None:
        t0 = time.perf_counter()
        imwrite_rgb(out, img)
        params.stage_s["encode"] = (params.stage_s.get("encode", 0.0)
                                    + time.perf_counter() - t0)
        saved.append(out)

    def emit(kind: str, img) -> None:
        filter_results[kind] = img
        out = params.out_dir / names[kind]
        if want_write(out):
            save(out, img)

    mask_img = contour = None
    masked_rgb = rgb
    if set(params.types) & MASK_TYPES:
        if precomputed_mask is not None:
            mask_img, contour = precomputed_mask
            pipe.make_mask = lambda _rgb: (mask_img, contour)  # reuse below
        else:
            mask_img, contour = pipe.make_mask(rgb)
        if mask_img is not None:
            if handles is not None and "masked" in handles:
                masked_rgb = np.clip(np.round(
                    handles["masked"].cpu().numpy()), 0, 255).astype(np.uint8)
            else:
                masked_rgb = pipe.create_masked_rgb(rgb, mask_img)
    handles = handles or {}

    if "Mask" in params.types:
        if mask_img is None:
            vis = rgb
        elif "maskvis" in handles:
            vis = np.clip(handles["maskvis"].cpu().numpy(), 0, 255
                          ).astype(np.uint8)
        else:
            vis = pipe.mask_vis(rgb, mask_img)
        emit("Mask", vis)

    if "Blur" in params.types and mask_img is not None:
        if "blur" in handles:
            img = handles["blur"].cpu().numpy().astype(np.uint8)
        else:
            img = pipe.blur(masked_rgb, mask_img)
        emit("Blur", img)

    if "ROI" in params.types:
        from leaffliction_tpu_torch.segment.roi import roi_filter

        _, roi_vis, _ = roi_filter(masked_rgb, contour, cfg,
                                   dispatched=handles.get("roi"),
                                   device=device)
        emit("ROI", roi_vis if roi_vis is not None else masked_rgb)

    if "Analyze" in params.types:
        from leaffliction_tpu_torch.segment.analyze import analyze_filter

        emit("Analyze", analyze_filter(masked_rgb, mask_img, contour, cfg,
                                       edges=handles.get("edges"),
                                       device=device))

    if "Landmarks" in params.types:
        if "lm" in handles:
            from leaffliction_tpu_torch.segment.landmarks import (
                landmarks_finish,
            )

            img = landmarks_finish(masked_rgb, handles["lm"], cfg)
        else:
            img = pipe.pseudolandmarks(masked_rgb, contour)
        emit("Landmarks", img)

    if "Hist" in params.types:
        from leaffliction_tpu_torch.segment.hist import histogram_filter

        img = histogram_filter(masked_rgb, cfg, stats=handles.get("stats"),
                               device=device)
        if img is not None:  # None: no matplotlib, the stats were logged
            emit("Hist", img)

    if "Brown" in params.types and mask_img is not None:
        from leaffliction_tpu_torch.segment.brown import brown_filter

        img, pct, count = brown_filter(masked_rgb, mask_img > 0, cfg,
                                       regions=handles.get("brown"),
                                       device=device)
        LOGGER.info("Brown spots detected: %d regions, %.1f%% of leaf area",
                    count, pct)
        emit("Brown", img)

    if filter_results:
        match = re.search(r"image \((\d+)\)", params.img_path.stem)
        image_number = match.group(1) if match else params.img_path.stem
        mosaic_path = params.out_dir / f"image{image_number}_mosaic.jpg"
        save(mosaic_path, create_mosaic(rgb, filter_results))
        print(f"Mosaïque créée : {mosaic_path}")
    return saved


def _precompute_masks_batched(imgs: List[Path], cfg: TransformConfig,
                              device, stage_s: Dict[str, float],
                              device_batch: int = DEVICE_BATCH):
    """Folder-mode masks: decode on 8 threads, then segment in device
    chunks grouped by shape and trace the contours on the host. GrabCut is
    skipped on this path (a host step per image), as in the JAX CLI. →
    (decoded images, {path: (mask u8, contour)}), the decode and mask
    seconds added to `stage_s`."""
    import concurrent.futures as cf

    import torch

    from leaffliction_tpu_torch.ops.image import resize
    from leaffliction_tpu_torch.segment.contours import largest_contour_points
    from leaffliction_tpu_torch.segment.mask import (
        finalize_mask_batch,
        make_mask_batch_async,
        mask_scale,
    )

    t0 = time.perf_counter()
    decoded: Dict[Path, np.ndarray] = {}

    def _decode(p: Path) -> None:
        try:
            decoded[p] = pil_read_rgb(p)
        except Exception as exc:
            LOGGER.error("Failed to read %s (%s)", p, exc)

    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(_decode, imgs))
    t1 = time.perf_counter()
    stage_s["decode"] = stage_s.get("decode", 0.0) + t1 - t0

    by_shape: Dict[tuple, List[Path]] = {}
    for p in imgs:
        if p in decoded:
            by_shape.setdefault(decoded[p].shape, []).append(p)

    # queue every chunk before reading any mask back
    pending = []
    for shape, paths in by_shape.items():
        h, w = shape[0], shape[1]
        s = mask_scale(cfg, h, w)
        for start in range(0, len(paths), device_batch):
            chunk = paths[start:start + device_batch]
            dev = torch.from_numpy(np.stack([decoded[p] for p in chunk])
                                   ).to(device)
            if abs(s - 1.0) > 1e-6:
                dev = resize(dev, (dev.shape[0], int(round(h * s)),
                                   int(round(w * s)), 3), "cubic")
            mask_dev, scores = make_mask_batch_async(dev, cfg)
            pending.append((chunk, dev, mask_dev, scores, s, h, w))

    masks: Dict[Path, tuple] = {}
    for chunk, dev, mask_dev, scores, s, h, w in pending:
        mask_dev = finalize_mask_batch(dev, mask_dev, scores, cfg)
        if abs(s - 1.0) > 1e-6:
            mask_dev = resize(mask_dev.float(), (mask_dev.shape[0], h, w),
                              "nearest") > 0.5
        for p, m in zip(chunk, mask_dev.cpu().numpy()):
            masks[p] = (m.astype(np.uint8) * 255, largest_contour_points(m))
    stage_s["masks"] = stage_s.get("masks", 0.0) + time.perf_counter() - t1
    LOGGER.info("Precomputed %d masks in device chunks", len(masks))
    return decoded, masks


def iter_images_in_dir(src: Path):
    for p in sorted(src.rglob("*")):
        if is_image(p):
            yield p


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=("Image transformation pipeline (PyTorch/CUDA port). "
                     "Single image: transform path/to/image.jpg; "
                     "folder mode: -src DIR -dst OUTDIR"))
    p.add_argument("image", nargs="?", default=None)
    p.add_argument("--out-dir", default=None)
    p.add_argument("-src", "--src", default=None)
    p.add_argument("-dst", "--dst", default=None)
    p.add_argument("--types", default=",".join(DEFAULT_TYPES))
    p.add_argument("--config", default=None,
                   help="YAML config path (default: packaged config.yaml)")
    p.add_argument("--workers", type=int, default=0,
                   help="Kept for flag parity; compute is batched on device")
    p.add_argument("--skip-existing", action="store_true")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--preview", action="store_true",
                   help="Force saving outputs and printing their paths "
                        "(no GUI popups) — for stdout-parsing consumers")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without CUDA) or cpu")
    return p.parse_args(argv)


def _folder_mode(args, types, cfg, device) -> Optional[Dict[str, object]]:
    src, dst = Path(args.src), Path(args.dst)
    if not src.exists():
        LOGGER.error("Source directory does not exist: %s", src)
        return None
    dst.mkdir(parents=True, exist_ok=True)
    imgs = list(iter_images_in_dir(src))
    if not imgs:
        LOGGER.warning("No images found in %s", src)
        return None
    LOGGER.info("Found %d images in %s", len(imgs), src)
    import torch

    t_start = time.perf_counter()
    stage_s: Dict[str, float] = {"decode": 0.0, "masks": 0.0,
                                 "filters": 0.0, "encode": 0.0}
    decoded: Dict[Path, np.ndarray] = {}
    masks: Dict[Path, tuple] = {}
    if set(types) & MASK_TYPES:
        decoded, masks = _precompute_masks_batched(imgs, cfg, device,
                                                   stage_s)
    total_saved = 0
    t_filters = time.perf_counter()
    for start in range(0, len(imgs), WINDOW):
        chunk = imgs[start:start + WINDOW]
        dispatched = []
        for img_path in chunk:
            rgb, pm = decoded.get(img_path), masks.get(img_path)
            dispatched.append(None if rgb is None else dispatch_filters(
                torch.from_numpy(rgb).to(device), pm[0] if pm else None,
                pm[1] if pm else None, types, cfg))
        for img_path, handles in zip(chunk, dispatched):
            total_saved += len(process_single_image(
                ProcessArgs(img_path=img_path, out_dir=dst, types=types,
                            cfg=cfg, skip_existing=args.skip_existing,
                            overwrite=args.overwrite, device=device,
                            stage_s=stage_s),
                rgb=decoded.get(img_path),
                precomputed_mask=masks.get(img_path),
                handles=handles))
    stage_s["filters"] = (time.perf_counter() - t_filters
                          - stage_s["encode"])
    wall = time.perf_counter() - t_start
    LOGGER.info("Processed %d images, saved %d outputs in %.2fs (%s)",
                len(imgs), total_saved, wall,
                ", ".join(f"{k} {v:.2f}s" for k, v in stage_s.items()))
    return {"images": len(imgs), "saved": total_saved, "wall_s": wall,
            "stages": stage_s}


def main(argv=None) -> Optional[Dict[str, object]]:
    args = parse_args(argv)
    setup_logging()
    types = build_types_filter(args.types)
    cfg_path = Path(args.config) if args.config else default_config_path()
    cfg = load_config(cfg_path)

    from leaffliction_tpu_torch.core.device import resolve_device

    device = resolve_device(args.device)

    if args.image and not args.src and not args.dst:
        ip = Path(args.image)
        if not is_image(ip):
            LOGGER.error("Not a valid image: %s", ip)
            return None
        match = re.search(r"image \((\d+)\)", ip.stem)
        image_number = match.group(1) if match else ip.stem
        out_dir = (Path(args.out_dir) if args.out_dir
                   else Path("artifacts") / "transformations" / image_number)
        out_dir.mkdir(parents=True, exist_ok=True)
        # --preview: outputs are always (re)written and their paths printed
        saved = process_single_image(ProcessArgs(
            img_path=ip, out_dir=out_dir, types=types, cfg=cfg,
            skip_existing=args.skip_existing and not args.preview,
            overwrite=args.overwrite or args.preview, device=device))
        print(f"Saved {len(saved)} outputs to {out_dir}")
        for s in saved:
            print(f"  - {s}")
        return {"images": 1, "saved": len(saved)}

    if args.src and args.dst:
        return _folder_mode(args, types, cfg, device)

    LOGGER.error("Must specify either single image or --src/--dst for "
                 "folder mode")
    sys.exit(1)


if __name__ == "__main__":
    main()
