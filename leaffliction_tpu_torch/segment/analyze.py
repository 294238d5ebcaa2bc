"""Analyze filter — shape-analysis overlay (reference
`filters/analyze.py:20-124`).

Port of `leaffliction_tpu/segment/analyze.py`. Overlay: contour outline,
centroid cross, the 4 extreme points with rays, convex hull, PCA major and
minor axes, and Canny vein edges (80/160, L2, kernel K5) in cyan. The Canny
runs on the image's device; moments and PCA are NumPy on the contour;
drawing is PIL. `shape_metrics` exports the PlantCV-style metrics
(`pcv.analyze_object` equivalents) as a dict.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from leaffliction_tpu_torch.segment.config import TransformConfig
from leaffliction_tpu_torch.segment.contours import contour_area
from leaffliction_tpu_torch.utils import draw


def shape_metrics(mask: np.ndarray, contour: np.ndarray) -> Dict[str, float]:
    """Area/perimeter/centroid/axis metrics (pcv.analyze_object analog)."""
    pts = contour.reshape(-1, 2).astype(np.float64)
    seg = np.linalg.norm(np.roll(pts, -1, axis=0) - pts, axis=1)
    area = float(np.asarray(mask, bool).sum())
    hull = draw.convex_hull_points(pts)
    hull_area = contour_area(hull.reshape(-1, 1, 2)) if len(hull) >= 3 else 0.0
    centroid = pts.mean(axis=0)
    centered = pts - centroid
    cov = centered.T @ centered / max(len(pts), 1)
    evals, evecs = np.linalg.eigh(cov)
    order = np.argsort(evals)[::-1]
    evals, evecs = evals[order], evecs[:, order]
    return {
        "area": area,
        "perimeter": float(seg.sum()),
        "convex_hull_area": float(hull_area),
        "solidity": float(area / hull_area) if hull_area > 1 else 0.0,
        "centroid_x": float(centroid[0]),
        "centroid_y": float(centroid[1]),
        "major_axis_length": float(4.0 * np.sqrt(max(evals[0], 0.0))),
        "minor_axis_length": float(4.0 * np.sqrt(max(evals[1], 0.0))),
        "ellipse_angle": float(np.degrees(np.arctan2(evecs[1, 0], evecs[0, 0]))),
    }


def analyze_dispatch(rgb: torch.Tensor) -> torch.Tensor:
    """Phase 1: queue the device Canny (vein edges) of `rgb` (a tensor on
    its device) without reading it back."""
    from leaffliction_tpu_torch.ops.colorspace import rgb_to_gray
    from leaffliction_tpu_torch.ops.filters import canny

    return canny(rgb_to_gray(rgb.float()), 80, 160, l2=True)


def analyze_filter(
    rgb: np.ndarray,
    mask: Optional[np.ndarray],
    contour: Optional[np.ndarray],
    cfg: TransformConfig,
    edges=None,
    device="cuda",
) -> np.ndarray:
    """`edges`: optional pre-dispatched device Canny from
    `analyze_dispatch` (folder mode queues a window of images first)."""
    if contour is None or mask is None:
        return draw.text(np.asarray(rgb), "Analyze: no object", (10, 24))

    overlay = np.asarray(rgb, np.uint8).copy()
    pts = contour.reshape(-1, 2)

    # contour
    overlay = draw.polyline(overlay, pts, (255, 0, 0), width=2)

    # centroid via polygon moments (mask-mean, equivalent to cv2 moments of
    # the filled contour)
    mask_bool = np.asarray(mask) > 0
    ys, xs = np.nonzero(mask_bool)
    if len(xs):
        cx, cy = int(xs.mean()), int(ys.mean())
    else:
        cx, cy = int(pts[:, 0].mean()), int(pts[:, 1].mean())
    overlay = draw.cross_marker(overlay, (cx, cy), 14, (255, 255, 0))

    # extreme points + rays
    left = pts[pts[:, 0].argmin()]
    right = pts[pts[:, 0].argmax()]
    top = pts[pts[:, 1].argmin()]
    bottom = pts[pts[:, 1].argmax()]
    for p in (left, right, top, bottom):
        overlay = draw.circle(overlay, p, 3, (255, 255, 0))
        overlay = draw.line(overlay, (cx, cy), p, (255, 255, 0), 1)

    # convex hull
    hull = draw.convex_hull_points(pts)
    overlay = draw.polyline(overlay, hull, (0, 255, 0), width=1)

    # PCA axes
    data = pts.astype(np.float64)
    mean = data.mean(axis=0)
    centered = data - mean
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    for vec, color in ((vt[0], (255, 255, 0)), (vt[1], (255, 0, 255))):
        proj = centered @ vec
        p_min = data[proj.argmin()]
        p_max = data[proj.argmax()]
        overlay = draw.line(overlay, p_min, p_max, color, 2)

    # vein edges (device Canny 80/160 L2) in cyan inside the mask
    if edges is None:
        edges = analyze_dispatch(torch.as_tensor(np.asarray(rgb)).to(device))
    edges = edges.cpu().numpy()
    overlay = np.array(overlay)  # PIL-backed arrays are read-only
    overlay[edges & mask_bool] = (0, 255, 255)

    return overlay
