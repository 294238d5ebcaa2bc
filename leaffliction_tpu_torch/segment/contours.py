"""Contour extraction + resampling — host-side, pure NumPy.

Copy of `leaffliction_tpu/segment/contours.py`. It replaces the viz-path
cv2.findContours/largest-contour helpers
(`srcs/cli/Transformation.py:283-321`). Contours feed only host-side drawing
(ROI rectangle, analyze overlay, landmark placement), so a NumPy Moore-
neighbor boundary trace keeps the core dependency-free; the on-device
pipeline never materializes contours.

Output format matches cv2: int32 array of shape [N, 1, 2] with (x, y) pairs,
traced counter-clockwise from the topmost-leftmost foreground pixel.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

# Moore neighborhood in clockwise order starting from W
_NEIGHBORS = np.array([
    (0, -1), (-1, -1), (-1, 0), (-1, 1),
    (0, 1), (1, 1), (1, 0), (1, -1),
], np.int32)


def trace_boundary(mask: np.ndarray, max_steps: Optional[int] = None) -> np.ndarray:
    """Moore-neighbor boundary trace of the first foreground region found in
    raster order. → [N, 2] (y, x) points."""
    mask = np.asarray(mask, bool)
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return np.zeros((0, 2), np.int32)
    # topmost, then leftmost start pixel
    start_idx = np.lexsort((xs, ys))[0]
    start = (int(ys[start_idx]), int(xs[start_idx]))
    h, w = mask.shape
    max_steps = max_steps or (4 * (h + w) + 4 * int(mask.sum()))

    def is_fg(p) -> bool:
        y, x = p
        return 0 <= y < h and 0 <= x < w and mask[y, x]

    boundary: List[tuple] = [start]
    # radial sweep: search the Moore neighborhood clockwise; after moving in
    # direction d, restart the sweep at (d + 6) % 8 (the neighbor 90° behind)
    search_start = 0  # W — guaranteed background for a topmost-leftmost start
    cur = start
    for _ in range(max_steps):
        found = False
        for k in range(8):
            d = (search_start + k) % 8
            ny = cur[0] + _NEIGHBORS[d][0]
            nx = cur[1] + _NEIGHBORS[d][1]
            if is_fg((ny, nx)):
                cur = (ny, nx)
                search_start = (d + 6) % 8
                found = True
                break
        if not found:  # isolated pixel
            break
        if cur == start and len(boundary) > 1:
            break
        boundary.append(cur)
    return np.asarray(boundary, np.int32)


def largest_contour_points(mask: np.ndarray) -> Optional[np.ndarray]:
    """cv2-style [N,1,2] (x,y) contour of the largest connected component,
    or None for an empty mask."""
    mask = np.asarray(mask, bool)
    if not mask.any():
        return None
    comp = _largest_component_np(mask)
    pts_yx = trace_boundary(comp)
    if len(pts_yx) == 0:
        return None
    pts_xy = pts_yx[:, ::-1]
    return pts_xy.reshape(-1, 1, 2).astype(np.int32)


def _largest_component_np(mask: np.ndarray) -> np.ndarray:
    """4/8-connected largest component via BFS flood fill (NumPy/deque)."""
    from collections import deque

    h, w = mask.shape
    labels = np.zeros((h, w), np.int32)
    next_label = 0
    best_label, best_size = 0, 0
    offs = [(-1, -1), (-1, 0), (-1, 1), (0, -1),
            (0, 1), (1, -1), (1, 0), (1, 1)]
    for sy, sx in zip(*np.nonzero(mask)):
        if labels[sy, sx]:
            continue
        next_label += 1
        size = 0
        q = deque([(sy, sx)])
        labels[sy, sx] = next_label
        while q:
            y, x = q.popleft()
            size += 1
            for dy, dx in offs:
                ny, nx = y + dy, x + dx
                if (0 <= ny < h and 0 <= nx < w and mask[ny, nx]
                        and not labels[ny, nx]):
                    labels[ny, nx] = next_label
                    q.append((ny, nx))
        if size > best_size:
            best_size, best_label = size, next_label
    return labels == best_label


def contour_area(contour: np.ndarray) -> float:
    """Shoelace area, cv2.contourArea-compatible for [N,1,2] input."""
    pts = contour.reshape(-1, 2).astype(np.float64)
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def bounding_rect_np(contour: np.ndarray):
    pts = contour.reshape(-1, 2)
    x0, y0 = pts.min(axis=0)
    x1, y1 = pts.max(axis=0)
    return int(x0), int(y0), int(x1 - x0 + 1), int(y1 - y0 + 1)


def resample_contour(contour: np.ndarray, n: int) -> np.ndarray:
    """Arc-length uniform resampling to n points
    (`srcs/cli/Transformation.py:301-321` semantics), vectorized."""
    pts = contour.reshape(-1, 2).astype(np.float64)
    if len(pts) == 0:
        return np.zeros((0, 2))
    if not (pts[0] == pts[-1]).all():
        pts = np.vstack([pts, pts[0]])
    seg = np.linalg.norm(pts[1:] - pts[:-1], axis=1)
    cum = np.concatenate([[0.0], seg.cumsum()])
    total = cum[-1]
    if total == 0:
        return pts[:n]
    targets = np.linspace(0, total, num=n, endpoint=False)
    idx = np.searchsorted(cum, targets, side="right") - 1
    idx = np.clip(idx, 0, len(seg) - 1)
    dt = seg[idx]
    frac = np.where(dt > 0, (targets - cum[idx]) / np.where(dt > 0, dt, 1.0), 0.0)
    return (1 - frac)[:, None] * pts[idx] + frac[:, None] * pts[idx + 1]
