"""Host-side drawing primitives (PIL-backed) for filter visualizations.

Copy of `leaffliction_tpu/utils/draw.py`. It replaces the reference's cv2
drawing calls (contours, markers, polylines, text) in viz-only paths.
Everything operates on uint8 RGB numpy arrays.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

Color = Tuple[int, int, int]


def _draw(img: np.ndarray):
    from PIL import Image, ImageDraw

    pil = Image.fromarray(np.ascontiguousarray(img.astype(np.uint8)))
    return pil, ImageDraw.Draw(pil)


def polyline(img: np.ndarray, points: np.ndarray, color: Color,
             width: int = 1, closed: bool = True) -> np.ndarray:
    pts = [tuple(map(float, p)) for p in np.asarray(points).reshape(-1, 2)]
    if len(pts) < 2:
        return img
    if closed:
        pts.append(pts[0])
    pil, draw = _draw(img)
    draw.line(pts, fill=tuple(color), width=width, joint="curve")
    return np.array(pil)


def circle(img: np.ndarray, center, radius: int, color: Color,
           filled: bool = True, width: int = 1) -> np.ndarray:
    x, y = float(center[0]), float(center[1])
    box = [x - radius, y - radius, x + radius, y + radius]
    pil, draw = _draw(img)
    if filled:
        draw.ellipse(box, fill=tuple(color))
    else:
        draw.ellipse(box, outline=tuple(color), width=width)
    return np.array(pil)


def circles(img: np.ndarray, centers: Iterable, radius: int, color: Color
            ) -> np.ndarray:
    pil, draw = _draw(img)
    for c in centers:
        x, y = float(c[0]), float(c[1])
        draw.ellipse([x - radius, y - radius, x + radius, y + radius],
                     fill=tuple(color))
    return np.array(pil)


def line(img: np.ndarray, p0, p1, color: Color, width: int = 1) -> np.ndarray:
    pil, draw = _draw(img)
    draw.line([tuple(map(float, p0)), tuple(map(float, p1))],
              fill=tuple(color), width=width)
    return np.array(pil)


def cross_marker(img: np.ndarray, center, size: int, color: Color,
                 width: int = 2) -> np.ndarray:
    x, y = float(center[0]), float(center[1])
    h = size / 2
    pil, draw = _draw(img)
    draw.line([(x - h, y), (x + h, y)], fill=tuple(color), width=width)
    draw.line([(x, y - h), (x, y + h)], fill=tuple(color), width=width)
    return np.array(pil)


def text(img: np.ndarray, message: str, org=(10, 10),
         color: Color = (255, 0, 0)) -> np.ndarray:
    pil, draw = _draw(img)
    draw.text(tuple(map(float, org)), message, fill=tuple(color))
    return np.array(pil)


def rectangle(img: np.ndarray, xywh, color: Color, width: int = 2) -> np.ndarray:
    x, y, w, h = map(float, xywh)
    pil, draw = _draw(img)
    draw.rectangle([x, y, x + w - 1, y + h - 1], outline=tuple(color),
                   width=width)
    return np.array(pil)


def convex_hull_points(points: np.ndarray) -> np.ndarray:
    """Andrew monotone-chain convex hull of [N, 2] (x, y) points."""
    pts = np.unique(np.asarray(points).reshape(-1, 2), axis=0)
    if len(pts) <= 2:
        return pts

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    pts_sorted = pts[np.lexsort((pts[:, 1], pts[:, 0]))]
    lower: list = []
    for p in pts_sorted:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(tuple(p))
    upper: list = []
    for p in pts_sorted[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(tuple(p))
    return np.asarray(lower[:-1] + upper[:-1], np.int64)
