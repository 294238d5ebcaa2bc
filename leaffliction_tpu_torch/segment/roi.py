"""ROI filter (reference `filters/roi.py:20-46`).

Port of `leaffliction_tpu/segment/roi.py`: the leaf's bounding rectangle
cropped and letterboxed to `roi_size`, plus a rectangle drawn on the
original. The letterbox is the JAX package's two matrix products with
triangle weights built from the rectangle (plain bilinear, cv2
INTER_LINEAR, no antialias), run on the image's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from leaffliction_tpu_torch.segment.config import TransformConfig
from leaffliction_tpu_torch.segment.contours import bounding_rect_np


def _axis_weights(size: int, out: int, start, length, offset, new,
                  device) -> Tuple[torch.Tensor, torch.Tensor]:
    """[size, out] triangle weights of one axis and the [out] band of
    outputs inside the letterbox: output i samples source
    start + (i − offset + 0.5)·length/new − 0.5, clamped into the crop."""
    f32 = torch.float32
    ii = torch.arange(out, dtype=f32, device=device)
    src = start + (ii - offset + 0.5) * (length / new) - 0.5
    src = torch.clamp(src, start, start + length - 1.0)
    band = (ii >= offset) & (ii < offset + new)
    ks = torch.arange(size, dtype=f32, device=device)
    return torch.clamp(1.0 - torch.abs(ks[:, None] - src[None, :]),
                       min=0.0), band


def _letterbox(img: torch.Tensor, rect, out_h: int, out_w: int
               ) -> torch.Tensor:
    """img f32 [Hs, Ws, 3]; rect = (x, y, w, h, ox, oy, nw, nh) →
    [out_h, out_w, 3] f32 canvas, black outside the letterbox."""
    x, y, w, h, ox, oy, nw, nh = (torch.tensor(float(v), device=img.device)
                                  for v in rect)
    wy, in_row = _axis_weights(img.shape[0], out_h, y, h, oy, nh,
                               img.device)
    wx, in_col = _axis_weights(img.shape[1], out_w, x, w, ox, nw,
                               img.device)
    mid = torch.einsum("kwc,ki->iwc", img, wy)
    out = torch.einsum("iwc,wj->ijc", mid, wx)
    box = (in_row[:, None] & in_col[None, :])[..., None]
    return torch.where(box, out, 0.0)


def roi_dispatch(rgb: torch.Tensor, contour: Optional[np.ndarray],
                 cfg: TransformConfig):
    """Phase 1: queue the letterbox of `rgb` (a tensor on its device);
    → (canvas, rect) or None when there is no object."""
    if contour is None:
        return None
    x, y, w, h = bounding_rect_np(contour)
    H, W = cfg.roi_size
    if w <= 0 or h <= 0:
        return None
    scale = min(W / max(w, 1), H / max(h, 1))
    nw, nh = max(int(w * scale), 1), max(int(h * scale), 1)
    oy, ox = (H - nh) // 2, (W - nw) // 2
    canvas = _letterbox(rgb.float(), (x, y, w, h, ox, oy, nw, nh), H, W)
    return canvas, (x, y, w, h)


def roi_filter(rgb: np.ndarray, contour: Optional[np.ndarray],
               cfg: TransformConfig, dispatched=None, device="cuda"
               ) -> Tuple[np.ndarray, Optional[np.ndarray],
                          Optional[Tuple[int, int, int, int]]]:
    """→ (letterboxed ROI canvas, rectangle visualization, (x,y,w,h))."""
    if dispatched is None:
        dispatched = roi_dispatch(torch.as_tensor(np.asarray(rgb)).to(
            device), contour, cfg)
    if dispatched is None:
        return rgb, None, None
    canvas_f, (x, y, w, h) = dispatched
    canvas = np.clip(np.round(canvas_f.cpu().numpy()), 0, 255).astype(
        rgb.dtype)

    vis = np.asarray(rgb).copy()
    t = 2  # rectangle thickness, color (255,0,0) like the reference
    y0, y1 = max(y, 0), min(y + h, vis.shape[0])
    x0, x1 = max(x, 0), min(x + w, vis.shape[1])
    vis[y0:min(y0 + t, y1), x0:x1] = [255, 0, 0]
    vis[max(y1 - t, y0):y1, x0:x1] = [255, 0, 0]
    vis[y0:y1, x0:min(x0 + t, x1)] = [255, 0, 0]
    vis[y0:y1, max(x1 - t, x0):x1] = [255, 0, 0]

    return canvas, vis, (x, y, w, h)
