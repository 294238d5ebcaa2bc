"""Binary morphology: dilate, erode, opening, closing, fill_holes.

Port of `leaffliction_tpu/ops/morphology.py`. Masks are bool [..., h, w];
structuring elements are square (cv2 MORPH_RECT) or cv2's MORPH_ELLIPSE,
rasterised exactly. The ellipse is applied as a stack of horizontal runs:
dilation is the OR over its rows of a 1-D run max, shifted by the row.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _ellipse_kernel(ksize: int) -> np.ndarray:
    """cv2.getStructuringElement(MORPH_ELLIPSE, (k,k)) — exact row-wise
    rasterization from OpenCV's getStructuringElement."""
    r = c = ksize // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    kern = np.zeros((ksize, ksize), bool)
    for i in range(ksize):
        dy = i - r
        if abs(dy) > r:
            continue
        dx = int(round(c * np.sqrt((r * r - dy * dy) * inv_r2)))
        j1 = max(c - dx, 0)
        j2 = min(c + dx + 1, ksize)
        kern[i, j1:j2] = True
    return kern


def _window_max(x: torch.Tensor, ksize: int, shape: str, fill: float
                ) -> torch.Tensor:
    """Window max over f32 [b, 1, h, w], padded with `fill` the way
    `reduce_window` pads: ksize//2 before, the rest after."""
    h, w = x.shape[-2], x.shape[-1]
    pad = ksize // 2
    if shape == "rect":
        x = F.pad(x, (pad, ksize - 1 - pad, pad, ksize - 1 - pad), value=fill)
        return F.max_pool2d(x, ksize, stride=1)
    kern = _ellipse_kernel(ksize)
    padded = F.pad(x, (0, 0, pad, ksize - 1 - pad), value=fill)
    out = None
    for dy in range(ksize):
        cols = np.nonzero(kern[dy])[0]
        if cols.size == 0:
            continue
        x0, x1 = int(cols.min()), int(cols.max())
        width = x1 - x0 + 1
        lpad = pad - x0
        rows = F.pad(padded[..., dy:dy + h, :], (lpad, width - 1 - lpad),
                     value=fill)
        run = F.max_pool2d(rows, (1, width), stride=1)
        out = run if out is None else torch.maximum(out, run)
    return out


def _morph(mask: torch.Tensor, ksize: int, op: str, shape: str
           ) -> torch.Tensor:
    h, w = mask.shape[-2], mask.shape[-1]
    x = mask.bool().reshape(-1, 1, h, w).float()
    if op == "max":
        y = _window_max(x, ksize, shape, 0.0) > 0
    else:  # min(x) = 1 - max(1 - x), background beyond the edge is "all set"
        y = _window_max(1.0 - x, ksize, shape, 0.0) == 0
    return y.reshape(mask.shape)


def dilate(mask: torch.Tensor, ksize: int = 3, shape: str = "rect"
           ) -> torch.Tensor:
    return _morph(mask, ksize, "max", shape)


def erode(mask: torch.Tensor, ksize: int = 3, shape: str = "rect"
          ) -> torch.Tensor:
    return _morph(mask, ksize, "min", shape)


def opening(mask: torch.Tensor, ksize: int = 3, shape: str = "rect"
            ) -> torch.Tensor:
    return dilate(erode(mask, ksize, shape), ksize, shape)


def closing(mask: torch.Tensor, ksize: int = 3, shape: str = "rect"
            ) -> torch.Tensor:
    return erode(dilate(mask, ksize, shape), ksize, shape)


def fill_holes(mask: torch.Tensor) -> torch.Tensor:
    """Fill background regions not connected to the border, [h, w] bool.

    Border-connected background is found by the connected-components
    propagation (`ops/components._propagate`, one launch of the fixpoint
    kernel on the card) seeded from the border ring."""
    from leaffliction_tpu_torch.ops.components import _propagate

    m = mask.bool()
    h, w = m.shape[-2], m.shape[-1]
    border = torch.zeros_like(m)
    border[..., 0, :] = True
    border[..., -1, :] = True
    border[..., :, 0] = True
    border[..., :, -1] = True
    inv = ~m
    seed = (border & inv).to(torch.int32)
    bg = _propagate(seed, inv, h + w) > 0
    return m | (inv & ~bg)
