"""Mask utilities with the reference's `srcs/utils/mask_utils.py` surface.

Port of `leaffliction_tpu/utils/mask_utils.py`: PlantCV-style `apply_mask`
(background to white or black), binary, inverted and combined masks, the
morphology helper, mask → contours, area and bounding box. Everything is
numpy except two calls: `apply_morphological_operations` runs the port's
`ops/morphology` (cv2's ellipse element) on `device` (cuda by default, as
the port's entry points do), and `mask_to_contours` runs the port's copy of
`segment/contours`.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def apply_mask(img: np.ndarray, mask: np.ndarray,
               mask_color: str = "white") -> np.ndarray:
    """Set pixels where mask==0 to white or black (PlantCV semantics)."""
    if mask_color.upper() == "WHITE":
        color_val = 255
    elif mask_color.upper() == "BLACK":
        color_val = 0
    else:
        raise ValueError(f'Mask Color {mask_color} is not "white" or "black"!')
    if not isinstance(img, np.ndarray):
        raise TypeError("img must be a numpy array")
    if not isinstance(mask, np.ndarray):
        raise TypeError("mask must be a numpy array")

    if mask.ndim == 3:
        mask = mask[..., 0]
    elif mask.ndim != 2:
        raise ValueError("mask must be 2D or 3D array")
    binary = mask > 127

    out = img.copy()
    if out.ndim in (2, 3):
        out[~binary] = color_val
    else:
        raise ValueError("img must be 2D (grayscale) or 3D (color) array")
    return out


def create_binary_mask(img: np.ndarray, threshold: int = 127) -> np.ndarray:
    """Grayscale image → binary {0, 255} mask."""
    if img.ndim == 3:
        img = np.asarray(
            0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])
    return ((img > threshold).astype(np.uint8)) * 255


def invert_mask(mask: np.ndarray) -> np.ndarray:
    return ((mask <= 127).astype(np.uint8)) * 255


def combine_masks(masks: List[np.ndarray], operation: str = "or"
                  ) -> np.ndarray:
    """Combine binary masks with 'or'/'and'."""
    if not masks:
        raise ValueError("No masks to combine")
    result = masks[0] > 127
    for m in masks[1:]:
        if operation == "or":
            result = result | (m > 127)
        elif operation == "and":
            result = result & (m > 127)
        else:
            raise ValueError(f"Unknown operation: {operation}")
    return result.astype(np.uint8) * 255


def apply_morphological_operations(mask: np.ndarray, operation: str = "close",
                                   kernel_size: int = 3, iterations: int = 1,
                                   device="cuda") -> np.ndarray:
    """open/close/erode/dilate with cv2's ellipse element, on `device`."""
    import torch

    from leaffliction_tpu_torch.ops import morphology as M

    ops = {"open": M.opening, "close": M.closing,
           "erode": M.erode, "dilate": M.dilate}
    if operation not in ops:
        raise ValueError(f"Unknown operation: {operation}")
    m = torch.from_numpy(np.asarray(mask) > 127).to(device)
    for _ in range(max(iterations, 1)):
        m = ops[operation](m, kernel_size, "ellipse")
    return m.cpu().numpy().astype(np.uint8) * 255


def mask_to_contours(mask: np.ndarray) -> List[np.ndarray]:
    """Extract outer contours (largest-first, cv2 [N,1,2] format)."""
    from leaffliction_tpu_torch.segment.contours import (
        largest_contour_points,
    )

    cnt = largest_contour_points(np.asarray(mask) > 127)
    return [cnt] if cnt is not None else []


def get_mask_area(mask: np.ndarray) -> int:
    return int((np.asarray(mask) > 127).sum())


def get_mask_bbox(mask: np.ndarray) -> Optional[tuple]:
    binary = np.asarray(mask) > 127
    if not binary.any():
        return None
    ys, xs = np.nonzero(binary)
    return (int(xs.min()), int(ys.min()),
            int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1))
