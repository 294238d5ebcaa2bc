"""Brown/disease-spot filter (reference `filters/brown.py:21-89`).

Port of `leaffliction_tpu/segment/brown.py`: the HSV (or LAB) brown gate
within the leaf mask → open/close → connected components (kernel K4) of at
least the minimum area → orange overlay, % of leaf and spot count. The
detection runs on the image's device; the two scalars come back for
logging.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from leaffliction_tpu_torch.ops.colorspace import rgb_to_hsv, rgb_to_lab
from leaffliction_tpu_torch.ops.components import (
    _sizes_2d,
    _spread_keep,
    label_components,
)
from leaffliction_tpu_torch.ops.morphology import closing, opening
from leaffliction_tpu_torch.segment.config import TransformConfig


def brown_regions(rgb: torch.Tensor, leaf_mask: torch.Tensor,
                  cfg: TransformConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (filtered bool [h, w], percentage of leaf, component count)."""
    rgb = rgb.float()
    leaf = leaf_mask.bool()
    if cfg.use_lab_brown:
        lab = rgb_to_lab(rgb)
        raw = ((lab[..., 1] >= cfg.lab_a_min)
               & (lab[..., 2] >= cfg.lab_b_min) & leaf)
    else:
        hsv = rgb_to_hsv(rgb)
        lo, hi = cfg.brown_hue_range
        raw = ((hsv[..., 0] >= lo) & (hsv[..., 0] <= hi)
               & (hsv[..., 1] >= cfg.brown_s_min)
               & (hsv[..., 2] <= cfg.brown_v_max) & leaf)

    k = cfg.brown_morph_kernel
    clean = closing(opening(raw, k, "ellipse"), k, "ellipse")

    labels = label_components(clean)
    keep = _sizes_2d(labels) >= cfg.brown_min_area_px
    filtered = _spread_keep(keep, clean) & (labels > 0)

    count = keep.sum()
    leaf_area = torch.clamp(leaf.sum(), min=1)
    percentage = filtered.sum().float() / leaf_area * 100.0
    return filtered, percentage, count


def brown_filter(rgb, leaf_mask, cfg: TransformConfig, regions=None,
                 device="cuda"):
    """Host-facing: → (overlay RGB uint8, percentage float, count int).

    `regions`: optional pre-dispatched `brown_regions` tuple (folder mode
    queues the device work of a window of images first)."""
    if regions is None:
        regions = brown_regions(torch.as_tensor(np.asarray(rgb)).to(device),
                                torch.as_tensor(np.asarray(leaf_mask)).to(
                                    device), cfg)
    filtered, pct, count = regions
    vis = np.asarray(rgb, np.uint8).copy()
    vis[filtered.cpu().numpy()] = [255, 100, 0]
    return vis, float(pct), int(count)
