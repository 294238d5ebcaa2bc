"""Landmarks filter — 80 pseudo-landmarks (reference
`filters/landmarks.py:29-313`).

Port of `leaffliction_tpu/segment/landmarks.py`. Quotas split ⅓/⅓/⅓ like
the reference:
- border: arc-length contour resampling (host);
- veins: CLAHE + two Cannys (K5) + a Sobel threshold, gated by the eroded
  mask, then Shi-Tomasi corners, on the image's device (`_vein_device`);
- disease: brown connected components (K4) of at least the minimum area,
  corner picks per component with area-scaled quotas; detection on the
  device, component ordering on the host.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from leaffliction_tpu_torch.segment.config import TransformConfig
from leaffliction_tpu_torch.segment.contours import (
    largest_contour_points,
    resample_contour,
)
from leaffliction_tpu_torch.utils import draw

COL_BORDER = (255, 0, 0)
COL_VEIN = (0, 0, 255)
COL_DISEASE = (139, 69, 19)


def _vein_device(rgb: torch.Tensor, mask: torch.Tensor, max_corners: int):
    """→ (ys, xs, valid, dilated vein edges) on the image's device."""
    from leaffliction_tpu_torch.ops.clahe import clahe
    from leaffliction_tpu_torch.ops.colorspace import rgb_to_gray
    from leaffliction_tpu_torch.ops.filters import (
        canny,
        gaussian_blur,
        good_features_to_track,
        normalize_minmax,
        sobel_xy,
    )
    from leaffliction_tpu_torch.ops.morphology import dilate, erode

    gray_eq = clahe(rgb_to_gray(rgb.float()), 2.0, 8)
    edges1 = canny(gray_eq, 30, 90, l2=True)
    # bilateral ≈ gaussian here (smoothing before the second Canny)
    edges2 = canny(gaussian_blur(gray_eq, 5, 1.2), 50, 130, l2=True)
    gx, gy = sobel_xy(gray_eq)
    edges3 = normalize_minmax(torch.sqrt(gx * gx + gy * gy), 0.0,
                              255.0) > 40.0
    inner = erode(mask.bool(), 3, "ellipse")
    edges_d = dilate((edges1 | edges2 | edges3) & inner, 3, "ellipse")
    ys, xs, valid = good_features_to_track(
        gray_eq, edges_d, max_corners=max_corners, quality_level=0.002,
        min_distance=2, block_size=3)
    return ys, xs, valid, edges_d


def landmarks_dispatch(rgb, contour: Optional[np.ndarray],
                       cfg: TransformConfig, make_mask_func: Callable,
                       device="cuda"):
    """Phase 1: queue every mask-dependent device computation (the
    enhanced mask, the vein corners, the disease component labels) without
    reading anything back. `rgb` is a host array (single mode, where
    `make_mask_func` segments it) or a tensor on the device (folder mode,
    where `make_mask_func` returns the precomputed mask). → handles for
    `landmarks_finish` (None if no object)."""
    from leaffliction_tpu_torch.ops.colorspace import (
        rgb_to_gray,
        rgb_to_hsv,
        rgb_to_lab,
    )
    from leaffliction_tpu_torch.ops.components import label_components
    from leaffliction_tpu_torch.ops.morphology import closing, opening
    from leaffliction_tpu_torch.segment.brown import brown_regions

    if contour is None:
        return None
    mask, _ = make_mask_func(rgb)
    total = max(1, int(cfg.landmarks_count))
    vein_quota = max(1, total // 3)
    if mask is None:
        return {"contour": contour, "mask": None}

    rgb_t = (rgb if torch.is_tensor(rgb) else torch.tensor(np.asarray(rgb))
             ).to(device).float()
    leaf = torch.tensor(mask > 0 if mask.ndim == 2 else mask[..., 0] > 0,
                        device=rgb_t.device)
    # enhanced mask: leaf ∪ cleaned brown, closed (`landmarks.py:29-56`)
    brown, _, _ = brown_regions(rgb_t, leaf, cfg)
    enhanced = closing(leaf | brown, 5, "ellipse")

    if cfg.use_lab_brown:
        lab = rgb_to_lab(rgb_t)
        disease_raw = ((lab[..., 1] >= cfg.lab_a_min)
                       & (lab[..., 2] >= cfg.lab_b_min))
    else:
        hsv = rgb_to_hsv(rgb_t)
        lo, hi = cfg.brown_hue_range
        disease_raw = ((hsv[..., 0] >= lo) & (hsv[..., 0] <= hi)
                       & (hsv[..., 1] >= cfg.brown_s_min)
                       & (hsv[..., 2] <= cfg.brown_v_max))
    k = cfg.brown_morph_kernel
    clean = closing(opening(disease_raw & enhanced, k, "ellipse"),
                    k, "ellipse")
    return {"contour": contour, "mask": enhanced,
            "veins": _vein_device(rgb_t, enhanced, vein_quota * 8),
            "labels": label_components(clean), "gray": rgb_to_gray(rgb_t)}


def landmarks_finish(rgb: np.ndarray, handles, cfg: TransformConfig
                     ) -> np.ndarray:
    """Phase 2: read the queued tensors back, pick the quotas, draw."""
    if handles is None:
        return draw.text(np.asarray(rgb), "Landmarks: no object", (10, 24))

    rgb = np.asarray(rgb, np.uint8)
    contour = handles["contour"]
    mask_bool = None
    if handles["mask"] is not None:
        enhanced_np = handles["mask"].cpu().numpy()
        enhanced_contour = largest_contour_points(enhanced_np)
        if enhanced_contour is not None:
            contour = enhanced_contour
        mask_bool = enhanced_np

    vis = rgb.copy()
    total = max(1, int(cfg.landmarks_count))
    border_quota = max(1, total // 3)
    vein_quota = max(1, total // 3)
    disease_quota = max(1, total - border_quota - vein_quota)

    # border landmarks + contour outline
    border_pts = resample_contour(contour, border_quota)
    vis = draw.polyline(vis, contour.reshape(-1, 2), (0, 255, 0), width=1)
    vis = draw.circles(vis, border_pts, 2, COL_BORDER)

    # vein landmarks (device corners)
    if mask_bool is not None:
        ys, xs, valid, edges_d = (t.cpu().numpy() for t in handles["veins"])
        corners = [(int(x), int(y)) for y, x, ok in zip(ys, xs, valid) if ok]
        vis = draw.circles(vis, corners[:vein_quota], 2, COL_VEIN)
        placed = min(len(corners), vein_quota)
        if placed < vein_quota:  # fallback: spread over edge pixels
            eys, exs = np.nonzero(edges_d)
            need = vein_quota - placed
            if len(exs) > 0 and need > 0:
                idx = np.linspace(0, len(exs) - 1, num=need, dtype=int)
                vis = draw.circles(vis, list(zip(exs[idx], eys[idx])), 2,
                                   COL_VEIN)

        # disease landmarks from the queued component labels
        vis = _disease_landmarks(vis, cfg, handles["labels"].cpu().numpy(),
                                 handles["gray"], disease_quota)
    return vis


def landmarks_filter(rgb: np.ndarray, contour: Optional[np.ndarray],
                     cfg: TransformConfig, make_mask_func: Callable,
                     device="cuda") -> np.ndarray:
    """Single-image entry: dispatch + finish back-to-back."""
    handles = landmarks_dispatch(rgb, contour, cfg, make_mask_func, device)
    return landmarks_finish(rgb, handles, cfg)


def _disease_landmarks(vis, cfg: TransformConfig, labels: np.ndarray,
                       gray: torch.Tensor, disease_quota: int):
    """`labels` is the connected-components image of the cleaned brown
    gate (from `landmarks_dispatch`), `gray` the image's gray on its
    device."""
    from leaffliction_tpu_torch.ops.filters import good_features_to_track

    ids, counts = np.unique(labels[labels > 0], return_counts=True)
    comps = [(i, int(n)) for i, n in zip(ids, counts)
             if n >= cfg.brown_min_area_px]
    comps.sort(key=lambda t: -t[1])
    if not comps:
        return vis

    total_area = sum(n for _, n in comps)
    calculated = max(len(comps), total_area // 50)
    actual_quota = min(calculated, disease_quota * 5)

    placed = 0
    for comp_id, area in comps:
        if placed >= actual_quota:
            break
        comp_mask = labels == comp_id
        points_for_comp = max(1, min(area // 40, actual_quota - placed))
        # the JAX package buckets the request to the next power of two;
        # the corners come sorted, so the bucket sliced to the request is
        # the same list
        req = max(points_for_comp * 3, 4)
        ys, xs, valid = good_features_to_track(
            gray, torch.from_numpy(comp_mask).to(gray.device),
            max_corners=1 << (req - 1).bit_length(),
            quality_level=0.005, min_distance=3, block_size=3)
        ys, xs, valid = (t.cpu().numpy() for t in (ys, xs, valid))
        pts = [(int(x), int(y)) for y, x, ok in zip(ys, xs, valid) if ok]
        if pts:
            vis = draw.circles(vis, pts[:points_for_comp], 4, COL_DISEASE)
            placed += min(len(pts), points_for_comp)
        else:
            cys, cxs = np.nonzero(comp_mask)
            vis = draw.circle(vis, (cxs.mean(), cys.mean()), 4, COL_DISEASE)
            placed += 1
    return vis
