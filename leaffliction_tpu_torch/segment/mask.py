"""Leaf segmentation: the mask pipeline that the predict montage runs.

Port of `leaffliction_tpu/segment/mask.py` for the candidate strategies
hsv_s, hsv_v_dark, hsv_h, lab, enhanced and inclusive (the default), the
post-process chain, the heuristic score, brown-region extension and the Otsu
fallback. One [h, w, 3] image at a time, on the device of the tensor given.
The JAX `lax.cond` on the score becomes a Python `if` (one host sync).

Not ported yet (ROADMAP item 11): the kmeans candidate and shadow
suppression, both of which need k-means; they raise NotImplementedError.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from leaffliction_tpu_torch.ops.colorspace import (
    rgb_to_gray,
    rgb_to_hsv,
    rgb_to_lab,
)
from leaffliction_tpu_torch.ops.components import (
    largest_component,
    remove_small_components,
)
from leaffliction_tpu_torch.ops.filters import (
    canny,
    gaussian_blur,
    normalize_minmax,
    sobel_xy,
)
from leaffliction_tpu_torch.ops.morphology import (
    closing,
    dilate,
    erode,
    fill_holes,
    opening,
)
from leaffliction_tpu_torch.ops.threshold import otsu_binarize
from leaffliction_tpu_torch.segment.config import TransformConfig

_KMEANS_TODO = ("k-means is not ported yet (ROADMAP item 11): the {} needs "
                "it; use the default inclusive strategy without shadow "
                "suppression")


# --- geometry helpers --------------------------------------------------------


def convex_hull_area_approx(mask: torch.Tensor) -> torch.Tensor:
    """Approximate convex-hull area: shoelace area of the polygon of extreme
    points along 36 directions."""
    h, w = mask.shape
    dev = mask.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(
        h, w).reshape(-1)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(
        h, w).reshape(-1)
    thetas = torch.from_numpy(np.linspace(
        0.0, 2.0 * math.pi, 36, endpoint=False).astype(np.float32)).to(dev)
    proj = (xs[None, :] * torch.cos(thetas)[:, None]
            + ys[None, :] * torch.sin(thetas)[:, None])
    proj = torch.where(mask.reshape(1, -1).bool(), proj, -torch.inf)
    idx = torch.argmax(proj, dim=1)
    x, y = xs[idx], ys[idx]
    x2, y2 = torch.roll(x, -1), torch.roll(y, -1)
    return 0.5 * torch.abs(torch.sum(x * y2 - x2 * y))


def bounding_rect(mask: torch.Tensor) -> torch.Tensor:
    """→ [x, y, w, h] like cv2.boundingRect (int64), zeros if empty."""
    h, w = mask.shape
    m = mask.bool()
    rows = torch.nonzero(m.any(dim=1)).reshape(-1)
    cols = torch.nonzero(m.any(dim=0)).reshape(-1)
    if rows.numel() == 0:
        return torch.zeros(4, dtype=torch.int64, device=mask.device)
    return torch.stack([cols[0], rows[0], cols[-1] - cols[0] + 1,
                        rows[-1] - rows[0] + 1])


# --- candidate strategies ----------------------------------------------------


def _green_gate(hsv, cfg: TransformConfig):
    lo, hi = cfg.green_hue_range
    return (hsv[..., 0] >= lo) & (hsv[..., 0] <= hi) & (hsv[..., 1] >= 40.0)


def _cand_hsv_s(rgb, hsv, cfg: TransformConfig):
    return otsu_binarize(hsv[..., 1], invert=(cfg.bg_bias or "") == "dark_bg")


def _cand_hsv_v_dark(rgb, hsv, cfg: TransformConfig):
    return otsu_binarize(hsv[..., 2], invert=True)


def _cand_hsv_h(rgb, hsv, cfg: TransformConfig):
    return _green_gate(hsv, cfg)


def _cand_lab(lab):
    a, b = lab[..., 1], lab[..., 2]
    return (a <= 135.0) & (b >= 115.0) & (b <= 170.0)


def _cand_enhanced(rgb, hsv, lab, cfg: TransformConfig):
    h_c, s_c, v_c = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    l_c, a_c, b_c = lab[..., 0], lab[..., 1], lab[..., 2]
    lo, hi = cfg.green_hue_range

    hsv_veg = ((h_c >= lo) & (h_c <= hi) & (s_c >= 25)
               & (v_c >= 20) & (v_c <= 240))
    lab_veg = (a_c <= 135) & (b_c >= 105) & (l_c >= 30) & (l_c <= 220)
    if cfg.use_lab_brown:
        brown = ((a_c >= cfg.lab_a_min - 10) & (b_c >= cfg.lab_b_min - 10)
                 & (l_c >= 20))
    else:
        blo, bhi = cfg.brown_hue_range
        brown_hue = (((h_c >= blo) & (h_c <= bhi + 20))
                     | ((h_c >= 160) & (h_c <= 180)))
        brown = (brown_hue & (s_c >= cfg.brown_s_min - 10)
                 & (v_c <= cfg.brown_v_max + 30))

    gray = rgb_to_gray(rgb)
    edges = (canny(gray, 30, 100, hysteresis=False)
             | canny(gray, 50, 150, hysteresis=False))
    edge_regions = dilate(dilate(edges, 5, "ellipse"), 5, "ellipse")

    veg = hsv_veg | lab_veg | brown
    m = (veg.float() + edge_regions.float() * 0.3) > 0.3
    m = closing(m, 7, "ellipse")
    m = opening(m, 3, "ellipse")
    m = closing(m, 9, "ellipse")
    m = largest_component(m)
    return closing(m, 3, "ellipse")


def _cand_inclusive(rgb, hsv, lab, cfg: TransformConfig):
    h_c, s_c, v_c = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    l_c, a_c, b_c = lab[..., 0], lab[..., 1], lab[..., 2]
    r_c = rgb[..., 0].float()
    g_c = rgb[..., 1].float()
    b_rgb = rgb[..., 2].float()
    lo, hi = cfg.green_hue_range
    elo, ehi = max(0, lo - 10), min(179, hi + 15)

    strong_green = (h_c >= elo) & (h_c <= ehi) & (s_c >= 30) & (v_c >= 30)
    green_dominant = ((g_c > r_c + 15) | (g_c > b_rgb + 15)
                      | ((g_c > r_c + 5) & (g_c > b_rgb + 5) & (s_c >= 20)))
    lab_green = (a_c <= 125) & (b_c >= 120) & (l_c >= 20) & (l_c <= 240)

    gray = rgb_to_gray(rgb)
    texture_diff = torch.abs(gray - gaussian_blur(gray, 15, 0.0))
    gray_purple_bg = (
        ((s_c <= 25) & (v_c >= 50) & (v_c <= 220))
        | ((h_c >= 120) & (h_c <= 160) & (s_c >= 20)
           & (r_c > g_c) & (b_rgb > g_c))
        | ((s_c <= 15) & (texture_diff < 10))
    )

    edges = canny(gray, 30, 100, hysteresis=False)
    dilated_edges = dilate(edges, 3, "ellipse")

    plant = (strong_green | green_dominant | lab_green | dilated_edges)
    plant = plant & ~gray_purple_bg
    plant = opening(plant, 3, "ellipse")
    plant = closing(plant, 9, "ellipse")
    plant = closing(plant, 7, "ellipse")
    plant = largest_component(plant)
    return closing(plant, 5, "ellipse")


# --- post-process + scoring ----------------------------------------------------


def postprocess_mask(raw, cfg: TransformConfig):
    """fill(size) → close → open → largest component → hole fill."""
    m = remove_small_components(raw.bool(), cfg.fill_size)
    k = cfg.morph_kernel
    m = closing(m, k, "ellipse")
    m = opening(m, k, "ellipse")
    m = largest_component(m)
    return fill_holes(m)


def score_mask(mask, rgb, cfg: TransformConfig) -> torch.Tensor:
    """Heuristic score (0-dim f32 tensor): area term, solidity, boundary
    gradient and green fraction, ×0.75 on border touch."""
    h, w = mask.shape
    m = mask.float()
    area = m.sum()
    area_ratio = area / (h * w)

    hull_area = convex_hull_area_approx(mask)
    solidity = torch.where(hull_area > 1.0,
                           area / torch.clamp(hull_area, min=1.0), 0.0)
    solidity = torch.clamp(solidity, 0.0, 1.0)

    gx, gy = sobel_xy(rgb_to_gray(rgb))
    mag = normalize_minmax(torch.sqrt(gx * gx + gy * gy), 0.0, 1.0)
    boundary = dilate(mask, 3, "ellipse") ^ erode(mask, 3, "ellipse")
    b_sum = boundary.float().sum()
    b_strength = torch.where(
        b_sum > 0, torch.sum(mag * boundary) / torch.clamp(b_sum, min=1.0),
        0.0)

    green = _green_gate(rgb_to_hsv(rgb), cfg)
    green_frac = torch.sum(green & mask.bool()) / torch.clamp(area, min=1.0)

    x, y, ww, hh = bounding_rect(mask)
    touches = bool((x <= 0) | (y <= 0) | (x + ww >= w - 1) | (y + hh >= h - 1))

    target = 0.35
    area_term = torch.clamp(1.0 - torch.abs(area_ratio - target) / target,
                            min=0.0)
    score = (0.35 * area_term + 0.25 * solidity + 0.25 * b_strength
             + 0.15 * green_frac)
    if touches:
        score = score * 0.75
    in_range = ((area_ratio >= cfg.min_object_area_ratio)
                & (area_ratio <= cfg.max_object_area_ratio))
    score = torch.where(in_range, score, 0.01)
    return torch.where(area > 1.0, score, -1.0)


# --- refinements -----------------------------------------------------------------


def extend_with_brown(mask, rgb, cfg: TransformConfig):
    """Extend the mask with nearby brown/diseased regions."""
    search = dilate(dilate(mask.bool(), 20, "ellipse"), 20, "ellipse")
    if cfg.use_lab_brown:
        lab = rgb_to_lab(rgb)
        brown = ((lab[..., 1] >= cfg.lab_a_min)
                 & (lab[..., 2] >= cfg.lab_b_min) & search)
    else:
        hsv = rgb_to_hsv(rgb)
        lo, hi = cfg.brown_hue_range
        brown = ((hsv[..., 0] >= lo) & (hsv[..., 0] <= hi)
                 & (hsv[..., 1] >= cfg.brown_s_min)
                 & (hsv[..., 2] <= cfg.brown_v_max) & search)
    k = cfg.brown_morph_kernel
    brown = opening(brown, k, "ellipse")
    brown = closing(brown, k, "ellipse")
    brown = remove_small_components(brown, cfg.brown_min_area_px)
    return mask.bool() | brown


def fallback_mask(rgb, cfg: TransformConfig):
    """Otsu on the configured HSV channel, then the post-process chain."""
    hsv = rgb_to_hsv(rgb)
    chan = {"h": 0, "s": 1, "v": 2}.get(cfg.hsv_channel_for_mask, 1)
    return postprocess_mask(otsu_binarize(hsv[..., chan]), cfg)


# --- main pipeline -------------------------------------------------------------


def _candidates_for(rgb, cfg: TransformConfig):
    strat = cfg.mask_strategy
    if strat not in ("hsv_s", "hsv_v_dark", "hsv_h", "lab", "enhanced",
                     "inclusive"):
        # "auto", "kmeans" and unknown names (which the JAX package maps
        # to "auto") all include the kmeans candidate
        raise NotImplementedError(_KMEANS_TODO.format(
            f"mask strategy {strat!r}"))
    hsv = rgb_to_hsv(rgb)
    lab = rgb_to_lab(rgb)
    builders = {
        "hsv_s": lambda: _cand_hsv_s(rgb, hsv, cfg),
        "hsv_v_dark": lambda: _cand_hsv_v_dark(rgb, hsv, cfg),
        "hsv_h": lambda: _cand_hsv_h(rgb, hsv, cfg),
        "lab": lambda: _cand_lab(lab),
        "enhanced": lambda: _cand_enhanced(rgb, hsv, lab, cfg),
        "inclusive": lambda: _cand_inclusive(rgb, hsv, lab, cfg),
    }
    return [builders[strat]()]


def make_mask_core(rgb: torch.Tensor, cfg: TransformConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidates → postprocess → score → best → fallback → brown-extend,
    for one [h, w, 3] image → (bool [h, w] mask, score)."""
    if cfg.shadow_suppression:
        raise NotImplementedError(_KMEANS_TODO.format("shadow suppression"))
    rgb_f = rgb.float()
    processed = [postprocess_mask(c, cfg) for c in _candidates_for(rgb_f, cfg)]
    scores = torch.stack([score_mask(m, rgb_f, cfg) for m in processed])
    best_idx = int(torch.argmax(scores))
    best, best_score = processed[best_idx], scores[best_idx]
    if float(best_score) <= 0.0:
        best = fallback_mask(rgb, cfg)
    return extend_with_brown(best, rgb, cfg), best_score


def apply_mask_white(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Background → white (f32 [h, w, 3])."""
    return torch.where(mask[..., None].bool(), img.float(), 255.0)


def make_mask_single(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Predict-montage entry: default config, no host refinement."""
    return make_mask_core(img, TransformConfig(grabcut_refine=False))
