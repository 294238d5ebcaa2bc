"""Leaf segmentation: the full mask pipeline, batched over images.

Port of `leaffliction_tpu/segment/mask.py`: all seven candidate strategies
(hsv_s, hsv_v_dark, hsv_h, lab, kmeans, enhanced and inclusive, the
default; `auto` runs them all), the post-process chain, the heuristic
score, shadow suppression, brown-region extension and the Otsu fallback.
Every step takes images [n, h, w, 3] on the device of the tensor given, so
one connected-components `_propagate` or one Canny of a chunk is one launch
of kernel K4 or K5 for the whole chunk; the candidates of `auto` are
stacked on the same axis. The JAX `lax.cond` on the score becomes a host
check of the scores (`finalize_mask_batch`). `make_mask` is the host entry
of the transform CLI: the 1.3× cubic upscale, GrabCut (`LEAF_GRABCUT`:
cv2 on the host or the device GMM of `segment/grabcut`), the rescore, the
nearest downscale and the contour.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

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
from leaffliction_tpu_torch.ops.image import resize
from leaffliction_tpu_torch.ops.kmeans import kmeans_pixels
from leaffliction_tpu_torch.ops.morphology import (
    closing,
    dilate,
    erode,
    fill_holes,
    opening,
)
from leaffliction_tpu_torch.ops.threshold import otsu_binarize
from leaffliction_tpu_torch.segment.config import TransformConfig


# --- geometry helpers --------------------------------------------------------


def convex_hull_area_approx(mask: torch.Tensor) -> torch.Tensor:
    """Approximate convex-hull area of each [h, w] mask of [..., h, w]:
    shoelace area of the polygon of extreme points along 36 directions."""
    h, w = mask.shape[-2], mask.shape[-1]
    dev = mask.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(
        h, w).reshape(-1)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(
        h, w).reshape(-1)
    thetas = torch.from_numpy(np.linspace(
        0.0, 2.0 * math.pi, 36, endpoint=False).astype(np.float32)).to(dev)
    proj = (xs[None, :] * torch.cos(thetas)[:, None]
            + ys[None, :] * torch.sin(thetas)[:, None])
    m = mask.reshape(-1, 1, h * w).bool()
    idx = torch.argmax(torch.where(m, proj, -torch.inf), dim=-1)
    x, y = xs[idx], ys[idx]
    x2, y2 = torch.roll(x, -1, dims=-1), torch.roll(y, -1, dims=-1)
    area = 0.5 * torch.abs(torch.sum(x * y2 - x2 * y, dim=-1))
    return area.reshape(mask.shape[:-2])


def bounding_rect(mask: torch.Tensor) -> torch.Tensor:
    """→ [..., 4] int64 [x, y, w, h] like cv2.boundingRect, zeros if
    empty."""
    h, w = mask.shape[-2], mask.shape[-1]
    m = mask.bool()
    any_row, any_col = m.any(dim=-1), m.any(dim=-2)
    rows = torch.arange(h, device=m.device)
    cols = torch.arange(w, device=m.device)
    y0 = torch.where(any_row, rows, h).amin(dim=-1)
    y1 = torch.where(any_row, rows, -1).amax(dim=-1)
    x0 = torch.where(any_col, cols, w).amin(dim=-1)
    x1 = torch.where(any_col, cols, -1).amax(dim=-1)
    rect = torch.stack([x0, y0, x1 - x0 + 1, y1 - y0 + 1], dim=-1)
    return torch.where(any_row.any(dim=-1, keepdim=True), rect, 0)


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


def _cand_kmeans(rgb, cfg: TransformConfig):
    """k=3 k-means over a downscaled copy of each image; the cluster pick
    follows the reference (bias → brightness, else green score, else
    saturation)."""
    n, h, w = rgb.shape[0], rgb.shape[1], rgb.shape[2]
    scale = min(1.0, 256.0 / max(h, w))  # downscale only, like the reference
    sh, sw = max(1, int(h * scale)), max(1, int(w * scale))
    small = resize(rgb.float(), (n, sh, sw, 3), "linear")
    labels, centers = kmeans_pixels(small, k=3, iters=10, seed=12345)

    hsv_c = rgb_to_hsv(centers)  # [n, 3, 3] cv2 ranges
    lo, hi = cfg.green_hue_range
    green_score = ((hsv_c[..., 0] >= lo) & (hsv_c[..., 0] <= hi)
                   & (hsv_c[..., 1] >= 40)).to(torch.int32)
    brightness = centers.mean(dim=-1)
    if cfg.bg_bias == "dark_bg":
        pick = torch.argmax(brightness, dim=-1)
    elif cfg.bg_bias == "light_bg":
        pick = torch.argmin(brightness, dim=-1)
    else:
        pick = torch.where((green_score > 0).any(dim=-1),
                           torch.argmax(green_score, dim=-1),
                           torch.argmax(hsv_c[..., 1], dim=-1))
    small_mask = labels == pick[:, None, None]
    return resize(small_mask.float(), (n, h, w), "nearest") > 0.5


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
    """Heuristic score of each mask of [n, h, w] (f32 [n]): area term,
    solidity, boundary gradient and green fraction, ×0.75 on border
    touch."""
    h, w = mask.shape[-2], mask.shape[-1]
    m = mask.float()
    area = m.sum(dim=(-2, -1))
    area_ratio = area / (h * w)

    hull_area = convex_hull_area_approx(mask)
    solidity = torch.where(hull_area > 1.0,
                           area / torch.clamp(hull_area, min=1.0), 0.0)
    solidity = torch.clamp(solidity, 0.0, 1.0)

    gx, gy = sobel_xy(rgb_to_gray(rgb))
    mag = normalize_minmax(torch.sqrt(gx * gx + gy * gy), 0.0, 1.0)
    boundary = dilate(mask, 3, "ellipse") ^ erode(mask, 3, "ellipse")
    b_sum = boundary.float().sum(dim=(-2, -1))
    b_strength = torch.where(
        b_sum > 0, torch.sum(mag * boundary, dim=(-2, -1))
        / torch.clamp(b_sum, min=1.0), 0.0)

    green = _green_gate(rgb_to_hsv(rgb), cfg)
    green_frac = torch.sum(green & mask.bool(), dim=(-2, -1)) \
        / torch.clamp(area, min=1.0)

    rect = bounding_rect(mask)
    x, y, ww, hh = rect.unbind(dim=-1)
    touches = (x <= 0) | (y <= 0) | (x + ww >= w - 1) | (y + hh >= h - 1)

    target = 0.35
    area_term = torch.clamp(1.0 - torch.abs(area_ratio - target) / target,
                            min=0.0)
    score = (0.35 * area_term + 0.25 * solidity + 0.25 * b_strength
             + 0.15 * green_frac)
    score = torch.where(touches, score * 0.75, score)
    in_range = ((area_ratio >= cfg.min_object_area_ratio)
                & (area_ratio <= cfg.max_object_area_ratio))
    score = torch.where(in_range, score, 0.01)
    return torch.where(area > 1.0, score, -1.0)


# --- refinements -----------------------------------------------------------------


def _per_image(v: torch.Tensor) -> torch.Tensor:
    return v[..., None, None]


def suppress_shadow(mask, rgb, cfg: TransformConfig):
    """Seven-method shadow removal over [n, h, w] masks: percentile, HSV
    and texture gates, and the two darkest of 5 k-means clusters on a
    ≤ 150 px copy, minus green regions."""
    hsv = rgb_to_hsv(rgb)
    lab = rgb_to_lab(rgb)
    s_c, v_c = hsv[..., 1], hsv[..., 2]
    l_c = lab[..., 0]
    lo, hi = cfg.green_hue_range

    # jnp.percentile's default is linear interpolation, as torch.quantile's
    flat_l = l_c.flatten(-2)
    l40, l45, l50 = (_per_image(torch.quantile(flat_l, q, dim=-1))
                     for q in (0.40, 0.45, 0.50))
    very_dark_lab = l_c < l40
    low_sat_dark = (s_c < 50) & (v_c < 100)
    aggressive = (l_c < l45) & (s_c < 60) & (v_c < 120)
    very_low_v = v_c < 90
    lab_dark = l_c < l50

    gray = rgb_to_gray(rgb)
    uniform = torch.abs(gray - gaussian_blur(gray, 15, 0.0)) < 15
    shadow_uniform = uniform & (v_c < 100)

    # k-means (5 clusters on a ≤150px resize): two darkest clusters
    n, h, w = rgb.shape[0], rgb.shape[1], rgb.shape[2]
    scale = min(1.0, 150.0 / max(h, w))
    sh, sw = max(1, int(h * scale)), max(1, int(w * scale))
    small = resize(rgb.float(), (n, sh, sw, 3), "linear")
    labels, centers = kmeans_pixels(small, k=5, iters=10, seed=7)
    order = torch.argsort(centers.mean(dim=-1), dim=-1, stable=True)
    dark2 = ((labels == order[:, 0, None, None])
             | (labels == order[:, 1, None, None]))
    shadow_kmeans = resize(dark2.float(), (n, h, w), "nearest") > 0.5

    green_regions = ((hsv[..., 0] >= lo) & (hsv[..., 0] <= hi)
                     & (s_c >= 40) & (v_c >= 60))

    shadow = (very_dark_lab | low_sat_dark | aggressive | very_low_v
              | lab_dark | shadow_uniform | shadow_kmeans) & ~green_regions
    shadow = dilate(shadow, 3, "ellipse")
    shadow = closing(shadow, 7, "ellipse")

    refined = mask.bool() & ~shadow
    refined = opening(refined, 3, "ellipse")
    refined = closing(refined, 7, "ellipse")
    return postprocess_mask(refined, cfg)


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
    """The strategy's candidate masks, each [n, h, w]; an unknown strategy
    runs them all, as `auto` does."""
    hsv = rgb_to_hsv(rgb)
    lab = rgb_to_lab(rgb)
    makers = {
        "hsv_s": lambda: _cand_hsv_s(rgb, hsv, cfg),
        "hsv_v_dark": lambda: _cand_hsv_v_dark(rgb, hsv, cfg),
        "hsv_h": lambda: _cand_hsv_h(rgb, hsv, cfg),
        "lab": lambda: _cand_lab(lab),
        "kmeans": lambda: _cand_kmeans(rgb, cfg),
        "enhanced": lambda: _cand_enhanced(rgb, hsv, lab, cfg),
        "inclusive": lambda: _cand_inclusive(rgb, hsv, lab, cfg),
    }
    if cfg.mask_strategy in makers:
        return [makers[cfg.mask_strategy]()]
    return [make() for make in makers.values()]


def _make_mask_no_fallback(rgb, cfg: TransformConfig
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 [n, h, w, 3] → (best post-processed mask [n, h, w], its score
    [n]), shadow suppression applied where it scores no worse. The
    candidates are post-processed and scored stacked on the batch axis."""
    n = rgb.shape[0]
    cands = _candidates_for(rgb, cfg)
    k = len(cands)
    processed = postprocess_mask(torch.cat(cands), cfg)
    scores = score_mask(processed, rgb.repeat(k, 1, 1, 1), cfg).reshape(k, n)
    best_idx = torch.argmax(scores, dim=0)
    rows = torch.arange(n, device=rgb.device)
    best = processed.reshape(k, n, *processed.shape[1:])[best_idx, rows]
    best_score = scores[best_idx, rows]

    if cfg.shadow_suppression:
        shadowless = suppress_shadow(best, rgb, cfg)
        sc2 = score_mask(shadowless, rgb, cfg)
        best = torch.where(_per_image(sc2 >= best_score), shadowless, best)
        best_score = torch.maximum(sc2, best_score)
    return best, best_score


def make_mask_core(rgb: torch.Tensor, cfg: TransformConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidates → postprocess → score → best → shadow → fallback →
    brown-extend, for one [h, w, 3] image → (bool [h, w] mask, score):
    `make_mask_batch` of a batch of one."""
    masks, scores = make_mask_batch(rgb.float()[None], cfg)
    return masks[0], scores[0]


def make_mask_batch_async(imgs: torch.Tensor, cfg: TransformConfig
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched masks without the fallback: [n, h, w, 3] (uint8 or float)
    → (brown-extended masks [n, h, w], scores [n]); nothing is read back,
    so the caller can queue more chunks before `finalize_mask_batch`."""
    x = imgs.float()
    masks, scores = _make_mask_no_fallback(x, cfg)
    return extend_with_brown(masks, x, cfg), scores


def finalize_mask_batch(imgs: torch.Tensor, extended: torch.Tensor,
                        scores: torch.Tensor, cfg: TransformConfig
                        ) -> torch.Tensor:
    """Replace the masks whose score is ≤ 0 by the extended Otsu fallback
    (one read of the scores; the failures run together as one batch)."""
    failed = torch.nonzero(scores <= 0.0).reshape(-1)
    if failed.numel() == 0:
        return extended
    x = imgs.index_select(0, failed).float()
    extended = extended.clone()
    extended[failed] = extend_with_brown(fallback_mask(x, cfg), x, cfg)
    return extended


def make_mask_batch(imgs: torch.Tensor, cfg: TransformConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched masks for the training and folder paths (no host
    refinement): [n, h, w, 3] → (bool [n, h, w], scores [n])."""
    extended, scores = make_mask_batch_async(imgs, cfg)
    return finalize_mask_batch(imgs, extended, scores, cfg), scores


def mask_scale(cfg: TransformConfig, h: int, w: int) -> float:
    """The mask pipeline's upscale factor for an h×w image: the configured
    factor when above 1, else up to the long side when the image is
    shorter."""
    if cfg.mask_upscale_factor and cfg.mask_upscale_factor > 1.0:
        return float(cfg.mask_upscale_factor)
    if cfg.mask_upscale_long_side and cfg.mask_upscale_long_side > 0:
        if max(h, w) < cfg.mask_upscale_long_side:
            return cfg.mask_upscale_long_side / max(h, w)
    return 1.0


def _grabcut_any(mask_np: np.ndarray, work: torch.Tensor
                 ) -> Optional[np.ndarray]:
    """GrabCut refinement with backend selection via LEAF_GRABCUT:
    `auto` (default: cv2 when importable, else the device GMM), `device`
    (`segment/grabcut`, no cv2 import), `cv2`, or `off`."""
    mode = os.environ.get("LEAF_GRABCUT", "auto")
    if mode == "off":
        return None
    if mode in ("auto", "cv2"):
        refined = _grabcut_refine_host(mask_np, work.cpu().numpy())
        if refined is not None or mode == "cv2":
            return refined
    from leaffliction_tpu_torch.segment.grabcut import grabcut_refine

    dev = grabcut_refine(work, torch.from_numpy(mask_np > 0).to(
        work.device))
    return dev.cpu().numpy().astype(np.uint8) * 255


def _grabcut_refine_host(mask_np: np.ndarray, rgb_np: np.ndarray
                         ) -> Optional[np.ndarray]:
    """cv2.grabCut refinement (`mask.py:307-332`), on the host."""
    try:
        import cv2
    except ImportError:
        return None
    try:
        h, w = mask_np.shape
        gc_mask = np.zeros((h, w), np.uint8)
        gc_mask[mask_np > 0] = cv2.GC_PR_FGD
        gc_mask[mask_np == 0] = cv2.GC_BGD
        bgd = np.zeros((1, 65), np.float64)
        fgd = np.zeros((1, 65), np.float64)
        cv2.grabCut(rgb_np.astype(np.uint8), gc_mask, None, bgd, fgd, 1,
                    cv2.GC_INIT_WITH_MASK)
        return (((gc_mask == cv2.GC_FGD) | (gc_mask == cv2.GC_PR_FGD))
                .astype(np.uint8) * 255)
    except Exception:
        return None


def make_mask(rgb: np.ndarray, cfg: Optional[TransformConfig] = None,
              device="cuda") -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Host-facing mask entry, reference signature: uint8 [h, w, 3] →
    (mask u8 0/255, contour Nx1x2 int32 or None). The pipeline runs on
    `device` at the upscaled size; GrabCut and the rescore follow, then the
    nearest downscale and the host contour."""
    from leaffliction_tpu_torch.segment.contours import (
        largest_contour_points,
    )

    cfg = cfg or TransformConfig()
    oh, ow = rgb.shape[:2]
    s = mask_scale(cfg, oh, ow)
    x = torch.tensor(np.asarray(rgb)).to(device)
    if abs(s - 1.0) > 1e-6:
        work = resize(x, (int(round(oh * s)), int(round(ow * s)), 3),
                      "cubic")
    else:
        work = x.float()

    mask_dev, score = make_mask_core(work, cfg)
    mask_np = mask_dev.cpu().numpy().astype(np.uint8) * 255

    if cfg.grabcut_refine:
        refined = _grabcut_any(mask_np, work)
        if refined is not None and refined.any():
            m2 = postprocess_mask(torch.from_numpy(refined > 0).to(
                work.device)[None], cfg)
            sc2 = float(score_mask(m2, work[None], cfg)[0])
            if sc2 >= float(score):
                mask_np = m2[0].cpu().numpy().astype(np.uint8) * 255

    if abs(s - 1.0) > 1e-6:
        mask_np = resize(torch.from_numpy(mask_np.astype(np.float32)),
                         (oh, ow), "nearest").numpy().astype(np.uint8)
        mask_np = (mask_np > 127).astype(np.uint8) * 255

    return mask_np, largest_contour_points(mask_np > 0)


def apply_mask_white(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Background → white (f32 [..., h, w, 3])."""
    return torch.where(mask[..., None].bool(), img.float(), 255.0)


def apply_mask_black(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Background → black (f32 [..., h, w, 3])."""
    return torch.where(mask[..., None].bool(), img.float(), 0.0)


def make_mask_single(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Predict-montage entry: default config, no host refinement."""
    return make_mask_core(img, TransformConfig(grabcut_refine=False))
