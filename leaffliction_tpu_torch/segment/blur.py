"""Blur filter — disease-saliency map (reference `filters/blur.py:18-79`).

Port of `leaffliction_tpu/segment/blur.py`: saliency = 0.4·dilated Canny
(50/150, L2, through kernel K5) + 0.3·normalized Sobel + 0.6·brown regions
+ 0.2·unsharp colour difference, min-max normalized, Gaussian smoothed,
zeroed outside the leaf mask, returned as gray → RGB, on the device of the
image.
"""

from __future__ import annotations

import torch

from leaffliction_tpu_torch.ops.colorspace import rgb_to_gray, rgb_to_hsv
from leaffliction_tpu_torch.ops.filters import (
    canny,
    gaussian_blur,
    normalize_minmax,
    sobel_xy,
)
from leaffliction_tpu_torch.ops.morphology import closing, dilate
from leaffliction_tpu_torch.segment.config import TransformConfig


def blur_filter(rgb: torch.Tensor, leaf_mask: torch.Tensor,
                cfg: TransformConfig) -> torch.Tensor:
    """rgb float [0,255] [h, w, 3] + bool mask → f32 RGB saliency."""
    rgb = rgb.float()
    leaf = leaf_mask.bool()
    gray = rgb_to_gray(rgb)
    saliency = torch.zeros_like(gray)

    edges_dil = dilate(canny(gray, 50, 150, l2=True), 3, "ellipse")
    saliency = saliency + edges_dil.float() * 255.0 * 0.4

    gx, gy = sobel_xy(gray)
    grad_norm = normalize_minmax(torch.sqrt(gx * gx + gy * gy), 0.0, 255.0)
    saliency = saliency + torch.round(grad_norm) * 0.3

    hsv = rgb_to_hsv(rgb)
    lo, hi = cfg.brown_hue_range
    brown = ((hsv[..., 0] >= lo) & (hsv[..., 0] <= hi)
             & (hsv[..., 1] >= cfg.brown_s_min)
             & (hsv[..., 2] <= cfg.brown_v_max) & leaf)
    brown_dil = dilate(dilate(closing(brown, 3, "ellipse"), 3, "ellipse"),
                       3, "ellipse")
    saliency = saliency + brown_dil.float() * 255.0 * 0.6

    # the blur works per channel: channels first for the [..., h, w] filter
    blurred = gaussian_blur(rgb.permute(2, 0, 1), 15, 0.0).permute(1, 2, 0)
    color_diff = torch.abs(rgb - blurred).mean(dim=-1)
    saliency = saliency + normalize_minmax(color_diff, 0.0, 255.0) * 0.2

    sal_norm = torch.round(normalize_minmax(saliency, 0.0, 255.0))
    sal_blur = gaussian_blur(sal_norm, 5, cfg.gaussian_sigma)
    result = torch.clamp(torch.round(torch.where(leaf, sal_blur, 0.0)),
                         0, 255)
    return torch.stack([result, result, result], dim=-1)
