"""Otsu thresholding.

Port of `leaffliction_tpu/ops/threshold.py`: a 256-bin histogram and the
argmax of the inter-class variance, cv2-compatible (foreground is value > t).
Counts are exact integers in float32, and the variance is computed with the
same operations in the same order as the JAX version, so the threshold is
the same. Each [h, w] image of [..., h, w] gets its own histogram and
threshold. `in_range` is cv2's `inRange`.
"""

from __future__ import annotations

import torch


def histogram_256(img: torch.Tensor) -> torch.Tensor:
    """256-bin f32 histograms of 8-bit single-channel images: [..., h, w]
    → [..., 256]."""
    h, w = img.shape[-2], img.shape[-1]
    q = torch.clamp(torch.round(img.float()), 0, 255).reshape(-1, h * w)
    b = q.shape[0]
    offs = torch.arange(b, device=q.device)[:, None] * 256
    hist = torch.bincount((q.long() + offs).reshape(-1), minlength=b * 256)
    return hist.reshape(*img.shape[:-2], 256).float()


def otsu_threshold(img: torch.Tensor) -> torch.Tensor:
    """Otsu's threshold value (f32, one per [h, w] image) over
    t ∈ [0, 255]."""
    hist = histogram_256(img)
    total = hist.sum(dim=-1, keepdim=True)
    bins = torch.arange(256, dtype=torch.float32, device=hist.device)
    w0 = torch.cumsum(hist, -1)
    sum0 = torch.cumsum(hist * bins, -1)
    w1 = total - w0
    mu0 = sum0 / torch.clamp(w0, min=1e-9)
    mu1 = (sum0[..., -1:] - sum0) / torch.clamp(w1, min=1e-9)
    d = mu0 - mu1
    between = w0 * w1 * (d * d)
    between = torch.where((w0 > 0) & (w1 > 0), between, -1.0)
    return torch.argmax(between, dim=-1).float()


def otsu_binarize(img: torch.Tensor, invert: bool = False) -> torch.Tensor:
    """Binary mask (bool) from Otsu; invert=True for THRESH_BINARY_INV."""
    fg = img.float() > otsu_threshold(img)[..., None, None]
    return ~fg if invert else fg


def in_range(img: torch.Tensor, lo, hi) -> torch.Tensor:
    """cv2.inRange over the last axis: all channels within [lo, hi]
    (bool)."""
    x = img.float()
    lo = torch.as_tensor(lo, dtype=torch.float32, device=x.device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=x.device)
    if x.dim() == lo.dim():  # single channel
        return (x >= lo) & (x <= hi)
    return ((x >= lo) & (x <= hi)).all(dim=-1)
