"""Separable filters, Sobel, Canny and the hysteresis flood.

Port of `leaffliction_tpu/ops/filters.py` (the parts the mask pipeline
reaches). Borders are cv2's reflect-101. Separable convolutions are written as
sums of shifted slices, taps added in order (the vertical pass first, then the
horizontal one), so the CUDA edge kernel can repeat the arithmetic exactly.
The Canny front end goes through `ops/kernels/edge.edge_nms`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SOBEL_D = np.array([-1.0, 0.0, 1.0], np.float32)
SOBEL_S = np.array([1.0, 2.0, 1.0], np.float32)


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel: sigma<=0 → 0.3*((ksize-1)*0.5 - 1) + 0.8."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def _taps_sum(x: torch.Tensor, taps: np.ndarray, dim: int, n: int):
    """sum_t taps[t] * x.narrow(dim, t, n), added in tap order."""
    acc = float(taps[0]) * x.narrow(dim, 0, n)
    for t in range(1, len(taps)):
        acc = acc + float(taps[t]) * x.narrow(dim, t, n)
    return acc


def sep_conv2d(img: torch.Tensor, kx: np.ndarray, ky: np.ndarray
               ) -> torch.Tensor:
    """Separable 2-D correlation over the last two dims, reflect-101 border:
    `ky` along rows (dim -2) first, then `kx` along columns."""
    x = img.float()
    shape = x.shape
    h, w = shape[-2], shape[-1]
    py, px = len(ky) // 2, len(kx) // 2
    x = F.pad(x.reshape(-1, 1, h, w), (px, px, py, py), mode="reflect")
    x = _taps_sum(x, ky, -2, h)
    x = _taps_sum(x, kx, -1, w)
    return x.reshape(shape)


def gaussian_blur(img: torch.Tensor, ksize: int = 5, sigma: float = 0.0
                  ) -> torch.Tensor:
    """cv2.GaussianBlur equivalent (reflect-101 border)."""
    k = gaussian_kernel_1d(ksize, sigma)
    return sep_conv2d(img, k, k)


def sobel_xy(gray: torch.Tensor):
    """cv2.Sobel ksize=3 x/y gradients (reflect-101 border)."""
    return sep_conv2d(gray, SOBEL_D, SOBEL_S), sep_conv2d(gray, SOBEL_S,
                                                          SOBEL_D)


def normalize_minmax(x: torch.Tensor, lo: float = 0.0, hi: float = 255.0
                     ) -> torch.Tensor:
    """cv2.normalize(NORM_MINMAX) equivalent."""
    mn, mx = x.min(), x.max()
    scale = (hi - lo) / torch.clamp(mx - mn, min=1e-12)
    return torch.where(mx > mn, (x - mn) * scale + lo,
                       torch.zeros_like(x) + lo)


def _dilate3x3(x: torch.Tensor) -> torch.Tensor:
    """Boolean 3x3 dilation of [h, w] with nothing beyond the edge."""
    f = x[None, None].float()
    return F.max_pool2d(F.pad(f, (1, 1, 1, 1)), 3, stride=1)[0, 0] > 0


def hysteresis_flood(strong: torch.Tensor, weak: torch.Tensor,
                     iters: int = 0) -> torch.Tensor:
    """Keep the weak pixels 8-connected to a strong pixel: grow `strong` by
    one 3x3 dilation per round inside `weak` until a round changes nothing
    (one host check per round). `iters=0` bounds the loop at h·w, the
    longest possible serpentine chain; a nonzero value caps the rounds."""
    h, w = weak.shape[-2], weak.shape[-1]
    cap = iters if iters else h * w
    s = strong
    for _ in range(cap):
        grown = weak & _dilate3x3(s)
        if torch.equal(grown, s):
            break
        s = grown
    return s


def canny(gray: torch.Tensor, low: float = 50.0, high: float = 150.0,
          l2: bool = False, hysteresis: bool = True) -> torch.Tensor:
    """cv2.Canny-style edges of one [h, w] image (bool).

    Gaussian 5x5 → Sobel → magnitude → NMS (`ops/kernels/edge.edge_nms`,
    the CUDA kernel on the card) → double threshold → hysteresis flood.
    `hysteresis=False` returns the NMS low-threshold edges directly."""
    from leaffliction_tpu_torch.ops.kernels.edge import edge_nms

    nms = edge_nms(gray.float()[None].contiguous(), l2=l2)[0]
    if not hysteresis:
        return nms > low
    return hysteresis_flood(nms > high, nms > low)
