"""Separable filters, Sobel, Canny, the hysteresis flood and Shi-Tomasi
corners.

Port of `leaffliction_tpu/ops/filters.py` (the parts the segmentation stack
reaches), batched over leading axes: images are [..., h, w], and one `canny`
of a batch is one launch of the edge kernel. Borders are cv2's reflect-101. Separable convolutions are written as
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


def sobel_magnitude(gray: torch.Tensor) -> torch.Tensor:
    gx, gy = sobel_xy(gray)
    return torch.sqrt(gx * gx + gy * gy)


def quantize_gradient_sector(gx: torch.Tensor, gy: torch.Tensor
                             ) -> torch.Tensor:
    """Gradient orientation quantised to the {0°, 45°, 90°, 135°} sectors
    (0-3) by ratio comparisons, without atan2: tan(22.5°) and tan(67.5°)
    bound the diagonal band, and the sign of gx·gy tells 45° from 135°."""
    ax, ay = gx.abs(), gy.abs()
    t1, t2 = 0.41421356, 2.41421356
    diag = torch.where((gx * gy) >= 0, 1, 3)
    return torch.where(ay <= t1 * ax, 0, torch.where(ay > t2 * ax, 2, diag)
                       ).to(torch.int32)


def normalize_minmax(x: torch.Tensor, lo: float = 0.0, hi: float = 255.0
                     ) -> torch.Tensor:
    """cv2.normalize(NORM_MINMAX) equivalent, each [h, w] image of
    [..., h, w] on its own range."""
    mn = x.amin(dim=(-2, -1), keepdim=True)
    mx = x.amax(dim=(-2, -1), keepdim=True)
    scale = (hi - lo) / torch.clamp(mx - mn, min=1e-12)
    return torch.where(mx > mn, (x - mn) * scale + lo,
                       torch.zeros_like(x) + lo)


def _dilate3x3(x: torch.Tensor) -> torch.Tensor:
    """Boolean 3x3 dilation of [..., h, w] with nothing beyond the edge."""
    h, w = x.shape[-2], x.shape[-1]
    f = x.reshape(-1, 1, h, w).float()
    return (F.max_pool2d(F.pad(f, (1, 1, 1, 1)), 3, stride=1) > 0
            ).reshape(x.shape)


def hysteresis_flood(strong: torch.Tensor, weak: torch.Tensor,
                     iters: int = 0) -> torch.Tensor:
    """Keep the weak pixels 8-connected to a strong pixel: grow `strong` by
    one 3x3 dilation per round inside `weak` until a round changes nothing
    (one host check per round; images of a batch that have converged stay
    as they are, so a batch gives each image's own flood). `iters=0` bounds
    the loop at h·w, the longest possible serpentine chain; a nonzero value
    caps the rounds."""
    h, w = weak.shape[-2], weak.shape[-1]
    cap = iters if iters else h * w
    s = strong
    for _ in range(cap):
        grown = weak & _dilate3x3(s)
        if torch.equal(grown, s):
            break
        s = grown
    return s


def _edge_nms(gray: torch.Tensor, l2: bool) -> torch.Tensor:
    """`ops/kernels/edge.edge_nms`, imported at the call (that module imports
    this one): the one name through which `canny` reaches the kernel."""
    from leaffliction_tpu_torch.ops.kernels.edge import edge_nms

    return edge_nms(gray, l2)


def canny(gray: torch.Tensor, low: float = 50.0, high: float = 150.0,
          l2: bool = False, hysteresis: bool = True) -> torch.Tensor:
    """cv2.Canny-style edges of [..., h, w] images (bool).

    Gaussian 5x5 → Sobel → magnitude → NMS (`ops/kernels/edge.edge_nms`,
    one launch of the CUDA kernel for the whole batch on the card) → double
    threshold → hysteresis flood. `hysteresis=False` returns the NMS
    low-threshold edges directly."""
    h, w = gray.shape[-2], gray.shape[-1]
    nms = _edge_nms(gray.float().reshape(-1, h, w).contiguous(), l2
                    ).reshape(gray.shape)
    if not hysteresis:
        return nms > low
    return hysteresis_flood(nms > high, nms > low)


def good_features_to_track(gray: torch.Tensor, mask: torch.Tensor,
                           max_corners: int = 64,
                           quality_level: float = 0.01,
                           min_distance: int = 5, block_size: int = 3):
    """Shi-Tomasi corners of one [h, w] image (cv2.goodFeaturesToTrack).

    → (ys, xs, valid), each [max_corners]: the strongest candidates by
    value, ties to the lower flat index as `jax.lax.top_k` orders them (a
    stable descending sort; `torch.topk` on CUDA is not stable). `valid`
    marks entries above quality_level·max and inside `mask`; the NMS is a
    (2r+1)² max-pool, r = max(min_distance, 1)."""
    g = gray.float()
    gx, gy = sobel_xy(g)
    k = np.ones((block_size,), np.float32)
    ixx = sep_conv2d(gx * gx, k, k)
    iyy = sep_conv2d(gy * gy, k, k)
    ixy = sep_conv2d(gx * gy, k, k)
    # min eigenvalue of [[ixx, ixy], [ixy, iyy]]
    tr = ixx + iyy
    d = ixx - iyy
    det_term = torch.sqrt(torch.clamp(d * d + 4 * ixy * ixy, min=0.0))
    min_eig = 0.5 * (tr - det_term)
    min_eig = torch.where(mask.bool(), min_eig, 0.0)

    r = max(min_distance, 1)
    pooled = F.max_pool2d(F.pad(min_eig[None, None], (r, r, r, r),
                                value=-torch.inf), 2 * r + 1, stride=1)[0, 0]
    peak = (min_eig >= pooled) & (min_eig > 0)
    qual_thresh = quality_level * min_eig.max()
    cand = torch.where(peak & (min_eig >= qual_thresh), min_eig, -torch.inf)

    vals, idx = torch.sort(cand.reshape(-1), descending=True, stable=True)
    vals, idx = vals[:max_corners], idx[:max_corners]
    w = gray.shape[-1]
    return idx // w, idx % w, torch.isfinite(vals) & (vals > 0)
