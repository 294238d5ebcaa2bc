"""Color-space conversions with OpenCV 8-bit conventions.

Port of `leaffliction_tpu/ops/colorspace.py`: float32 or uint8 RGB in
[0, 255], HWC or NHWC, → float32 in cv2 ranges (HSV: H ∈ [0, 180),
S, V ∈ [0, 255]; LAB: L, a, b ∈ [0, 255] with a, b offset by 128), and
`hsv_to_rgb` back from those HSV ranges.
`rgb_to_hsv` scales by the float32 reciprocal of 255, as XLA compiles JAX's
division by a constant, so the HSV values, and the thresholds that land on
them, are the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

_INV_255 = float(np.float32(1.0) / np.float32(255.0))


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """cv2 COLOR_RGB2GRAY: Y = 0.299 R + 0.587 G + 0.114 B."""
    x = img.float()
    return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


def rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """cv2 COLOR_RGB2HSV for 8-bit: H ∈ [0,180), S,V ∈ [0,255]."""
    x = img.float() * _INV_255
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = x.amax(dim=-1)
    c = v - x.amin(dim=-1)
    safe_c = torch.where(c > 0, c, 1.0)
    h = torch.where(
        v == r, (g - b) / safe_c,
        torch.where(v == g, 2.0 + (b - r) / safe_c, 4.0 + (r - g) / safe_c),
    )
    h = torch.where(c > 0, h, 0.0) * 60.0
    h = torch.where(h < 0, h + 360.0, h)
    s = torch.where(v > 0, c / torch.where(v > 0, v, 1.0), 0.0)
    return torch.stack([h * 0.5, s * 255.0, v * 255.0], dim=-1)


def _srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    """Real cube root (PyTorch has no cbrt)."""
    return torch.sign(t) * t.abs() ** (1.0 / 3.0)


def rgb_to_lab(img: torch.Tensor) -> torch.Tensor:
    """cv2 COLOR_RGB2LAB for 8-bit: L,a,b ∈ [0,255] with a,b offset +128."""
    x = _srgb_to_linear(img.float() / 255.0)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    # sRGB D65 → XYZ, normalized by the white point
    X = (0.412453 * r + 0.357580 * g + 0.180423 * b) / 0.950456
    Y = 0.212671 * r + 0.715160 * g + 0.072169 * b
    Z = (0.019334 * r + 0.119193 * g + 0.950227 * b) / 1.088754

    def f(t: torch.Tensor) -> torch.Tensor:
        return torch.where(t > 0.008856, _cbrt(t), 7.787 * t + 16.0 / 116.0)

    fx, fy, fz = f(X), f(Y), f(Z)
    L = torch.where(Y > 0.008856, 116.0 * _cbrt(Y) - 16.0, 903.3 * Y)
    a = 500.0 * (fx - fy) + 128.0
    bb = 200.0 * (fy - fz) + 128.0
    return torch.stack([L * 255.0 / 100.0, a, bb], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """Inverse of rgb_to_hsv (cv2 ranges in, float RGB [0,255] out)."""
    h = hsv[..., 0] * 2.0 / 60.0  # sector in [0,6)
    s = hsv[..., 1] / 255.0
    v = hsv[..., 2] / 255.0
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6).long()[None]
    # the value of each sector 0-5 for each channel
    r = torch.stack([v, q, p, p, t, v]).gather(0, i)[0]
    g = torch.stack([t, v, v, q, p, p]).gather(0, i)[0]
    b = torch.stack([p, p, t, v, v, q]).gather(0, i)[0]
    return torch.stack([r, g, b], dim=-1) * 255.0
