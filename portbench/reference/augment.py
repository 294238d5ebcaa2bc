"""Training augmentation in plain PyTorch: horizontal flip, rotation, contrast.

The Leaffliction reference trains with Keras RandomFlip("horizontal"),
RandomRotation(0.05) and RandomContrast(0.1). Per image a uniform draw
picks the flip (p = 0.5), the angle (±0.05·360°) and the contrast factor
(0.9 to 1.1), from one [3, n] draw of the training generator. The
rotation is a frozen copy of the port's plain K1 arithmetic: about
((h−1)/2, (w−1)/2) as three shears (rows by −tan(θ/2), columns by sin θ,
rows again), each a linear interpolation whose out-of-image sources take
the edge sample of their row or column; then per channel
clip(mean + (x − mean)·factor, 0, 1).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def draws(n: int, generator: torch.Generator, device
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(flip bool [n], angle in degrees [n], contrast factor [n])."""
    u = torch.rand((3, n), generator=generator, device=device)
    return u[0] < 0.5, -18.0 + u[1] * 36.0, 0.9 + u[2] * 0.2


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    return a / torch.full_like(a, b)


def _split12(v: torch.Tensor):
    hi = torch.round(v * 4096.0) / 4096.0
    return hi, v - hi


def _shear(src: torch.Tensor, shear: torch.Tensor, axis: int
           ) -> torch.Tensor:
    n, h, w, c = src.shape
    size, other = (w, h) if axis == 2 else (h, w)
    hi, lo = (v[:, None] for v in _split12(shear))
    sh = shear[:, None]
    off = (torch.arange(other, device=src.device, dtype=torch.float32)
           - (other - 1) / 2.0)
    g = sh * off
    k = torch.floor(g)
    f = (g - k)[..., None]
    lane = torch.arange(size, device=src.device)
    i0 = lane + k.clamp(-(size + 1), size + 1).long()[..., None]
    lane_f = lane.to(torch.float32)
    p_hi, p_lo = (hi * off)[..., None], (lo * off)[..., None]
    pos = (lane_f + p_hi) + p_lo
    high = ((lane_f - (size - 1)) + p_hi) + p_lo
    if axis == 1:
        i0, f, pos, high = (v.transpose(1, 2) for v in (i0, f, pos, high))

    def take(i: torch.Tensor) -> torch.Tensor:
        i = i.clamp(0, size - 1)[..., None].expand(n, h, w, c)
        return torch.gather(src, axis, i)

    f = f[..., None]
    out = take(i0) * (1.0 - f) + take(i0 + 1) * f
    return torch.where((pos >= 0.0)[..., None],
                       torch.where((high <= 0.0)[..., None], out,
                                   src.narrow(axis, size - 1, 1)),
                       src.narrow(axis, 0, 1))


def augment(images_u8: torch.Tensor, flip: torch.Tensor,
            angles: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """uint8 N×H×W×3 → float32 in [0, 1], flipped, rotated and
    contrast-adjusted."""
    x = torch.where(flip[:, None, None, None], images_u8.flip(2), images_u8)
    x = _div(x.float(), 255.0)
    theta = angles.float() * (math.pi / 180.0)
    t, s = -torch.tan(theta / 2.0), torch.sin(theta)
    x = _shear(_shear(_shear(x, t, 2), s, 1), t, 2)
    h, w = x.shape[1], x.shape[2]
    mean = _div(x.sum(dim=(1, 2), keepdim=True), float(h * w))
    return torch.clamp(mean + (x - mean) * factors[:, None, None, None],
                       0.0, 1.0)
