"""Autocontrast: per-channel linear stretch past two cutoff quantiles.

Port of `leaffliction_tpu/ops/photometric.py`'s `autocontrast` and
`autocontrast_u8_exact`, batched over a leading image axis with one cutoff
percentage per image. PIL's `ImageOps.autocontrast` uses two bins of the
256-bin histogram of each channel: lo, the first value whose cumulative
count exceeds cut = cutoff·n/100, and hi, the last value whose count from
the top exceeds it. The JAX package finds them by an 8-step binary search of
those two monotone predicates; here the counts come from one histogram per
(image, channel), which gives the same two bins. Counts are integers and are
compared with the f32 cut exactly.

The other photometric ops of the JAX module, on float32 in [0, 255]:
`adjust_contrast` (about the per-channel mean, Keras RandomContrast's
math), `adjust_brightness` and `add_gaussian_noise`, which draws its
N(0, 1) noise from a `torch.Generator` where JAX takes a key (or takes the
draw itself, `normal`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b rounded once: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal instead, which can differ in the last
    bit from the JAX package and the kernels."""
    return a / torch.full_like(a, b)


def add_gaussian_noise(generator: Optional[torch.Generator],
                       img: torch.Tensor, sigma: float = 5.0,
                       normal: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Additive N(0, sigma) noise, clipped to [0, 255]
    (`image_augmenter.py:121-124`); `normal` is the N(0, 1) draw, drawn
    from `generator` when not given."""
    if normal is None:
        normal = torch.randn(img.shape, generator=generator,
                             device=img.device)
    return torch.clamp(img.float() + sigma * normal, 0.0, 255.0)


def adjust_contrast(img: torch.Tensor, factor) -> torch.Tensor:
    """Scale contrast about the per-channel mean (Keras RandomContrast
    math)."""
    mean = img.mean(dim=(-3, -2), keepdim=True)
    return torch.clamp(mean + (img - mean) * factor, 0.0, 255.0)


def adjust_brightness(img: torch.Tensor, delta) -> torch.Tensor:
    return torch.clamp(img + delta, 0.0, 255.0)


def cutoff_count(cutoff_percent, n: int, device) -> torch.Tensor:
    """cut = cutoff · n / 100 in f32, per image."""
    return true_div(torch.as_tensor(cutoff_percent, dtype=torch.float32,
                                    device=device) * n, 100.0)


def cutoff_bins(q: torch.Tensor, cut: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: integer values 0..255 [B, H, W, C]; cut: f32 [B] →
    (lo, hi) int64 [B, C]."""
    b, h, w, c = q.shape
    plane = (torch.arange(b, device=q.device)[:, None] * c
             + torch.arange(c, device=q.device)[None, :])      # [B, C]
    idx = plane[:, None, None, :] * 256 + q.long()
    hist = torch.bincount(idx.reshape(-1), minlength=b * c * 256)
    cdf = hist.reshape(b, c, 256).cumsum(-1)                   # count(q <= v)
    n = h * w
    rcdf = n - torch.cat([torch.zeros_like(cdf[..., :1]), cdf[..., :-1]],
                         -1)                                   # count(q >= v)
    cut = cut.double()[:, None, None]
    lo = (cdf.double() <= cut).sum(-1)
    hi = 255 - (rcdf.double() <= cut).sum(-1)
    return lo, hi


def remap(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
          ) -> torch.Tensor:
    """x*scale + offset per (image, channel); channels with hi <= lo stay
    untouched. x f32 [B, H, W, C], lo/hi [B, C] → f32, unclipped."""
    lo = lo.float()[:, None, None, :]
    hi = hi.float()[:, None, None, :]
    live = hi > lo
    scale = torch.where(live, torch.full_like(lo, 255.0)
                        / torch.clamp(hi - lo, min=1e-6), 1.0)
    offset = torch.where(live, -lo * scale, 0.0)
    return torch.where(live, x * scale + offset, x)


def autocontrast(img: torch.Tensor,
                 cutoff_percent: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] values in [0, 255] → f32 in [0, 255]."""
    x = img.float()
    q = torch.clamp(torch.round(x), 0, 255)
    lo, hi = cutoff_bins(q, cutoff_count(cutoff_percent,
                                         x.shape[1] * x.shape[2], x.device))
    return torch.clamp(remap(x, lo, hi), 0.0, 255.0)


def autocontrast_u8_exact(img_u8: torch.Tensor,
                          cutoff_percent: torch.Tensor) -> torch.Tensor:
    """`autocontrast` for uint8 with the integer remap
    (510·(v − lo) + span) // (2·span), span = hi − lo → uint8."""
    lo, hi = cutoff_bins(img_u8, cutoff_count(
        cutoff_percent, img_u8.shape[1] * img_u8.shape[2], img_u8.device))
    v = img_u8.long()
    lo = lo[:, None, None, :]
    span = (hi[:, None, None, :] - lo)
    num = 510 * (v - lo) + span
    out = torch.clamp(torch.div(num, torch.clamp(2 * span, min=1),
                                rounding_mode="floor"), 0, 255)
    return torch.where(span > 0, out, v).to(torch.uint8)
