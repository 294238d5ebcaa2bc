"""The six dataset-balancing augmentation ops, batched over uint8 NHWC.

Port of `leaffliction_tpu/ops/augment.py` (the reference's `ImageAugmenter`,
`srcs/preprocessing/image_augmenter.py:12-133`). Each op is split in two:
`draw_<op>(rngs, hw, device)` draws its parameters, one `numpy` generator
per image, and returns them as a dict of tensors; `<op>_batch(imgs,
**params)` computes the pixels. The JAX package draws from threefry keys,
which the port does not reproduce: the parity tests hand JAX's drawn values
to the `*_batch` functions, and the port's own draws are held by their
bounds.

- flip: a coin, horizontal or vertical;
- rotate: U(±30°), expand canvas `rotate_canvas_hw` with white fill →
  kernel K2 (`ops/kernels/warp.rotate_expand`); the caller crops back;
- skew: s ∈ U(0.05, 0.15), bicubic `scale_translate_warp`, black fill;
- shear: s ∈ U(±0.2) and a direction coin → kernel K3
  (`ops/kernels/warp.shear_cubic`), as the TPU path runs its Pallas kernel;
- crop: ratio U(0.8, 0.95), a uniform corner, lanczos3 resize back with
  edge clamp;
- distortion: N(0, 1) noise at f16 width, ×5, clip, then `autocontrast`
  with cutoff U(0, 2)%. With `LEAF_STRICT_DISTORTION=1`: noise from the
  2048-entry inverse-CDF table, the reference's uint8 wrap arithmetic
  (`wrap_noise_u8`) and the integer remap (`autocontrast_u8_exact`); exact
  integer ops given the noise, not the JAX package's bytes (threefry is not
  reproduced). The strict table indices are drawn on the CPU whatever the
  device, so a seed gives the same strict bytes on the card and on the
  CPU. With `LEAF_PALLAS_DISTORT=1`: kernel K6
  (`ops/kernels/distortion.distortion`), Irwin-Hall noise from per-plane
  seeds. The default stays plain PyTorch, as the JAX default stays XLA.

The port promises only the distribution of default-mode noise (drawn by
`torch.randn` on the device), as the JAX host pool does; strict-mode noise
depends on the seed alone.

CPU tensors take the kernels' plain twins; CUDA tensors launch the kernels.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from leaffliction_tpu_torch.ops.kernels.distortion import distortion
from leaffliction_tpu_torch.ops.kernels.warp import rotate_expand, shear_cubic
from leaffliction_tpu_torch.ops.photometric import (
    autocontrast,
    autocontrast_u8_exact,
)
from leaffliction_tpu_torch.ops.resample import scale_translate_warp

# parameter bounds (reference `image_augmenter.py:33-133`)
MAX_ROTATE_DEG = 30.0
SKEW_RANGE = (0.05, 0.15)
SHEAR_MAX = 0.2
CROP_RATIO_RANGE = (0.8, 0.95)
CUTOFF_MAX = 2.0
NOISE_STD = 5.0


def rotate_canvas_hw(h: int, w: int) -> Tuple[int, int]:
    """Static canvas holding every intermediate of the 3-shear rotation up
    to ±30° with expand=True: the rotated box, the centred input and the
    first row shear's extent w + tan(15°)·h."""
    c = math.cos(math.radians(MAX_ROTATE_DEG))
    s = math.sin(math.radians(MAX_ROTATE_DEG))
    t = math.tan(math.radians(MAX_ROTATE_DEG) / 2.0)
    oh = max(h, math.ceil(h * c + w * s))
    ow = max(w, math.ceil(w + t * h), math.ceil(w * c + h * s))
    return (oh, ow)


def pil_expanded_size(angle_deg: float, w: int, h: int) -> Tuple[int, int]:
    """PIL `rotate(expand=True)` output size: its matrix with the centre
    translation, cos/sin rounded to 15 decimals, then ceil/floor."""
    angle = -math.radians(angle_deg % 360.0)
    m = [
        round(math.cos(angle), 15), round(math.sin(angle), 15), 0.0,
        round(-math.sin(angle), 15), round(math.cos(angle), 15), 0.0,
    ]

    def transform(x: float, y: float) -> Tuple[float, float]:
        return m[0] * x + m[1] * y + m[2], m[3] * x + m[4] * y + m[5]

    cx, cy = w / 2.0, h / 2.0
    m[2], m[5] = transform(-cx, -cy)
    m[2] += cx
    m[5] += cy
    xx, yy = [], []
    for x, y in ((0, 0), (w, 0), (w, h), (0, h)):
        tx, ty = transform(x, y)
        xx.append(tx)
        yy.append(ty)
    nw = math.ceil(max(xx)) - math.floor(min(xx))
    nh = math.ceil(max(yy)) - math.floor(min(yy))
    return nw, nh


def _acklam_ndtri(p: np.ndarray) -> np.ndarray:
    """Inverse normal CDF in float64 (Acklam's rational approximation,
    |relative error| < 1.15e-9)."""
    p = np.asarray(p, np.float64)
    a = [-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00]
    lo, hi = 0.02425, 1.0 - 0.02425
    m = p < lo
    q = np.sqrt(-2.0 * np.log(np.where(m, p, 0.5)))
    out_lo = (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
              + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q
                         + 1.0)
    m_hi = p > hi
    q = np.sqrt(-2.0 * np.log(np.where(m_hi, 1.0 - p, 0.5)))
    out_hi = -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
               + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q
                          + 1.0)
    q = p - 0.5
    r = q * q
    out_mid = ((((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r
                + a[5]) * q
               / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4])
                  * r + 1.0))
    return np.where(m, out_lo, np.where(m_hi, out_hi, out_mid))


STRICT_NOISE_BITS = 11  # 2048 quantiles


def strict_noise_table() -> np.ndarray:
    """f32 [2048]: the inverse normal CDF at the bin centres."""
    n = 1 << STRICT_NOISE_BITS
    q = (np.arange(n, dtype=np.float64) + 0.5) / n
    return _acklam_ndtri(q).astype(np.float32)


def _env_on(name: str) -> bool:
    return os.environ.get(name, "") not in ("", "0", "false")


def strict_distortion() -> bool:
    """`LEAF_STRICT_DISTORTION=1`: the reference's uint8 wrap arithmetic."""
    return _env_on("LEAF_STRICT_DISTORTION")


def kernel_distortion() -> bool:
    """`LEAF_PALLAS_DISTORT=1`: distortion through kernel K6."""
    return _env_on("LEAF_PALLAS_DISTORT")


# --- parameter draws: one numpy generator per image -------------------------

Rngs = Sequence[np.random.Generator]


def _f32(values, device) -> torch.Tensor:
    return torch.tensor(np.asarray(values, np.float32), device=device)


def draw_flip(rngs: Rngs, hw, device) -> Dict[str, torch.Tensor]:
    return {"horizontal": torch.tensor([bool(r.random() < 0.5) for r in rngs],
                                       device=device)}


def draw_rotate(rngs: Rngs, hw, device) -> Dict[str, torch.Tensor]:
    return {"angles": _f32([r.uniform(-MAX_ROTATE_DEG, MAX_ROTATE_DEG)
                            for r in rngs], device)}


def draw_skew(rngs: Rngs, hw, device) -> Dict[str, torch.Tensor]:
    return {"s": _f32([r.uniform(*SKEW_RANGE) for r in rngs], device)}


def draw_shear(rngs: Rngs, hw, device) -> Dict[str, torch.Tensor]:
    draws = [(r.uniform(-SHEAR_MAX, SHEAR_MAX), r.random() < 0.5)
             for r in rngs]
    return {"s": _f32([d[0] for d in draws], device),
            "horizontal": torch.tensor([bool(d[1]) for d in draws],
                                       device=device)}


def crop_corner(ratio: torch.Tensor, u_left: torch.Tensor,
                u_top: torch.Tensor, hw) -> Tuple[torch.Tensor, torch.Tensor]:
    """The crop's corner from uniforms in [0, 1), as the JAX op floors it."""
    h, w = hw
    new_w = torch.floor(w * ratio)
    new_h = torch.floor(h * ratio)
    return (torch.floor(u_left * (w - new_w + 1.0)),
            torch.floor(u_top * (h - new_h + 1.0)))


def crop_uniforms(rngs: Rngs) -> np.ndarray:
    """f32 [n, 3]: each image's ratio and the corner's two uniforms."""
    return np.asarray([(r.uniform(*CROP_RATIO_RANGE), r.random(), r.random())
                       for r in rngs], np.float32).reshape(-1, 3)


def draw_crop(rngs: Rngs, hw, device) -> Dict[str, torch.Tensor]:
    draws = crop_uniforms(rngs)
    ratio, u_left, u_top = (_f32(draws[:, i], device) for i in range(3))
    left, top = crop_corner(ratio, u_left, u_top, hw)
    return {"ratio": ratio, "left": left, "top": top}


def _per_image(rngs: Rngs, device, make) -> torch.Tensor:
    """Stack `make(generator)` over torch generators seeded from each
    image's numpy generator, on `device`."""
    out = []
    for r in rngs:
        g = torch.Generator(device=device)
        g.manual_seed(int(r.integers(0, 2 ** 63 - 1)))
        out.append(make(g))
    return torch.stack(out)


def strict_noise_indices(rngs: Rngs, hw) -> torch.Tensor:
    """int16 [n, h, w, 3] table indices, drawn on CPU generators seeded
    from each image's numpy generator: the same on every device."""
    h, w = hw
    return _per_image(rngs, "cpu", lambda g: torch.randint(
        0, 1 << STRICT_NOISE_BITS, (h, w, 3), generator=g,
        dtype=torch.int16))


def draw_distortion(rngs: Rngs, hw, device) -> Dict[str, object]:
    """The cutoff percentage and, by mode, the unit noise (default: normal
    at f16 width on `device`; strict: the table at indices drawn on the CPU
    and uploaded as int16) or K6's per-plane seeds."""
    h, w = hw
    cutoffs = _f32([r.uniform(0.0, CUTOFF_MAX) for r in rngs], device)
    if strict_distortion():
        table = torch.from_numpy(strict_noise_table()).to(device)
        idx = strict_noise_indices(rngs, hw).to(device)
        return {"cutoffs": cutoffs, "noise": table[idx.int()],
                "strict": True}
    if kernel_distortion():
        seeds = torch.tensor(np.stack([r.integers(0, 2 ** 32, 3)
                                       for r in rngs]).reshape(-1, 3),
                             dtype=torch.int64, device=device)
        return {"cutoffs": cutoffs, "seeds": seeds}
    noise = _per_image(rngs, device, lambda g: torch.randn(
        (h, w, 3), generator=g, device=device))
    return {"cutoffs": cutoffs,
            "noise": noise.to(torch.float16).to(torch.float32)}


# --- the batch ops: uint8 [n, h, w, 3] in, uint8 out ------------------------


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def flip_batch(imgs: torch.Tensor, horizontal: torch.Tensor) -> torch.Tensor:
    h = horizontal.to(imgs.device, torch.bool)[:, None, None, None]
    return torch.where(h, imgs.flip(2), imgs.flip(1))


def rotate_batch(imgs: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """→ uint8 on the `rotate_canvas_hw` canvas (kernel K2)."""
    return rotate_expand(imgs, angles,
                         rotate_canvas_hw(imgs.shape[1], imgs.shape[2]))


def skew_batch(imgs: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """PIL PERSPECTIVE [1+s, 0, −s·w, 0, 1+s, −s·h, 0, 0] at pixel centres
    (+0.5·s), bicubic, black fill."""
    h, w = imgs.shape[1], imgs.shape[2]
    s = s.to(imgs.device, torch.float32)
    scale = torch.stack([1.0 + s, 1.0 + s], 1)
    offset = torch.stack([-s * w + 0.5 * s, -s * h + 0.5 * s], 1)
    return _to_u8(scale_translate_warp(imgs, scale, offset, (h, w), fill=0.0,
                                       kernel="bicubic"))


def shear_batch(imgs: torch.Tensor, s: torch.Tensor,
                horizontal: torch.Tensor) -> torch.Tensor:
    """PIL AFFINE [1,s,0,0,1,0] or [1,0,0,s,1,0], bicubic, black fill
    (kernel K3)."""
    return shear_cubic(imgs, s, horizontal)


def crop_batch(imgs: torch.Tensor, ratio: torch.Tensor, left: torch.Tensor,
               top: torch.Tensor) -> torch.Tensor:
    """Crop `ratio` of each side at (left, top), lanczos3 resize back to
    (h, w) with PIL's pixel-centre mapping and edge clamp."""
    h, w = imgs.shape[1], imgs.shape[2]
    dev = imgs.device
    ratio, left, top = (v.to(dev, torch.float32) for v in (ratio, left, top))
    ax = torch.floor(w * ratio) / w
    ay = torch.floor(h * ratio) / h
    scale = torch.stack([ax, ay], 1)
    offset = torch.stack([left + 0.5 * ax - 0.5, top + 0.5 * ay - 0.5], 1)
    return _to_u8(scale_translate_warp(imgs, scale, offset, (h, w),
                                       fill=None, kernel="lanczos3"))


def wrap_noise_u8(img_u8: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The reference's noise arithmetic: float noise cast to uint8 (truncate
    toward zero, then wrap mod 256) added with uint8 overflow → uint8."""
    n_i = torch.trunc(noise).to(torch.int64)
    return ((img_u8.to(torch.int64) + torch.remainder(n_i, 256)) % 256
            ).to(torch.uint8)


def distortion_batch(imgs: torch.Tensor, cutoffs: torch.Tensor,
                     noise: Optional[torch.Tensor] = None,
                     seeds: Optional[torch.Tensor] = None,
                     strict: bool = False) -> torch.Tensor:
    """Noise + autocontrast. `noise` is unit noise [n, h, w, 3] (scaled by
    5 here); `seeds` [n, 3] selects kernel K6 instead; `strict` the wrap
    arithmetic."""
    cutoffs = cutoffs.to(imgs.device, torch.float32)
    if seeds is not None:
        return distortion(imgs, seeds, cutoffs)
    noise = noise.to(imgs.device, torch.float32)
    if strict:
        wrapped = wrap_noise_u8(imgs, NOISE_STD * noise)
        return autocontrast_u8_exact(wrapped, cutoffs)
    x = torch.clamp(imgs.float() + NOISE_STD * noise, 0.0, 255.0)
    return _to_u8(autocontrast(x, cutoffs))


DRAWS = {
    "flip": draw_flip,
    "rotate": draw_rotate,
    "skew": draw_skew,
    "shear": draw_shear,
    "crop": draw_crop,
    "distortion": draw_distortion,
}

BATCH_KERNELS = {
    "flip": flip_batch,
    "rotate": rotate_batch,
    "skew": skew_batch,
    "shear": shear_batch,
    "crop": crop_batch,
    "distortion": distortion_batch,
}
