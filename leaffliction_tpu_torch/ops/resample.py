"""Image resampling as weighted sums: per-axis weight matrices and matmuls.

Port of `leaffliction_tpu/ops/resample.py` in plain PyTorch, batched over a
leading image axis with one parameter per image. Each pass resamples one axis
with a dense weight matrix built from a kernel (bilinear 2-tap, Keys bicubic
a = −0.5 4-tap, lanczos3 6-tap as a degree-10 polynomial in d²) and applied
with `einsum`/`bmm`, as the JAX package computes these outside any Pallas
kernel. The wide kernels renormalise their weights over the source axis and
take PIL's half-open validity band `[-0.5, size - 0.5)`; bilinear keeps
`[0, size - 1]`. `fill=None` is edge clamp: positions are clipped to the
array before the weights are built.

`scale_translate_warp` (skew, crop, the rotate resize-back) shares one
[K, out] matrix per image and axis. `shear_warp` and `rotate_warp` build
per-row weights ([H, K, W] per image), so they are references for the tests
and the CPU: the balance path runs kernels K2 and K3 for them
(`ops/kernels/warp.py`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_CUBIC_A = -0.5

# sinc(d)·sinc(d/3) on |d| < 3 as a power-basis polynomial in u = d²/4.5 − 1,
# highest degree first (the JAX package's `_LANCZOS3_POLY`)
_LANCZOS3_POLY = (
    4.6278630530e-03, -2.2417496681e-02, 7.9319918942e-02, -2.3415820829e-01,
    4.9310521192e-01, -6.4119983731e-01, 3.3350401427e-01, 2.6843769037e-01,
    -4.3054831639e-01, 1.2933954330e-01, 1.9992452203e-02,
)


def _tri(d: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - d.abs(), min=0.0)


def _cubic(d: torch.Tensor) -> torch.Tensor:
    a = _CUBIC_A
    ad = d.abs()
    ad2 = ad * ad
    ad3 = ad2 * ad
    near = (a + 2.0) * ad3 - (a + 3.0) * ad2 + 1.0
    far = a * (ad3 - 5.0 * ad2 + 8.0 * ad - 4.0)
    return torch.where(ad <= 1.0, near,
                       torch.where(ad < 2.0, far, torch.zeros_like(far)))


def _lanczos3(d: torch.Tensor) -> torch.Tensor:
    u = torch.clamp(d * d * (1.0 / 4.5) - 1.0, max=1.0)
    acc = torch.full_like(u, _LANCZOS3_POLY[0])
    for coef in _LANCZOS3_POLY[1:]:
        acc = acc * u + coef
    return torch.where(d.abs() < 3.0, acc, torch.zeros_like(acc))


_KERNELS = {"bilinear": _tri, "bicubic": _cubic, "lanczos3": _lanczos3}


def _weights(k: torch.Tensor, pos: torch.Tensor, kernel: str,
             k_axis: int) -> torch.Tensor:
    """kfn(k − pos), renormalised over `k_axis` for the wide kernels."""
    w = _KERNELS[kernel](k - pos)
    if kernel != "bilinear":
        w = w / torch.clamp(w.sum(dim=k_axis, keepdim=True), min=1e-6)
    return w


def _in_bounds(src: torch.Tensor, upper: float, kernel: str) -> torch.Tensor:
    if kernel == "bilinear":
        return (src >= 0.0) & (src <= upper)
    return (src >= -0.5) & (src < upper + 0.5)


def _shared_weights(src: torch.Tensor, k_dim: int, fill: Optional[float],
                    kernel: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """src [B, out] source positions → (weights [B, K, out], in-bounds
    [B, out])."""
    upper = float(k_dim - 1)
    k = torch.arange(k_dim, dtype=torch.float32, device=src.device)
    pos = src if fill is not None else torch.clamp(src, 0.0, upper)
    w = _weights(k[None, :, None], pos[:, None, :], kernel, 1)
    return w, _in_bounds(src, upper, kernel)


def scale_translate_warp(imgs: torch.Tensor, scale_xy: torch.Tensor,
                         offset_xy: torch.Tensor, out_hw: Tuple[int, int],
                         fill: Optional[float] = None,
                         kernel: str = "bilinear") -> torch.Tensor:
    """Axis-aligned affine per image: x_src = sx·x + ox, y_src = sy·y + oy.

    imgs [B, H, W, C] (any dtype, computed in f32); scale_xy, offset_xy
    [B, 2] → f32 [B, out_h, out_w, C]. Rows first, then columns, as the JAX
    function."""
    out_h, out_w = out_hw
    x = imgs.float()
    b, h, w, c = x.shape
    dev = x.device
    scale_xy = scale_xy.to(dev, torch.float32)
    offset_xy = offset_xy.to(dev, torch.float32)
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)

    wy, inb_y = _shared_weights(scale_xy[:, 1:2] * ys + offset_xy[:, 1:2],
                                h, fill, kernel)                # [B, H, oh]
    mid = torch.bmm(wy.transpose(1, 2), x.reshape(b, h, w * c))
    mid = mid.reshape(b, out_h, w, c)
    if fill is not None:
        mid = torch.where(inb_y[:, :, None, None], mid, fill)

    wx, inb_x = _shared_weights(scale_xy[:, 0:1] * xs + offset_xy[:, 0:1],
                                w, fill, kernel)                # [B, W, ow]
    out = torch.bmm(mid.permute(0, 1, 3, 2).reshape(b, out_h * c, w), wx)
    out = out.reshape(b, out_h, c, out_w).permute(0, 1, 3, 2)
    if fill is not None:
        out = torch.where(inb_x[:, None, :, None], out, fill)
    return out.contiguous()


def _row_resample(img: torch.Tensor, src: torch.Tensor,
                  fill: Optional[float], kernel: str) -> torch.Tensor:
    """Along W: img [H, K, C], src [H, W_out] → [H, W_out, C]."""
    k_dim = img.shape[1]
    upper = float(k_dim - 1)
    k = torch.arange(k_dim, dtype=torch.float32, device=img.device)
    pos = src if fill is not None else torch.clamp(src, 0.0, upper)
    w = _weights(k[None, :, None], pos[:, None, :], kernel, 1)  # [H, K, W]
    out = torch.einsum("hkc,hkx->hxc", img, w)
    if fill is not None:
        out = torch.where(_in_bounds(src, upper, kernel)[..., None], out,
                          fill)
    return out


def _col_resample(img: torch.Tensor, src: torch.Tensor,
                  fill: Optional[float], kernel: str) -> torch.Tensor:
    """Along H: img [K, W, C], src [W, H_out] → [H_out, W, C]."""
    k_dim = img.shape[0]
    upper = float(k_dim - 1)
    k = torch.arange(k_dim, dtype=torch.float32, device=img.device)
    pos = src if fill is not None else torch.clamp(src, 0.0, upper)
    w = _weights(k[None, :, None], pos[:, None, :], kernel, 1)  # [W, K, H]
    out = torch.einsum("kxc,xkz->zxc", img, w)
    if fill is not None:
        out = torch.where(_in_bounds(src, upper, kernel).T[..., None], out,
                          fill)
    return out


def shear_warp(imgs: torch.Tensor, shears: torch.Tensor,
               horizontal: torch.Tensor, out_hw: Tuple[int, int],
               fill: Optional[float] = 0.0, kernel: str = "bilinear",
               half_px: bool = False) -> torch.Tensor:
    """Origin-anchored PIL shear per image ([1,s,0,0,1,0] when horizontal,
    else [1,0,0,s,1,0]); `half_px` applies the coefficients at pixel
    centres. imgs [B, H, W, C], shears [B], horizontal [B] bool → f32."""
    out_h, out_w = out_hw
    x = imgs.float()
    dev = x.device
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    c = 0.5 if half_px else 0.0
    outs = []
    for img, s, horiz in zip(x, shears.float().cpu().tolist(),
                             horizontal.bool().cpu().tolist()):
        s = torch.tensor(s, dtype=torch.float32, device=dev)
        if horiz:
            src = xs[None, :] + s * (ys[:, None] + c)        # [H, W]
            outs.append(_row_resample(img, src, fill, kernel))
        else:
            src = ys[None, :] + s * (xs[:, None] + c)        # [W, H]
            outs.append(_col_resample(img, src, fill, kernel))
    return torch.stack(outs)


def rotate_warp(imgs: torch.Tensor, angles_deg: torch.Tensor,
                out_hw: Tuple[int, int],
                fill: Optional[float] = 255.0) -> torch.Tensor:
    """Centre rotation into an (often larger) canvas by the three shears
    shear_x(−tan(θ/2)) · shear_y(sin θ) · shear_x(−tan(θ/2)), each a
    bilinear pass with per-pass fill. imgs [B, h, w, C], angles [B] → f32
    [B, out_h, out_w, C]."""
    out_h, out_w = out_hw
    x = imgs.float()
    dev = x.device
    in_h, in_w = x.shape[1], x.shape[2]
    pad_y0 = (out_h - in_h) // 2
    pad_x0 = (out_w - in_w) // 2
    cy = (out_h - 1) / 2.0
    cx = (out_w - 1) / 2.0
    xs = torch.arange(out_w, dtype=torch.float32, device=dev) - cx
    ys = torch.arange(out_h, dtype=torch.float32, device=dev) - cy
    theta = torch.deg2rad(angles_deg.to(dev, torch.float32))
    ts = torch.tan(theta / 2.0)
    ss = torch.sin(theta)
    outs = []
    for i in range(x.shape[0]):
        canvas = torch.full((out_h, out_w, x.shape[3]),
                            0.0 if fill is None else fill,
                            dtype=torch.float32, device=dev)
        canvas[pad_y0:pad_y0 + in_h, pad_x0:pad_x0 + in_w] = x[i]
        t, s = -ts[i], ss[i]
        out = _row_resample(canvas, (xs[None, :] + t * ys[:, None]) + cx,
                            fill, "bilinear")
        out = _col_resample(out, (ys[None, :] + s * xs[:, None]) + cy,
                            fill, "bilinear")
        out = _row_resample(out, (xs[None, :] + t * ys[:, None]) + cx,
                            fill, "bilinear")
        outs.append(out)
    return torch.stack(outs)
