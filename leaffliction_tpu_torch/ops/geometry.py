"""Geometric warps: an inverse-mapping bilinear sampler and its 3×3 matrix
builders.

Port of `leaffliction_tpu/ops/geometry.py`. `homography_warp` maps each
output pixel (x, y) through a 3×3 output → input matrix, as PIL applies its
inverse coefficients, and samples the input bilinearly: with `fill=None`
the borders reflect (cv2 `BORDER_REFLECT_101`), else a sample outside
[0, w − 1] × [0, h − 1] is `fill`. It takes one image [H, W, C] or a batch
[N, H, W, C] (NHWC) with one matrix [3, 3] or one per image [N, 3, 3], on
the image's device, and returns float32 in the input's value range. The
JAX package computes this outside any Pallas kernel, so it is plain torch
here too. The builders return float32 [3, 3] tensors on the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

F32 = torch.float32


def _reflect_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Reflect out-of-range indices into [0, size) (cv2
    BORDER_REFLECT_101)."""
    if size == 1:
        return torch.zeros_like(idx)
    period = 2 * (size - 1)
    idx = torch.remainder(idx, period)
    return torch.where(idx >= size, period - idx, idx)


def _gather_bilinear(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                     fill: Optional[float]) -> torch.Tensor:
    """Sample img [N, H, W, C] at float coordinates (xs, ys) [N, oh, ow]
    bilinearly; fill=None reflects the borders, else out-of-bounds samples
    are `fill`."""
    n, h, w, c = img.shape
    x0, y0 = torch.floor(xs), torch.floor(ys)
    wx, wy = (xs - x0)[..., None], (ys - y0)[..., None]
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    flat = img.reshape(n, h * w, c)

    def sample(yi, xi):
        if fill is None:
            yc, xc = _reflect_index(yi, h), _reflect_index(xi, w)
        else:
            yc, xc = yi.clamp(0, h - 1), xi.clamp(0, w - 1)
        idx = (yc * w + xc).reshape(n, -1, 1).expand(-1, -1, c)
        return flat.gather(1, idx).reshape(*xs.shape, c)

    v00, v01 = sample(y0i, x0i), sample(y0i, x0i + 1)
    v10, v11 = sample(y0i + 1, x0i), sample(y0i + 1, x0i + 1)
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    out = top * (1.0 - wy) + bot * wy
    if fill is not None:
        inside = ((xs >= 0.0) & (xs <= w - 1.0) & (ys >= 0.0)
                  & (ys <= h - 1.0))[..., None]
        out = torch.where(inside, out, torch.tensor(fill, dtype=out.dtype,
                                                    device=out.device))
    return out


def homography_warp(img: torch.Tensor, matrix, out_hw: Tuple[int, int],
                    fill: Optional[float] = None) -> torch.Tensor:
    """Warp with a 3×3 output → input homography: for each output pixel
    (x, y), [xs, ys, s] = matrix @ [x, y, 1] and the source sample is
    (xs/s, ys/s); an affine matrix has s == 1. `img` [H, W, C] or
    [N, H, W, C]; `matrix` [3, 3] or [N, 3, 3]."""
    single = img.dim() == 3
    x = (img[None] if single else img).to(F32)
    n = x.shape[0]
    m = torch.as_tensor(matrix, dtype=F32).to(x.device)
    m = m.expand(n, 3, 3) if m.dim() == 2 else m
    out_h, out_w = out_hw
    ys = torch.arange(out_h, dtype=F32, device=x.device)[:, None].expand(
        out_h, out_w)
    xs = torch.arange(out_w, dtype=F32, device=x.device)[None, :].expand(
        out_h, out_w)

    def row(i, fused):
        a, b, c = (m[:, i, j, None, None] for j in range(3))
        if not fused:
            return a * xs + b * ys + c
        # a·x + (b·y) rounded once (a product of two float32 values is
        # exact in float64), then + c: XLA compiles the JAX warp's sample
        # coordinates so, and a coordinate an ulp off moves a sample of a
        # sharp edge by up to 2e-3 on [0, 255]
        return (a.double() * xs.double() + (b * ys).double()).float() + c

    sx, sy, ss = row(0, True), row(1, True), row(2, False)
    inv = 1.0 / torch.where(ss.abs() < 1e-8, 1e-8, ss)
    out = _gather_bilinear(x, sx * inv, sy * inv, fill)
    return out[0] if single else out


def warp_image(img: torch.Tensor, matrix, out_hw: Tuple[int, int],
               fill: Optional[float] = None) -> torch.Tensor:
    """`homography_warp` under the name the affine callers use."""
    return homography_warp(img, matrix, out_hw, fill)


# --- matrix builders (3x3, output→input mapping) -------------------------


def affine_matrix(a: float, b: float, c: float, d: float, e: float,
                  f: float) -> torch.Tensor:
    """PIL-style 6-coefficient affine (x_src = a x + b y + c, y_src =
    d x + e y + f)."""
    return torch.tensor([[a, b, c], [d, e, f], [0.0, 0.0, 1.0]], dtype=F32)


def rotation_matrix(angle_deg, in_hw: Tuple[int, int],
                    out_hw: Optional[Tuple[int, int]] = None
                    ) -> torch.Tensor:
    """Rotate counter-clockwise by `angle_deg` (PIL's convention) about the
    image centre. An `out_hw` larger than `in_hw` is PIL's
    `rotate(expand=True)` on that canvas."""
    h, w = in_hw
    oh, ow = out_hw if out_hw is not None else in_hw
    theta = torch.deg2rad(torch.as_tensor(angle_deg, dtype=F32))
    cos, sin = torch.cos(theta), torch.sin(theta)
    cx_out, cy_out = (ow - 1) / 2.0, (oh - 1) / 2.0
    cx_in, cy_in = (w - 1) / 2.0, (h - 1) / 2.0
    a, b, d, e = cos, -sin, sin, cos
    c = cx_in - a * cx_out - b * cy_out
    f = cy_in - d * cx_out - e * cy_out
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([torch.stack([a, b, c]), torch.stack([d, e, f]),
                        torch.stack([zero, zero, one])])


def shear_matrix(shear, horizontal: bool, in_hw: Tuple[int, int]
                 ) -> torch.Tensor:
    """Centre-anchored shear: x_src = x + s·(y − cy) (horizontal) or
    y_src = y + s·(x − cx)."""
    h, w = in_hw
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    s = torch.as_tensor(shear, dtype=F32)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    if horizontal:
        row0, row1 = torch.stack([one, s, -s * cy]), torch.stack([zero, one,
                                                                  zero])
    else:
        row0, row1 = torch.stack([one, zero, zero]), torch.stack([s, one,
                                                                  -s * cx])
    return torch.stack([row0, row1, torch.stack([zero, zero, one])])


def perspective_matrix_from_coeffs(coeffs) -> torch.Tensor:
    """PIL's 8 PERSPECTIVE coefficients → the 3×3 output → input
    homography."""
    c = torch.as_tensor(coeffs, dtype=F32).reshape(8)
    return torch.cat([c, torch.ones(1, dtype=F32)]).reshape(3, 3)


def solve_perspective_coeffs(dst_quad: Sequence, src_quad: Sequence
                             ) -> torch.Tensor:
    """The homography mapping the 4 `dst_quad` corners onto `src_quad`'s:
    the linear system of PIL's `ImageTransform` documentation (and the
    reference's `image_augmenter.py:44-71`), two equations a corner pair,
    solved in float32."""
    dst = torch.as_tensor(dst_quad, dtype=F32)
    src = torch.as_tensor(src_quad, dtype=F32)
    zero, one = torch.zeros(()), torch.ones(())
    rows = []
    for i in range(4):
        X, Y = dst[i, 0], dst[i, 1]
        x, y = src[i, 0], src[i, 1]
        rows.append(torch.stack([X, Y, one, zero, zero, zero, -X * x,
                                 -Y * x]))
        rows.append(torch.stack([zero, zero, zero, X, Y, one, -X * y,
                                 -Y * y]))
    coeffs = torch.linalg.solve(torch.stack(rows), src.T.reshape(-1))
    return torch.cat([coeffs, torch.ones(1, dtype=F32)]).reshape(3, 3)
