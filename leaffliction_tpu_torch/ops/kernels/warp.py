"""Balancing warps K2 (expand-canvas rotation) and K3 (cubic shear): CUDA
kernels and plain twins.

`rotate_expand` ports `leaffliction_tpu/ops/pallas/rotate.py`'s
`rotate_batch_pallas_nhwc` and `rotate_batch_pallas` (one function, two
layouts) and launches `csrc/rotate_expand.cu`; `shear_cubic` ports
`shear_batch_pallas` and launches `csrc/shear_cubic.cu`. Each takes CPU
tensors to its plain twin (`*_plain`) and raises on any device that is
neither CPU nor CUDA; each counts its kernel launches in `.launches`.

K2: uint8 [n, h, w, 3] and angles (degrees) → uint8 [n, OH, OW, 3]. The
input sits at ((OH − h)//2, (OW − w)//2) of a white canvas, rotated by three
shears about the canvas centre (rows by t = −tan(θ/2), columns by s = sin θ,
rows by t), each a floor shift plus a 2-tap lerp; a source outside the
canvas gives 255 in every pass. Then round half to even, clip, uint8.

K3: uint8 [n, h, w, 3], shears s and directions → uint8 [n, h, w, 3]. The
origin-anchored PIL shear with 4-tap Keys cubic weights, out-of-image taps
dropped and the rest renormalised, black outside the source band, which is
closed at size − 0.5 as in the Pallas kernel (see `csrc/shear_cubic.cu`).

The sign-exact bound tests use the shear factors' 12-bit head and tail
(`rotate.rotation_controls`, `shear_controls`, `_split12`): each kernel
computes them itself, from the angle (K2) or the shear (K3), with the twin's
operations, so kernel and twin take the same branch at every edge
(`shear_controls_cuda` runs K3's code alone for a test); the library is
built with `-fmad=false`, and the twins repeat the kernels' operations in
their order.

On the card K2 is one kernel launch that allocates only its output when the
uint8 image fits in shared memory (`leaf_rotate_expand_smem_bytes(h, w, OH,
OW)` > 0: 224² and 272², not 291²); other shapes run the multi-pass kernels
through one f32 scratch buffer. The choice is by shape only.

K3 is one launch that allocates only its output: each image is cut into
bands of whole lines along its active pass, a block a band, the lines in
shared memory (`leaf_shear_cubic_blocks_per_image(n, h, w)` bands, sized at
launch to fill the card). A line too long for shared memory
(`leaf_shear_cubic_smem_bytes(h, w)` = 0) takes a simple kernel instead.
"""

from __future__ import annotations

from typing import Tuple

import torch

from leaffliction_tpu_torch.kernels import build
from leaffliction_tpu_torch.ops.kernels.rotate import (
    _split12,
    rotation_controls,
)

WHITE = 255.0


def _shear_white(src: torch.Tensor, ctrl: torch.Tensor,
                 axis: int) -> torch.Tensor:
    """One white-fill shear pass over f32 [n, h, w, c] about the centre.
    axis 2: along each row by `ctrl`·(y − cy); axis 1: along each column by
    `ctrl`·(x − cx). `ctrl` is [3, n]: the factor, its head and tail."""
    n, h, w, c = src.shape
    size, other = (w, h) if axis == 2 else (h, w)
    sh, hi, lo = (v[:, None] for v in ctrl)                  # [n, 1]
    off = (torch.arange(other, device=src.device, dtype=torch.float32)
           - (other - 1) / 2.0)                              # [other]
    g = sh * off                                             # [n, other]
    k = torch.floor(g)
    f = (g - k)[..., None]                                   # [n, other, 1]
    lane = torch.arange(size, device=src.device)
    i0 = lane + k.clamp(-(size + 1), size + 1).long()[..., None]
    lane_f = lane.to(torch.float32)
    p_hi = (hi * off)[..., None]
    p_lo = (lo * off)[..., None]
    valid = (((lane_f + p_hi) + p_lo >= 0.0)
             & (((lane_f - (size - 1)) + p_hi) + p_lo <= 0.0))
    if axis == 1:  # [n, x, y] → [n, y, x]
        i0, f, valid = (v.transpose(1, 2) for v in (i0, f, valid))

    def take(i: torch.Tensor) -> torch.Tensor:
        i = i.clamp(0, size - 1)[..., None].expand(n, h, w, c)
        return torch.gather(src, axis, i)

    f = f[..., None]
    out = take(i0) * (1.0 - f) + take(i0 + 1) * f
    return torch.where(valid[..., None], out, WHITE)


def rotate_expand_plain(imgs: torch.Tensor, angles_deg: torch.Tensor,
                        canvas_hw: Tuple[int, int]) -> torch.Tensor:
    """K2 in plain PyTorch: uint8 [n, h, w, 3] → uint8 [n, OH, OW, 3]."""
    n, h, w, c = imgs.shape
    oh, ow = canvas_hw
    ctrl = rotation_controls(angles_deg.to(imgs.device))
    y0, x0 = (oh - h) // 2, (ow - w) // 2
    x = torch.full((n, oh, ow, c), WHITE, dtype=torch.float32,
                   device=imgs.device)
    x[:, y0:y0 + h, x0:x0 + w] = imgs.float()
    x = _shear_white(x, ctrl[0:3], 2)
    x = _shear_white(x, ctrl[3:6], 1)
    x = _shear_white(x, ctrl[0:3], 2)
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def _check_u8_nhwc3(name: str, imgs: torch.Tensor) -> None:
    if imgs.dtype != torch.uint8 or imgs.dim() != 4 or imgs.shape[3] != 3:
        raise ValueError(f"{name}: want uint8 [n, h, w, 3], got "
                         f"{imgs.dtype} {tuple(imgs.shape)}")


def rotate_expand(imgs: torch.Tensor, angles_deg: torch.Tensor,
                  canvas_hw: Tuple[int, int]) -> torch.Tensor:
    """K2 on uint8 [n, h, w, 3] → uint8 [n, OH, OW, 3] (module docstring)."""
    if imgs.device.type == "cpu":
        return rotate_expand_plain(imgs, angles_deg, canvas_hw)
    if imgs.device.type != "cuda":
        raise ValueError(f"rotate_expand: no kernel for device {imgs.device}")
    _check_u8_nhwc3("rotate_expand", imgs)
    n, h, w, _ = imgs.shape
    oh, ow = canvas_hw
    if oh < h or ow < w:
        raise ValueError(f"rotate_expand: canvas {canvas_hw} smaller than "
                         f"the input {(h, w)}")
    if angles_deg.shape != (n,):
        raise ValueError("rotate_expand: angles must be [n]")
    dev = imgs.device
    imgs = imgs.contiguous()
    angles = angles_deg.to(dev, torch.float32).contiguous()
    out = torch.empty((n, oh, ow, 3), dtype=torch.uint8, device=dev)
    lib = build.load()
    # the multi-pass kernels' controls and two f32 canvases
    scratch = None if lib.leaf_rotate_expand_smem_bytes(h, w, oh, ow) \
        else torch.empty(6 * n + 2 * out.numel(), dtype=torch.float32,
                         device=dev)
    rc = lib.leaf_rotate_expand(
        imgs.data_ptr(), angles.data_ptr(),
        None if scratch is None else scratch.data_ptr(), out.data_ptr(),
        n, h, w, oh, ow, dev.index, build.current_stream(dev.index))
    rotate_expand.launches += 1
    build.check(rc, "leaf_rotate_expand")
    return out


rotate_expand.launches = 0
build.register_launches("rotate_expand", vars(rotate_expand))


def shear_controls(shears: torch.Tensor) -> torch.Tensor:
    """f32 [n] shear factors → f32 [3, n]: s, s_hi, s_lo."""
    s = shears.float()
    return torch.stack([s, *_split12(s)])


def _keys(d: torch.Tensor) -> torch.Tensor:
    """Keys cubic weight (a = −0.5) for |d| <= 2, as `csrc/warp_common.cuh`."""
    ad = d.abs()
    ad2 = ad * ad
    ad3 = ad2 * ad
    return torch.where(ad <= 1.0, 1.5 * ad3 - 2.5 * ad2 + 1.0,
                       -0.5 * (ad3 - 5.0 * ad2 + 8.0 * ad - 4.0))


def _cubic_pass(src: torch.Tensor, ctrl: torch.Tensor,
                axis: int) -> torch.Tensor:
    """The cubic shear along `axis` (2: rows, shift by s·(y + 0.5); 1:
    columns, shift by s·(x + 0.5)) of f32 [n, h, w, c], fill 0."""
    n, h, w, c = src.shape
    size, other = (w, h) if axis == 2 else (h, w)
    sh, hi, lo = (v[:, None] for v in ctrl)                  # [n, 1]
    coord = torch.arange(other, device=src.device,
                         dtype=torch.float32) + 0.5          # [other]
    g = sh * coord                                           # [n, other]
    k = torch.floor(g)
    f = g - k
    lane = torch.arange(size, device=src.device)
    t0 = (lane + k.clamp(-(size + 4), size + 4).long()[..., None]
          - 1)                                               # [n, other, size]
    pos = lane.to(torch.float32) + 0.5
    p_hi = (hi * coord)[..., None]
    p_lo = (lo * coord)[..., None]
    valid = (((pos + p_hi) + p_lo >= 0.0)
             & (((pos - float(size)) + p_hi) + p_lo <= 0.0))
    weights = [_keys(1.0 + f), _keys(f), _keys(1.0 - f), _keys(2.0 - f)]
    num = den = None
    for i, wt in enumerate(weights):
        t = t0 + i
        ok = ((t >= 0) & (t <= size - 1)).to(torch.float32)
        wok = wt[..., None] * ok                             # [n, other, size]
        tc = t.clamp(0, size - 1)
        if axis == 1:
            wok, tc = wok.transpose(1, 2), tc.transpose(1, 2)
        v = torch.gather(src, axis, tc[..., None].expand(n, h, w, c))
        term = v * wok[..., None]
        num = term if num is None else num + term
        den = wok if den is None else den + wok
    den = torch.where(den.abs() > 1e-6, den, 1.0)[..., None]
    if axis == 1:
        valid = valid.transpose(1, 2)
    return torch.where(valid[..., None], num / den, 0.0)


def shear_cubic_plain(imgs: torch.Tensor, shears: torch.Tensor,
                      horizontal: torch.Tensor) -> torch.Tensor:
    """K3 in plain PyTorch: uint8 [n, h, w, 3] → uint8 [n, h, w, 3]."""
    ctrl = shear_controls(shears.to(imgs.device))
    x = imgs.float()
    horiz = horizontal.to(imgs.device, torch.bool)[:, None, None, None]
    out = torch.where(horiz, _cubic_pass(x, ctrl, 2), _cubic_pass(x, ctrl, 1))
    return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)


def shear_controls_cuda(shears: torch.Tensor) -> torch.Tensor:
    """K3's own controls: f32 [n] shears on the card → f32 [3, n], as
    `shear_controls` (`csrc/shear_cubic.cu` `shear_of`)."""
    s = shears.to(torch.float32).contiguous()
    ctrl = torch.empty((3, s.numel()), dtype=torch.float32, device=s.device)
    dev = s.get_device()
    rc = build.load().leaf_shear_controls(s.data_ptr(), ctrl.data_ptr(),
                                          s.numel(), dev,
                                          build.current_stream(dev))
    build.check(rc, "leaf_shear_controls")
    return ctrl


def shear_cubic(imgs: torch.Tensor, shears: torch.Tensor,
                horizontal: torch.Tensor) -> torch.Tensor:
    """K3 on uint8 [n, h, w, 3] (module docstring)."""
    if not imgs.is_cuda:
        if imgs.device.type == "cpu":
            return shear_cubic_plain(imgs, shears, horizontal)
        raise ValueError(f"shear_cubic: no kernel for device {imgs.device}")
    _check_u8_nhwc3("shear_cubic", imgs)
    n, h, w, _ = imgs.shape
    if shears.shape != (n,) or horizontal.shape != (n,):
        raise ValueError("shear_cubic: shears and horizontal must be [n]")
    dev = imgs.device
    imgs = imgs.contiguous()
    s = shears.to(dev, torch.float32).contiguous()
    # one byte an image, non-zero for rows: a bool or uint8 tensor as it is
    horiz = horizontal.to(dev) if horizontal.dtype in (torch.bool,
                                                         torch.uint8) \
        else horizontal.to(dev, torch.bool)
    horiz = horiz.contiguous()
    out = torch.empty_like(imgs)
    rc = build.load().leaf_shear_cubic(imgs.data_ptr(), s.data_ptr(),
                                       horiz.data_ptr(), out.data_ptr(), n, h,
                                       w, dev.index,
                                       build.current_stream(dev.index))
    shear_cubic.launches += 1
    build.check(rc, "leaf_shear_cubic")
    return out


shear_cubic.launches = 0
build.register_launches("shear_cubic", vars(shear_cubic))
