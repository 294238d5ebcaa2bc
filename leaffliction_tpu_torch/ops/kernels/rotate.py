"""Fused training augmentation K1 (dequant → 3-shear clamp rotation →
contrast): CUDA kernel and plain twin.

Port of `leaffliction_tpu/ops/pallas/rotate.py`'s
`train_aug_rotate_contrast_nhwc_pallas`, `train_aug_rotate_contrast_pallas`
and `rotate_batch_pallas_clamp_f32`, which compute one function. `train_aug`
launches `csrc/train_aug.cu` for CUDA tensors and runs `train_aug_plain` for
CPU tensors; any other device raises. Two modes, NHWC:

- uint8 in, `factors` given: value/255 → rotation → per-channel contrast
  `clip(mean + (x − mean)·factor, 0, 1)`, out in f32 or bf16;
- f32 in, `factors` None: the rotation alone, f32 out.

Rotation by θ (degrees) about ((h−1)/2, (w−1)/2) is three shears: rows by
t = −tan(θ/2), columns by s = sin θ, rows by t again. Each pass shifts by
floor(g) and lerps by g − floor(g), g = shear·(index − centre); a source
outside the image takes the edge sample of its own row or column and
channel. `rotation_controls` computes t and s once per image with their
12-bit head and tail (rotate.py `_split12`) and the edge tests cancel
exactly as `_scaled_positions` does. The kernel computes the same controls
from each angle itself, with the same operations (`rotation_controls_cuda`
runs that code alone, so a test holds the two equal on the card).

On the card a three-channel uint8 batch whose image fits in shared memory
(`leaf_train_aug_smem_bytes(h, w, c)` > 0, up to about 275²) is one kernel
launch that allocates nothing but the output; any other shape, and the f32
mode, run the multi-pass kernels through one f32 scratch buffer. The choice
is by shape only.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from leaffliction_tpu_torch.kernels import build
from leaffliction_tpu_torch.ops.photometric import true_div


def _split12(v: torch.Tensor):
    hi = torch.round(v * 4096.0) / 4096.0
    return hi, v - hi


def rotation_controls(angles_deg: torch.Tensor) -> torch.Tensor:
    """f32 [n] angles in degrees → f32 [6, n]: t, t_hi, t_lo, s, s_hi, s_lo
    (t = −tan(θ/2), s = sin θ; hi/lo their 12-bit head and tail)."""
    theta = angles_deg.float() * (math.pi / 180.0)
    t = -torch.tan(theta / 2.0)
    s = torch.sin(theta)
    return torch.stack([t, *_split12(t), s, *_split12(s)])


def _shear(src: torch.Tensor, ctrl: torch.Tensor, axis: int) -> torch.Tensor:
    """One shear pass over f32 [n, h, w, c]. axis 2: along each row, by
    `ctrl`·(y − cy); axis 1: along each column, by `ctrl`·(x − cx). `ctrl`
    is [3, n]: the shear factor, its 12-bit head and tail."""
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
    pos = (lane_f + p_hi) + p_lo                             # [n, other, size]
    high = ((lane_f - (size - 1)) + p_hi) + p_lo
    if axis == 1:  # [n, x, y] → [n, y, x]
        i0, f, pos, high = (v.transpose(1, 2) for v in (i0, f, pos, high))

    def take(i: torch.Tensor) -> torch.Tensor:
        i = i.clamp(0, size - 1)[..., None].expand(n, h, w, c)
        return torch.gather(src, axis, i)

    f = f[..., None]
    out = take(i0) * (1.0 - f) + take(i0 + 1) * f
    edge_low = src.narrow(axis, 0, 1)
    edge_high = src.narrow(axis, size - 1, 1)
    return torch.where((pos >= 0.0)[..., None],
                       torch.where((high <= 0.0)[..., None], out, edge_high),
                       edge_low)


def train_aug_plain(imgs: torch.Tensor, angles_deg: torch.Tensor,
                    factors: Optional[torch.Tensor] = None,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K1 in plain PyTorch: [n, h, w, c] uint8 (with `factors`) or f32
    (without) → `out_dtype` [n, h, w, c]."""
    ctrl = rotation_controls(angles_deg)
    x = true_div(imgs.float(), 255.0) if imgs.dtype == torch.uint8 \
        else imgs.float()
    x = _shear(x, ctrl[0:3], 2)
    x = _shear(x, ctrl[3:6], 1)
    x = _shear(x, ctrl[0:3], 2)
    if factors is not None:
        h, w = x.shape[1], x.shape[2]
        mean = true_div(x.sum(dim=(1, 2), keepdim=True), float(h * w))
        fac = factors.float()[:, None, None, None]
        x = torch.clamp(mean + (x - mean) * fac, 0.0, 1.0)
    return x.to(out_dtype)


def rotation_controls_cuda(angles_deg: torch.Tensor) -> torch.Tensor:
    """The kernels' own controls: f32 [n] angles on the card → f32 [6, n],
    as `rotation_controls` (`csrc/warp_common.cuh` `rotation_of`)."""
    angles = angles_deg.to(torch.float32).contiguous()
    ctrl = torch.empty((6, angles.numel()), dtype=torch.float32,
                       device=angles.device)
    dev = angles.get_device()
    rc = build.load().leaf_rotation_controls(
        angles.data_ptr(), ctrl.data_ptr(), angles.numel(), dev,
        build.current_stream(dev))
    build.check(rc, "leaf_rotation_controls")
    return ctrl


def train_aug(imgs: torch.Tensor, angles_deg: torch.Tensor,
              factors: Optional[torch.Tensor] = None,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K1 on [n, h, w, c]: uint8 + factors → f32/bf16, or f32 without
    factors → f32 (see the module docstring)."""
    if imgs.device.type == "cpu":
        return train_aug_plain(imgs, angles_deg, factors, out_dtype)
    if imgs.device.type != "cuda":
        raise ValueError(f"train_aug: no kernel for device {imgs.device}")
    if imgs.dim() != 4:
        raise ValueError(f"train_aug: want [n, h, w, c], got "
                         f"{tuple(imgs.shape)}")
    n, h, w, c = imgs.shape
    u8 = imgs.dtype == torch.uint8
    if u8:
        if factors is None or out_dtype not in (torch.float32,
                                                torch.bfloat16):
            raise ValueError("train_aug: uint8 input takes contrast "
                             "factors and f32 or bf16 output")
    elif imgs.dtype != torch.float32 or factors is not None \
            or out_dtype != torch.float32:
        raise ValueError(f"train_aug: {imgs.dtype} input: want f32 in, no "
                         "contrast, f32 out (or uint8 in with factors)")
    if angles_deg.shape != (n,) or (factors is not None
                                    and factors.shape != (n,)):
        raise ValueError("train_aug: angles and factors must be [n]")
    dev = imgs.device
    imgs = imgs.contiguous()
    angles = angles_deg.to(dev, torch.float32).contiguous()
    fac = (factors.to(dev, torch.float32).contiguous()
           if factors is not None else None)
    out = torch.empty(imgs.shape, dtype=out_dtype, device=dev)
    lib = build.load()
    # the multi-pass kernels' controls, channel means and two f32 canvases
    scratch = None if u8 and lib.leaf_train_aug_smem_bytes(h, w, c) \
        else torch.empty(6 * n + n * c + 2 * imgs.numel(),
                         dtype=torch.float32, device=dev)
    rc = lib.leaf_train_aug(
        imgs.data_ptr(), angles.data_ptr(),
        None if fac is None else fac.data_ptr(),
        None if scratch is None else scratch.data_ptr(), out.data_ptr(),
        int(u8), int(out_dtype == torch.bfloat16), n, h, w, c, dev.index,
        build.current_stream(dev.index))
    train_aug.launches += 1
    build.check(rc, "leaf_train_aug")
    return out


train_aug.launches = 0
build.register_launches("train_aug", vars(train_aug))
