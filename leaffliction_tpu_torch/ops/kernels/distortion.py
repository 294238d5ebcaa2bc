"""Fused distortion K6 (noise + per-channel autocontrast): CUDA kernel and
plain twin.

Port of `leaffliction_tpu/ops/pallas/distortion.py`'s
`distortion_batch_pallas`, the opt-in branch of the balancing `distortion`
op (`LEAF_PALLAS_DISTORT=1`). `distortion` launches `csrc/distortion.cu` for
CUDA tensors (one launch a call that allocates only the output: a
thread-block cluster per image, or one block per plane for images too large
for a cluster) and runs `distortion_plain` for CPU tensors; any other device
raises; `.launches` counts kernel launches.

Per (image, channel) plane, with its 32-bit seed: Irwin-Hall(12) noise (the
sum of twelve 23-bit uniforms minus 6), `x = clip(v + 5·noise, 0, 255)`,
then `photometric.autocontrast` of x with the image's cutoff, rounded half to
even to uint8. The uniforms are the top 23 bits of Philox4x32-10 words, key
(seed, 0), counter (pixel, j, 0, 0) for j = 0, 1, 2; the twin computes them
with 16-bit limbs in int64 torch ops (a 32×32-bit product does not fit in
int64), so kernel and twin produce the same bytes. The TPU kernel's bits
come from the TPU's own PRNG; neither the bits nor JAX's threefry are
reproduced, so the noise is held by its moments and the rest exactly.
"""

from __future__ import annotations

import torch

from leaffliction_tpu_torch.kernels import build
from leaffliction_tpu_torch.ops.photometric import (
    cutoff_bins,
    cutoff_count,
    remap,
)

NOISE_STD = 5.0
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of the constant a times b (int64 holding
    uint32), by 16-bit limbs so no partial product leaves int64."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> 16) + (p01 & 0xFFFF) + (p10 & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (p00 & 0xFFFF)
    hi = p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding uint32 values (broadcast) →
    the four output words."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def irwin_hall_noise(seeds: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Unit noise of each plane: seeds int64 [n, 3] in [0, 2^32) → f32
    [n, h, w, 3] (mean 0, variance 1, support ±6)."""
    n = seeds.shape[0]
    dev = seeds.device
    key = (seeds.long() & _MASK32).reshape(n * 3, 1)
    p = torch.arange(h * w, dtype=torch.int64, device=dev)[None, :]
    zero = torch.zeros_like(p)
    total = torch.zeros((n * 3, h * w), dtype=torch.int64, device=dev)
    for j in range(3):
        for word in philox4x32_10(p, zero + j, zero, zero, key,
                                  torch.zeros_like(key)):
            total = total + (word >> 9)
    noise = total.to(torch.float32) * (1.0 / 8388608.0) - 6.0
    return noise.reshape(n, 3, h, w).permute(0, 2, 3, 1)


def distortion_plain(imgs: torch.Tensor, seeds: torch.Tensor,
                     cutoffs: torch.Tensor) -> torch.Tensor:
    """K6 in plain PyTorch: uint8 [n, h, w, 3] → uint8 [n, h, w, 3]."""
    n, h, w, _ = imgs.shape
    noise = irwin_hall_noise(seeds.to(imgs.device), h, w)
    x = torch.clamp(imgs.float() + NOISE_STD * noise, 0.0, 255.0)
    lo, hi = cutoff_bins(torch.round(x),
                         cutoff_count(cutoffs, h * w, imgs.device))
    return torch.clamp(torch.round(remap(x, lo, hi)), 0.0,
                       255.0).to(torch.uint8)


def distortion(imgs: torch.Tensor, seeds: torch.Tensor,
               cutoffs: torch.Tensor) -> torch.Tensor:
    """K6 on uint8 [n, h, w, 3] with seeds [n, 3] (values in [0, 2^32);
    the kernel reads the low 32 bits of int64 seeds, so seeds drawn as
    int64 on the card go in as they are) and cutoff percentages [n]
    (module docstring)."""
    if imgs.device.type == "cpu":
        return distortion_plain(imgs, seeds, cutoffs)
    if imgs.device.type != "cuda":
        raise ValueError(f"distortion: no kernel for device {imgs.device}")
    if imgs.dtype != torch.uint8 or imgs.dim() != 4 or imgs.shape[3] != 3:
        raise ValueError(f"distortion: want uint8 [n, h, w, 3], got "
                         f"{imgs.dtype} {tuple(imgs.shape)}")
    n, h, w, _ = imgs.shape
    if seeds.shape != (n, 3) or cutoffs.shape != (n,):
        raise ValueError("distortion: seeds must be [n, 3], cutoffs [n]")
    imgs = imgs.contiguous()
    # no-ops (no launch) for int64 seeds and f32 cutoffs on the image's card
    seeds = seeds.to(imgs.device, torch.int64).contiguous()
    cut = cutoffs.to(imgs.device, torch.float32).contiguous()
    out = torch.empty_like(imgs)
    dev = imgs.get_device()
    rc = build.load().leaf_distortion(imgs.data_ptr(), seeds.data_ptr(),
                                      cut.data_ptr(), out.data_ptr(), n, h, w,
                                      dev, build.current_stream(dev))
    distortion.launches += 1
    build.check(rc, "leaf_distortion")
    return out


distortion.launches = 0
build.register_launches("distortion", vars(distortion))
