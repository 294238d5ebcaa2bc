"""Canny front end (Gaussian 5x5 → Sobel → magnitude → NMS): kernel and twin.

Port of `leaffliction_tpu/ops/pallas/edge.py::edge_nms_batch`, with the
border semantics of `leaffliction_tpu/ops/filters.py::_edge_nms_jnp` (cv2's):
reflect-101 for the blur and the Sobel taps, wrap-around NMS neighbours.
`edge_nms` launches `csrc/edge_nms.cu` for CUDA tensors and runs
`edge_nms_plain` for CPU tensors; any other device raises. The kernel repeats
the twin's operations in the same order without fused multiply-adds, so the
two agree bit for bit. On the card a call is one kernel launch that
allocates only its output: a block per 16×32 output tile, every
intermediate in shared memory, the Gaussian taps compiled in
(`leaf_edge_taps` returns them, equal to `G5`).
"""

from __future__ import annotations

import torch

from leaffliction_tpu_torch.kernels import build
from leaffliction_tpu_torch.ops.filters import (
    SOBEL_D,
    SOBEL_S,
    gaussian_kernel_1d,
    sep_conv2d,
)

G5 = gaussian_kernel_1d(5, 1.4)
T1 = 0.41421356  # tan(22.5°)
T2 = 2.41421356  # tan(67.5°)


def edge_nms_plain(gray: torch.Tensor, l2: bool = False) -> torch.Tensor:
    """f32 [..., h, w] → NMS gradient magnitude, same shape."""
    blur = sep_conv2d(gray.float(), G5, G5)
    gx = sep_conv2d(blur, SOBEL_D, SOBEL_S)
    gy = sep_conv2d(blur, SOBEL_S, SOBEL_D)
    ax, ay = gx.abs(), gy.abs()
    mag = torch.sqrt(gx * gx + gy * gy) if l2 else ax + ay

    def nb(dy, dx):  # out[y, x] = mag[y - dy, x - dx], wrapping
        return torch.roll(mag, (dy, dx), dims=(-2, -1))

    s0 = ay <= T1 * ax
    s2 = ay > T2 * ax
    s1 = (gx * gy) >= 0
    na = torch.where(s0, nb(0, 1), torch.where(
        s2, nb(1, 0), torch.where(s1, nb(-1, 1), nb(1, 1))))
    nbb = torch.where(s0, nb(0, -1), torch.where(
        s2, nb(-1, 0), torch.where(s1, nb(1, -1), nb(-1, -1))))
    return torch.where((mag >= na) & (mag >= nbb), mag, 0.0)


def edge_nms(gray: torch.Tensor, l2: bool = False) -> torch.Tensor:
    """Batched front end: f32 [n, h, w] → f32 [n, h, w]."""
    if not gray.is_cuda:
        if gray.device.type == "cpu":
            return edge_nms_plain(gray, l2)
        raise ValueError(f"edge_nms: no kernel for device {gray.device}")
    if gray.dim() != 3 or gray.dtype != torch.float32:
        raise ValueError("edge_nms: want f32 [n, h, w], got "
                         f"{gray.dtype} {tuple(gray.shape)}")
    n, h, w = gray.shape
    if h < 3 or w < 3:
        raise ValueError(f"edge_nms: reflect-101 borders need h, w >= 3, "
                         f"got {h}x{w}")
    gray = gray.contiguous()
    out = torch.empty_like(gray)
    dev = gray.get_device()
    rc = build.load().leaf_edge_nms(gray.data_ptr(), out.data_ptr(), n, h, w,
                                    int(bool(l2)), dev,
                                    build.current_stream(dev))
    edge_nms.launches += 1
    build.check(rc, "leaf_edge_nms")
    return out


edge_nms.launches = 0
build.register_launches("edge_nms", vars(edge_nms))
