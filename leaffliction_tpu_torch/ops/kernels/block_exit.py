"""The residual blocks' exit on the card: the wrappers of `csrc/block_exit.cu`.

The plain twin, the autograd function and the dispatch are
`ops/block_exit.py`, which calls these for CUDA tensors (no Pallas kernel
is replaced: the JAX package leaves this chain to XLA's fusion). The exit
`pool(drop(relu(shortcut + y * se)))` is two kernels and a finalisation:

- `forward`: `exit_forward`, one read of y and the shortcut, one write of
  the output and, where a backward will follow, of a one-byte code a
  pooled element (its pick's offset in the window);
- `backward`: `exit_backward` (dy and d_shortcut, the ReLU's sign rebuilt
  from y, the shortcut and se; each block's Σ d_shortcut·y per image and
  channel), then `exit_finalize` (the blocks' partials summed in a fixed
  order → the SE gate's gradient).

Each launches on PyTorch's current stream, allocates outputs, codes and
partials with `torch.empty` and never synchronises, so CUDA graphs capture
them; the partials' count for a shape is asked of the library once and
cached. The kernels take y and the shortcut channels-last (what the models'
convolutions and BatchNorm kernels hand over), bf16 or f32, se [N, C, 1, 1]
in y's type and the dropout's mask bool [N, C, 1, 1], and raise on
anything else; `ops/layout.py` holds the layout contract (the copies into
and out of channels-last, the 16-byte vector width, SAME padding).
`launches` counts each kernel's launches and, under `copy`, the tensors
`ops/block_exit.py` copied into or out of channels-last; it is registered
with `kernels/build.py` as `block_exit.<key>`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from leaffliction_tpu_torch.kernels import build
from leaffliction_tpu_torch.ops import layout

launches: Dict[str, int] = dict.fromkeys(
    ("forward", "backward", "finalize", "copy"), 0)
for _key in launches:
    build.register_launches(f"block_exit.{_key}", launches, _key)


class Geometry(NamedTuple):
    """An exit's input [n, c, h, w], its output's oh × ow, and the pool:
    k × k windows at stride s reaching pad_h, pad_w past the top and left
    edges (k = s = 1 and no padding without a pool)."""
    n: int
    c: int
    h: int
    w: int
    oh: int
    ow: int
    k: int
    s: int
    pad_h: int
    pad_w: int


def _check(t: torch.Tensor) -> None:
    if t.dim() != 4:
        raise ValueError(f"block_exit: want [N, C, H, W], got {tuple(t.shape)}")
    if t.dtype not in layout.KERNEL_DTYPES:
        raise ValueError(f"block_exit: no kernel for {t.dtype}")


def geometry(x: torch.Tensor, pool) -> Geometry:
    """The geometry of an exit on x [N, C, H, W] with `pool` (an
    `ops.block_exit.Pool`, or None). Raises on a pool the kernels do not
    take or whose output would be empty."""
    n, c, h, w = x.shape
    if pool is None:
        return Geometry(n, c, h, w, h, w, 1, 1, 0, 0)
    k, s = pool.k, pool.s
    if not (1 <= k <= 16 and s >= 1):
        raise ValueError(f"block_exit: no kernel for a {k}x{k}/{s} pool")
    (top, bottom), (left, right) = (
        layout.same_pads(h, k, s), layout.same_pads(w, k, s)) if pool.same \
        else ((0, 0), (0, 0))
    oh, ow = (h + top + bottom - k) // s + 1, (w + left + right - k) // s + 1
    if oh <= 0 or ow <= 0:
        raise ValueError(f"block_exit: a {k}x{k}/{s} pool of {h}x{w} is "
                         "empty")
    return Geometry(n, c, h, w, oh, ow, k, s, top, left)


def _per_image(t: Optional[torch.Tensor], g: Geometry, dtype: torch.dtype
               ) -> Optional[torch.Tensor]:
    """se or the dropout's mask, [N, C, 1, 1], as the kernels read it:
    [N, C] contiguous (uint8 for the mask)."""
    if t is None:
        return None
    if t.shape != (g.n, g.c, 1, 1) or t.dtype != dtype:
        raise ValueError(f"block_exit: want a {dtype} [{g.n}, {g.c}, 1, 1] "
                         f"per-image scale or mask, got {t.dtype} "
                         f"{tuple(t.shape)}")
    t = t.reshape(g.n, g.c).contiguous()
    return t.view(torch.uint8) if dtype == torch.bool else t


def _inv(drop) -> float:
    """1 / keep, computed in double and rounded to f32: PyTorch's CUDA
    `x / keep` multiplies by it (an f32 `1 / f32(keep)` differs from it in
    the last bit at keep = 0.85, and moves a third of f32 outputs)."""
    return 0.0 if drop is None else float(np.float32(1.0 / drop.keep))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def forward(y: torch.Tensor, se: Optional[torch.Tensor],
            shortcut: Optional[torch.Tensor], relu: bool, drop, pool,
            with_code: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out, code): the exit of channels-last y [N, C, H, W] in y's dtype
    and layout, and with `with_code` and a pool the uint8 picks [N, C, oh,
    ow] the backward reads (else None). `drop` is an `ops.block_exit.Drop`
    or None."""
    _check(y)
    g = geometry(y, pool)
    for t in (y, shortcut):
        if t is not None and not layout.is_channels_last(t):
            raise ValueError(f"block_exit: a tensor of strides {t.stride()} "
                             "is not channels-last")
    if shortcut is not None and (shortcut.shape != y.shape
                                 or shortcut.dtype != y.dtype):
        raise ValueError("block_exit: the shortcut must have y's shape and "
                         "dtype")
    if y.numel() >= 2 ** 31:
        raise ValueError(f"block_exit: {tuple(y.shape)} holds 2^31 "
                         "elements or more (the kernels index in 32 bits)")
    scale = _per_image(se, g, y.dtype)
    keep = _per_image(None if drop is None else drop.mask, g, torch.bool)
    out = torch.empty((g.n, g.c, g.oh, g.ow), dtype=y.dtype, device=y.device,
                      memory_format=torch.channels_last)
    code = torch.empty((g.n, g.c, g.oh, g.ow), dtype=torch.uint8,
                       device=y.device, memory_format=torch.channels_last) \
        if with_code and pool is not None else None
    dev = y.device.index
    rc = build.load().leaf_exit_forward(
        y.data_ptr(), _ptr(shortcut), _ptr(scale), _ptr(keep),
        out.data_ptr(), _ptr(code), _inv(drop), g.n, g.h, g.w, g.c, g.oh,
        g.ow, g.k, g.s, g.pad_h, g.pad_w, int(relu),
        layout.vector_width(g.c, y, shortcut, out),
        int(y.dtype == torch.bfloat16), dev, build.current_stream(dev))
    launches["forward"] += 1
    build.check(rc, "leaf_exit_forward")
    return out, code


def _partials(g: Geometry, vec: int, device: torch.device) -> torch.Tensor:
    blocks = build.blocks("leaf_exit_blocks", g.n, g.h, g.w, g.c, vec,
                          device.index)
    return torch.empty((g.n, blocks, g.c), dtype=torch.float32,
                       device=device)


def backward(grad: torch.Tensor, code: Optional[torch.Tensor], g: Geometry,
             y: Optional[torch.Tensor], se: Optional[torch.Tensor],
             shortcut: Optional[torch.Tensor], with_shortcut: bool,
             relu: bool, drop
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                        Optional[torch.Tensor]]:
    """(dy, d_shortcut, d_se) of the exit from the output's channels-last
    gradient `grad` and the forward's `code` (None without a pool): dy and,
    `with_shortcut`, d_shortcut [N, C, H, W] channels-last, and with se its
    gradient [N, C] in se's dtype (else None). y is read where relu or se
    needs it, and `shortcut` where relu does (None otherwise)."""
    dtype = grad.dtype
    if not layout.is_channels_last(grad):
        raise ValueError(f"block_exit: a gradient of strides {grad.stride()} "
                         "is not channels-last")
    scale = _per_image(se, g, dtype)
    keep = _per_image(None if drop is None else drop.mask, g, torch.bool)
    full = (g.n, g.c, g.h, g.w)
    dy = torch.empty(full, dtype=dtype, device=grad.device,
                     memory_format=torch.channels_last)
    dsc = torch.empty_like(dy) if with_shortcut else None
    vec = layout.vector_width(g.c, grad, y, shortcut, dy, dsc)
    lib = build.load()
    partials = None if se is None else _partials(g, vec, grad.device)
    dev = grad.device.index
    bf16 = int(dtype == torch.bfloat16)
    rc = lib.leaf_exit_backward(
        grad.data_ptr(), _ptr(code), _ptr(y), _ptr(shortcut), _ptr(scale),
        _ptr(keep), dy.data_ptr(), _ptr(dsc), _ptr(partials), _inv(drop),
        g.n, g.h, g.w, g.c, g.oh, g.ow, g.k, g.s, g.pad_h, g.pad_w,
        int(relu), vec, bf16, 1 if partials is None else partials.shape[1],
        dev, build.current_stream(dev))
    launches["backward"] += 1
    build.check(rc, "leaf_exit_backward")
    if partials is None:
        return dy, dsc, None
    dse = torch.empty((g.n, g.c), dtype=se.dtype, device=grad.device)
    rc = lib.leaf_exit_finalize(partials.data_ptr(), dse.data_ptr(), g.n,
                                partials.shape[1], g.c, bf16, dev,
                                build.current_stream(dev))
    launches["finalize"] += 1
    build.check(rc, "leaf_exit_finalize")
    return dy, dsc, dse
