"""The Python side of the train step's hand kernels' layout, and flax SAME
padding.

The BatchNorm (`csrc/batch_norm.cu`) and exit (`csrc/block_exit.cu`)
kernels read channels-last activations (`[n·hw, c]` row-major, what the
models' convolutions hand over), bf16 or f32; their C side shares
`csrc/channels_last.cuh`. `channels_last` hands a kernel a channels-first
contiguous tensor as a copy, and any gradient whose strides are not
channels-last; `channels_first` copies a result back. Each copy is counted
in the calling op's own `copy` counter. 16-byte accesses need c % 8 == 0
and 16-byte aligned tensors (`vector_width`). Plain torch: importing this
(and so the models) loads no kernel module.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def is_channels_last(t: torch.Tensor) -> bool:
    return t.movedim(1, -1).is_contiguous()


def channels_last(t: torch.Tensor, counter: Dict[str, int], op: str,
                  gradient: bool = False) -> torch.Tensor:
    """t [N, C, ...] as `op`'s kernels read it: itself when channels-last,
    else a channels-last copy. An input must be channels-last or
    channels-first contiguous, or this raises; a `gradient` may come in any
    layout."""
    if t.dim() < 2:
        raise ValueError(f"{op}: want [N, C, ...], got {tuple(t.shape)}")
    if t.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{op}: no kernel for {t.dtype}")
    if is_channels_last(t):
        return t
    if not (gradient or t.is_contiguous()):
        raise ValueError(f"{op}: a tensor of strides {t.stride()} is "
                         "neither channels-last nor channels-first contiguous")
    counter["copy"] += 1
    return t.movedim(1, -1).contiguous().movedim(-1, 1)


def channels_first(t: torch.Tensor, counter: Dict[str, int]) -> torch.Tensor:
    """A kernel's result for an input that `channels_last` copied, as a
    contiguous copy."""
    counter["copy"] += 1
    return t.contiguous()


def vector_width(c: int, *tensors: Optional[torch.Tensor]) -> int:
    """8 where 16-byte accesses apply to c and every tensor given (None
    skipped), else 1."""
    return 8 if c % 8 == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors if t is not None) else 1


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax/XLA "SAME" padding of one spatial dim: total = max((⌈size/s⌉ −
    1)·s + k − size, 0), ⌊total/2⌋ low and the rest high (torch's symmetric
    `padding=` differs at stride 2 and for even kernels)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, k: int, stride: int,
             value: float = 0.0) -> Tuple[torch.Tensor, int]:
    """(x, p) such that an op with `padding=p` on x is the SAME-padded op:
    symmetric pads stay the op's own; otherwise x is padded explicitly
    with `value` (a copy) and p is 0."""
    ph, pw = (same_pads(n, k, stride) for n in x.shape[-2:])
    if ph[0] == ph[1] == pw[0] == pw[1]:
        return x, ph[0]
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), 0
