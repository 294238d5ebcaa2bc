"""Input statistics for the model's adaptive normalisation, and the resize
of `jax.image.resize`.

`compute_norm_stats` ports `leaffliction_tpu/ops/image.py::compute_norm_stats`
(the reference's Keras `Normalization.adapt`): per-channel mean and *biased*
variance over an N×H×W×C sample, uint8 read as value/255. `resize` has the
semantics of the `jax.image.resize` calls of the JAX segmentation stack
(`segment/mask.py`, `segment/grabcut.py`, `cli/transform.py`): `linear`,
`cubic` and `nearest`, antialiased when downscaling unless asked not to.
`to_float`, `normalize_to_unit`, `resize_bilinear` and `standardize` port
the JAX module's batch helpers (uint8 read as value/255; the Keras
`Normalization` (x − mean)·rsqrt(var + 1e-7)).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch


def to_float(img: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] → float32 [0,1]; other dtypes are cast unscaled."""
    if img.dtype == torch.uint8:
        return img.float() / 255.0
    return img.float()


def normalize_to_unit(batch: torch.Tensor) -> torch.Tensor:
    return to_float(batch)


def standardize(batch: torch.Tensor, mean: torch.Tensor, var: torch.Tensor
                ) -> torch.Tensor:
    """Adaptive normalisation (x − mean)·rsqrt(var + 1e-7), per channel
    (Keras `Normalization`)."""
    return (to_float(batch) - mean) * torch.rsqrt(var + 1e-7)


def resize_bilinear(batch: torch.Tensor, size: Tuple[int, int],
                    antialias: bool = True) -> torch.Tensor:
    """NHWC batch → (h, w), float32: `jax.image.resize(..., "bilinear")`
    through `resize`, antialiased when downscaling unless
    `antialias=False`."""
    n, _, _, c = batch.shape
    return resize(to_float(batch), (n, size[0], size[1], c), "linear",
                  antialias)


def compute_norm_stats(batch: torch.Tensor) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Per-channel (mean, var) of an N×H×W×C batch, f32 [C] each."""
    x = to_float(batch)
    mean = x.mean(dim=(0, 1, 2))
    var = x.var(dim=(0, 1, 2), correction=0)
    return mean, var


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys cubic (a = −0.5) on |d|, in `jax.image`'s Horner form."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


_RESIZE_KERNELS = {"linear": _triangle, "bilinear": _triangle,
                   "cubic": _keys_cubic, "bicubic": _keys_cubic}


@functools.lru_cache(maxsize=64)
def _resize_weights(m: int, n: int, method: str, antialias: bool = True
                    ) -> torch.Tensor:
    """f32 [m, n] weights of `jax.image.resize`'s `compute_weight_mat`:
    output j samples at (j + 0.5) / scale − 0.5, the kernel widened by
    1/scale when downscaling with antialias on, each column normalised,
    and zeroed where the sample lies outside [−0.5, m − 0.5]."""
    f32 = torch.float32
    inv_scale = 1.0 / torch.tensor(n / m, dtype=f32)
    kernel_scale = (torch.clamp(inv_scale, min=1.0) if antialias
                    else torch.tensor(1.0, dtype=f32))
    sample_f = (torch.arange(n, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(m, dtype=f32)[:, None]).abs() \
        / kernel_scale
    w = _RESIZE_KERNELS[method](x)
    total = w.sum(dim=0, keepdim=True)
    eps = float(torch.finfo(f32).eps)
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.where(inside[None, :], w, 0.0)


@functools.lru_cache(maxsize=64)
def _nearest_index(m: int, n: int) -> np.ndarray:
    """`jax.image.resize`'s nearest source rows, floor((j + 0.5)·m/n), as
    XLA compiles it: the constant factors folded into one float32
    m·(1/n) (at 256 → 333 row 166 reads 127, where exact arithmetic reads
    128)."""
    f32 = np.float32
    factor = f32(m) * (f32(1.0) / f32(n))
    return np.floor((np.arange(n, dtype=f32) + f32(0.5)) * factor
                    ).astype(np.int64)


def resize(x: torch.Tensor, shape: Sequence[int], method: str,
           antialias: bool = True) -> torch.Tensor:
    """`jax.image.resize(x, shape, method, antialias=antialias)`: every axis
    whose size changes is resampled, the others pass through.

    `linear` and `cubic` promote to float32 and contract each changed axis
    with its `_resize_weights` matrix; `nearest` gathers whole rows at
    `_nearest_index` and keeps the dtype, as JAX does."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.dim():
        raise ValueError(f"resize: shape {shape} for a {x.dim()}-d tensor")
    if method == "nearest":
        for d, (m, n) in enumerate(zip(x.shape, shape)):
            if m != n:
                idx = torch.from_numpy(_nearest_index(m, n)).to(x.device)
                x = x.index_select(d, idx)
        return x
    if method not in _RESIZE_KERNELS:
        raise ValueError(f"resize: unknown method {method!r}")
    x = x.float()
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m != n:
            w = _resize_weights(m, n, method, antialias).to(x.device)
            x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x
