"""Training-time augmentation inside the train step: flip, rotate, contrast.

Port of `leaffliction_tpu/ops/train_augment.py` (the reference's Keras
RandomFlip horizontal, RandomRotation 0.05, RandomContrast 0.1). Per image,
from an explicit `torch.Generator`: a horizontal flip with p = 0.5, an angle
from U(±0.05·360°) and a contrast factor from U(0.9, 1.1). JAX's threefry
draws and torch's Philox draws never agree, so the port is held to the JAX
package by its distributions, and by its math with the draws injected
(`apply_u8`, `apply_f32`).

`train_augment_u8` (the train step's path) flips the uint8 batch and runs
kernel K1 (`ops/kernels/rotate.train_aug`): uint8 → rotation → contrast, in
the model's dtype. `train_augment` is the f32-in entry: flip, K1's rotation,
then the contrast in plain PyTorch, as the JAX function composes them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from leaffliction_tpu_torch.ops.kernels.rotate import train_aug


def draw_params(n: int, generator: torch.Generator, device,
                rotation_frac: float = 0.05, contrast_delta: float = 0.1
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (flip bool [n], angles f32 [n] in degrees, factors f32 [n])."""
    u = torch.rand((3, n), generator=generator, device=device)
    max_deg = rotation_frac * 360.0
    do_flip = u[0] < 0.5
    angles = -max_deg + u[1] * (2.0 * max_deg)
    factors = (1.0 - contrast_delta) + u[2] * (2.0 * contrast_delta)
    return do_flip, angles, factors


def _flip(batch: torch.Tensor, do_flip: torch.Tensor) -> torch.Tensor:
    return torch.where(do_flip[:, None, None, None], batch.flip(2), batch)


def apply_u8(batch_u8: torch.Tensor, do_flip: torch.Tensor,
             angles: torch.Tensor, factors: torch.Tensor,
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Augment N×H×W×3 uint8 with given draws → `out_dtype` in [0, 1]."""
    return train_aug(_flip(batch_u8, do_flip), angles, factors, out_dtype)


def apply_f32(batch: torch.Tensor, do_flip: torch.Tensor,
              angles: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Augment N×H×W×C float [0, 1] with given draws → f32."""
    rotated = train_aug(_flip(batch.float(), do_flip), angles)
    mean = rotated.mean(dim=(1, 2), keepdim=True)
    return torch.clamp(mean + (rotated - mean) * factors[:, None, None, None],
                       0.0, 1.0)


def train_augment_u8(generator: torch.Generator, batch_u8: torch.Tensor,
                     rotation_frac: float = 0.05, contrast_delta: float = 0.1,
                     out_dtype: torch.dtype = torch.float32,
                     mesh=None) -> torch.Tensor:
    """Draw and apply: N×H×W×3 uint8 → `out_dtype` in [0, 1]. With a
    data-parallel `mesh` (`parallel.mesh.Mesh`), the batch is this rank's
    rows of the global batch: the draws are made for the global batch, as
    the JAX program makes them, and K1 gets this rank's rows, so every
    rank's generator stays in step. The rows are the data index's: the
    model ranks of one data index (tensor parallelism) augment the same
    rows with the same draws."""
    n = batch_u8.shape[0]
    if mesh is not None:
        n *= mesh.data
    draws = draw_params(n, generator, batch_u8.device, rotation_frac,
                        contrast_delta)
    if mesh is not None:
        draws = tuple(d[mesh.rows(n)] for d in draws)
    return apply_u8(batch_u8, *draws, out_dtype=out_dtype)


def train_augment(generator: torch.Generator, batch: torch.Tensor,
                  rotation_frac: float = 0.05,
                  contrast_delta: float = 0.1) -> torch.Tensor:
    """Draw and apply: N×H×W×C float [0, 1] → f32 in [0, 1]."""
    draws = draw_params(batch.shape[0], generator, batch.device,
                        rotation_frac, contrast_delta)
    return apply_f32(batch, *draws)
