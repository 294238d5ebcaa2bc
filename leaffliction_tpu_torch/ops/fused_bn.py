"""Inference BatchNorm with flax's numerics.

Port of the eval branch of `leaffliction_tpu/ops/fused_bn.py::BatchNorm`:
`(x.float() − mean) · (rsqrt(var + eps) · scale) + bias` in f32, cast back to
the module's compute dtype. Channels are dim 1 (NCHW). Training-mode
BatchNorm comes with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over NCHW; same variables as the flax module:
    params `scale`/`bias`, batch_stats `mean`/`var` (buffers here)."""

    def __init__(self, channels: int, epsilon: float = 1e-3,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(self.var + self.epsilon) * self.scale.float()
        y = ((x.float() - self.mean.view(shape)) * mul.view(shape)
             + self.bias.float().view(shape))
        return y.to(self.dtype)
