"""Rounding for the controls: the reference computed in a lower precision
than the configuration states.

`q` rounds a tensor to a narrower format and back to float32 where the
model holds an activation or a weight, and rounds the gradient that flows
back through the same point, so the reference's arithmetic stays float32
while every value it keeps carries only the narrow format's bits, forward
and backward, as in a model trained in that format. fp8 follows the usual
recipe: e4m3 forward, e5m2 for gradients, one scale a tensor (its largest
magnitude maps to the format's largest value).
"""

from __future__ import annotations

import torch

FORMATS = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _scaled(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    amax = x.abs().amax().clamp_min(1e-30)
    scale = amax / FORMATS[dtype]
    return (x / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _scaled(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _scaled(g, torch.float8_e5m2)


class _Bf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return _Bf16.apply(x)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


ROUNDINGS = {"float32": identity, "bfloat16": bf16, "fp8": fp8}

# the precision a control uses, below the one a configuration states
BELOW = {"bfloat16": "fp8", "float32": "bfloat16"}
