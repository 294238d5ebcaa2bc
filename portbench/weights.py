"""Weights made from the seed, one set handed to both the port and the
reference.

Every tensor of the configuration's model (`reference.models.layout`) is
made by the rule of its kind: conv and dense kernels are cut, in layout
order, from one normal draw of a generator on the device, with standard
deviation 1/√fan_in (flax's lecun-normal scale, untruncated); biases
(kind `bias`, a BatchNorm's shift among them) 0; every scale (`scale`,
`zero_scale`) 1, also where the port's own initialiser starts a block's
last BatchNorm at 0 (a residual branch that starts at zero leaves most of
a ResNet out of its first steps, and out of their comparison); running
mean 0 and variance 1. The input statistics are the per-channel mean and
variance over [0, 1] of the first 256 images. A kind that no rule names
fails the draw.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference import models

Tensors = Dict[str, torch.Tensor]
STAT_IMAGES = 256  # the input statistics' sample


def draw(cfg: dict, images_u8: torch.Tensor, generator: torch.Generator
         ) -> Tensors:
    """float32 weights on the images' device, keyed by the port's names."""
    device = images_u8.device
    spec = list(models.layout(cfg))
    kernels = [(n, s) for n, s, kind in spec if kind in ("conv", "dense")]
    flat = torch.randn(sum(math.prod(s) for _, s in kernels),
                       generator=generator, device=device)
    pixels = images_u8[:STAT_IMAGES].reshape(-1, 3).float() / 255.0
    out: Tensors = {}
    offset = 0
    for name, shape, kind in spec:
        if kind in ("conv", "dense"):
            size = math.prod(shape)
            fan_in = math.prod(shape[1:])
            out[name] = (flat[offset:offset + size].view(shape)
                         / math.sqrt(fan_in))
            offset += size
        elif kind == "norm_mean":
            out[name] = pixels.mean(0)
        elif kind == "norm_var":
            out[name] = pixels.var(0, unbiased=False)
        elif kind in ("scale", "zero_scale", "var"):
            out[name] = torch.ones(shape, device=device)
        elif kind in ("bias", "mean"):
            out[name] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"no rule draws {name!r} of kind {kind!r}")
    return out

