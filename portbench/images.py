"""Leaf-like pictures made from the seed, on the device.

Each picture is a green ellipse on a light background with pixel noise,
as the port's smoke and tests draw them (`chip_smoke.leafish_image`), made
for a whole batch at once with a generator on the device. Every class
draws its own colour shift and ellipse shape from the seed, so a model
can learn the labels.
"""

from __future__ import annotations

import torch

CHUNK = 512


def class_shifts(num_classes: int, generator: torch.Generator, device
                 ) -> torch.Tensor:
    """[K, 5]: per class an RGB shift (±30) and the ellipse's two radius
    factors (0.8 to 1.2)."""
    u = torch.rand((num_classes, 5), generator=generator, device=device)
    return torch.cat([(u[:, :3] - 0.5) * 60.0, 0.8 + u[:, 3:] * 0.4], 1)


def leaf_images(labels: torch.Tensor, size: int, shifts: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """uint8 [n, size, size, 3] on the labels' device, one picture a
    label."""
    device = labels.device
    out = torch.empty((len(labels), size, size, 3), dtype=torch.uint8,
                      device=device)
    yy, xx = torch.meshgrid(torch.arange(size, device=device,
                                         dtype=torch.float32),
                            torch.arange(size, device=device,
                                         dtype=torch.float32),
                            indexing="ij")
    for s in range(0, len(labels), CHUNK):
        lab = labels[s:s + CHUNK]
        n = len(lab)
        sh = shifts[lab]
        g = torch.randn((n, 4), generator=generator, device=device)
        u = torch.rand((n, 3), generator=generator, device=device)
        cy = size / 2 + g[:, 0] * 3
        cx = size / 2 + g[:, 1] * 3
        ry = (size * 0.32 + g[:, 2] * 2) * sh[:, 3]
        rx = (size * 0.38 + g[:, 3] * 2) * sh[:, 4]
        blob = (((yy - cy[:, None, None]) / ry[:, None, None]) ** 2
                + ((xx - cx[:, None, None]) / rx[:, None, None]) ** 2) < 1.0
        base = torch.tensor([40.0, 120.0, 30.0], device=device)
        span = torch.tensor([40.0, 80.0, 40.0], device=device)
        colour = base + u * span + sh[:, :3]
        img = torch.where(blob[..., None], colour[:, None, None, :],
                          torch.full((), 235.0, device=device))
        img = img + torch.randn(img.shape, generator=generator,
                                device=device) * 4.0
        out[s:s + n] = img.clamp(0, 255).to(torch.uint8)
    return out

