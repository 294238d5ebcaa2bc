"""CLAHE — contrast-limited adaptive histogram equalization.

Port of `leaffliction_tpu/ops/clahe.py` (cv2.createCLAHE(clipLimit=2.0,
tileGridSize=(8, 8)) for vein enhancement): per-tile 256-bin histograms,
clip and redistribute, the LUT as round(cdf·255 / tile pixels), and each
pixel blended from its four surrounding tile LUTs. The JAX package writes
the blend as one-hot einsums for the TPU's matrix unit; here it is a gather
of the four LUT values with the same two-tap row and column weights, so it
agrees with JAX to float32 rounding (the tests hold 1e-3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def clahe(gray: torch.Tensor, clip_limit: float = 2.0, tiles: int = 8
          ) -> torch.Tensor:
    """gray float [0,255] [h, w] → equalized float [0,255] [h, w]."""
    h, w = gray.shape
    dev = gray.device
    g = torch.clamp(torch.round(gray.float()), 0, 255)

    # pad so dimensions divide evenly (reflect-101, as jnp.pad "reflect")
    th, tw = -(-h // tiles), -(-w // tiles)
    ph, pw = th * tiles - h, tw * tiles - w
    gp = F.pad(g[None, None], (0, pw, 0, ph), mode="reflect")[0, 0] \
        if ph or pw else g
    tiled = gp.long().reshape(tiles, th, tiles, tw).permute(0, 2, 1, 3)
    tiled = tiled.reshape(tiles * tiles, th * tw)

    offs = torch.arange(tiles * tiles, device=dev)[:, None] * 256
    hist = torch.bincount((tiled + offs).reshape(-1),
                          minlength=tiles * tiles * 256).reshape(-1, 256)
    hist = hist.float()

    # clip + redistribute — cv2 floors the scaled limit to an int
    n = th * tw
    limit = max(float(int(clip_limit * n / 256.0)), 1.0)
    excess = torch.clamp(hist - limit, min=0.0).sum(dim=1, keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / 256.0
    cdf = torch.cumsum(hist, dim=1)
    luts = torch.clamp(torch.round(cdf * 255.0 / n), 0, 255)  # [T, 256]

    def taps(size: int, tile: int):
        t = (torch.arange(size, dtype=torch.float32, device=dev) + 0.5) \
            / tile - 0.5
        i0 = torch.clamp(torch.floor(t), 0, tiles - 1)
        i1 = torch.clamp(i0 + 1, 0, tiles - 1)
        wt = torch.clamp(t - i0, 0.0, 1.0)
        return i0.long(), i1.long(), wt

    y0, y1, wy = taps(h, th)
    x0, x1, wx = taps(w, tw)
    gi = g.long()

    def lut(ty, tx):  # [h, 1] and [1, w] tile indices → LUT value per pixel
        return luts[(ty[:, None] * tiles + tx[None, :]), gi]

    wy, wx = wy[:, None], wx[None, :]
    top = (1.0 - wx) * lut(y0, x0) + wx * lut(y0, x1)
    bottom = (1.0 - wx) * lut(y1, x0) + wx * lut(y1, x1)
    return (1.0 - wy) * top + wy * bottom
