"""FLOPs of the configuration's model, counted over the plain reference.

`torch.utils.flop_counter.FlopCounterMode` counts the convolutions and
matrix products, forward and backward, with torch's formulas, over the
reference model (`reference/models.py`) on shape-only tensors (the meta
device) at batch 2, halved: the counts are linear in the batch. The
counted forward draws no dropout mask (`Context(dropout=False)`). Counting
the reference and not the port keeps the count fixed when a later change
moves a convolution into a hand-written kernel. Elementwise and reduction
work is not counted.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import models

# dense bf16 tensor-core FLOP/s by `get_device_name` fragment (NVIDIA's
# H100 Tensor Core GPU Architecture whitepaper; the NVL datasheet)
PEAKS = (("h100 80gb hbm3", 989.4e12), ("h100 sxm", 989.4e12),
         ("h100 nvl", 835.5e12), ("h100 pcie", 756.0e12))
# the H100 SXM's HBM3 bytes a second (NVIDIA's datasheet)
HBM_BYTES_PER_S = 3.35e12


def peak_flops(device: torch.device) -> float:
    """The card's dense bf16 peak; an unknown card fails the run."""
    kind = torch.cuda.get_device_name(device).lower()
    for fragment, peak in PEAKS:
        if fragment in kind:
            return peak
    raise RuntimeError(f"no bf16 peak known for {kind!r}")


def _count(cfg: dict, train: bool) -> float:
    w = {name: torch.empty(shape, device="meta")
         for name, shape, _ in models.layout(cfg)}
    size = cfg["img_size"]
    x = torch.empty((2, size, size, 3), device="meta")
    names = models.trainable(cfg)
    counter = FlopCounterMode(display=False)
    with counter:
        if train:
            for k in names:
                w[k].requires_grad_(True)
            logits = models.forward(cfg, w, x,
                                    models.Context(True, dropout=False))
            torch.autograd.grad(logits.sum(), [w[k] for k in names])
        else:
            with torch.no_grad():
                models.forward(cfg, w, x, models.Context(False))
    return counter.get_total_flops() / 2


def train_flops_per_image(cfg: dict) -> float:
    """One image through a train step: forward and backward."""
    return _count(cfg, True)


def forward_flops_per_image(cfg: dict) -> float:
    """One image through the eval forward."""
    return _count(cfg, False)
