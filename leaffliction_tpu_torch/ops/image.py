"""Input statistics for the model's adaptive normalisation.

Port of `leaffliction_tpu/ops/image.py::compute_norm_stats` (the reference's
Keras `Normalization.adapt`): per-channel mean and *biased* variance over an
N×H×W×C sample, uint8 read as value/255.
"""

from __future__ import annotations

from typing import Tuple

import torch


def compute_norm_stats(batch: torch.Tensor) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Per-channel (mean, var) of an N×H×W×C batch, f32 [C] each."""
    x = batch.float() / 255.0 if batch.dtype == torch.uint8 else batch.float()
    mean = x.mean(dim=(0, 1, 2))
    var = x.var(dim=(0, 1, 2), correction=0)
    return mean, var
