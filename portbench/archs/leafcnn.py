"""The port's LeafCNN (`models/leafcnn.py`) for a configuration of arch
`leafcnn`."""

from __future__ import annotations

import torch


def build(cfg: dict, dtype: torch.dtype) -> torch.nn.Module:
    from leaffliction_tpu_torch.models.leafcnn import LeafCNN

    return LeafCNN(cfg["num_classes"], cfg["widths"],
                   separable=cfg["separable"],
                   use_norm=cfg["use_normalization"], stem=cfg["stem"],
                   dtype=dtype, drop_block=cfg["drop_block"],
                   drop_top=cfg["drop_top"], use_se=cfg["use_se"])
