"""The port's LeafResNet (`models/resnet.py`) for a configuration of arch
`resnet`."""

from __future__ import annotations

import torch


def build(cfg: dict, dtype: torch.dtype) -> torch.nn.Module:
    from leaffliction_tpu_torch.models.resnet import LeafResNet

    return LeafResNet(cfg["num_classes"], blocks=cfg["blocks"],
                      widths=cfg["widths"],
                      use_norm=cfg["use_normalization"],
                      drop_top=cfg["drop_top"], stem=cfg["stem"],
                      dtype=dtype)
