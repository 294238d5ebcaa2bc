"""The system under test, built from a configuration: the port's model with
the benchmark's weights in it. Only the drivers import the port, and only
through here and their own calls into its public entries."""

from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model(cfg: dict, weights: dict, device: torch.device) -> torch.nn.Module:
    """The port's LeafCNN or LeafResNet for `cfg`, in its compute dtype,
    holding `weights` (the benchmark's, keyed by the port's names)."""
    from leaffliction_tpu_torch.models.leafcnn import LeafCNN
    from leaffliction_tpu_torch.models.resnet import LeafResNet

    dtype = DTYPES[cfg["compute_dtype"]]
    if cfg["arch"] == "leafcnn":
        m = LeafCNN(cfg["num_classes"], cfg["widths"],
                    separable=cfg["separable"],
                    use_norm=cfg["use_normalization"], stem=cfg["stem"],
                    dtype=dtype, drop_block=cfg["drop_block"],
                    drop_top=cfg["drop_top"], use_se=cfg["use_se"])
    else:
        m = LeafResNet(cfg["num_classes"], blocks=cfg["blocks"],
                       widths=cfg["widths"],
                       use_norm=cfg["use_normalization"],
                       drop_top=cfg["drop_top"], stem=cfg["stem"],
                       dtype=dtype)
    m.load_state_dict({k: v.detach().clone() for k, v in weights.items()})
    return m.to(device)
