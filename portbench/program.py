"""The system under test, built from a configuration: the port's model with
the benchmark's weights in it. Only the drivers import the port, and only
through here, the port's side of each arch (`archs/<arch>.py`) and their
own calls into its public entries."""

from __future__ import annotations

import torch

from portbench import arch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model(cfg: dict, weights: dict, device: torch.device) -> torch.nn.Module:
    """The port's model of `cfg["arch"]` (`archs/<arch>.py`), in its
    compute dtype, holding `weights` (the benchmark's, keyed by the port's
    names)."""
    m = arch.load(cfg["arch"], "program").build(
        cfg, DTYPES[cfg["compute_dtype"]])
    m.load_state_dict({k: v.detach().clone() for k, v in weights.items()})
    return m.to(device)
