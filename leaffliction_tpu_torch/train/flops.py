"""FLOP accounting and MFU: how busy is the card, really.

The JAX package reads XLA's count of the optimised program; the port
counts the aten operations one call dispatches
(`torch.utils.flop_counter.FlopCounterMode`): MFU = (FLOPs a step) /
(step time · peak FLOP/s). Peaks are the dense bf16 tensor-core rates of
NVIDIA's published specifications, looked up by the card's name.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

# dense (no sparsity) bf16 tensor-core FLOP/s by `get_device_name`
# substring: the H100 SXM5 and PCIe rates from NVIDIA's H100 Tensor Core
# GPU Architecture whitepaper, the NVL rate from the H100 NVL datasheet
_PEAKS = (
    ("h100 80gb hbm3", 989.4e12),   # H100 SXM5
    ("h100 sxm", 989.4e12),
    ("h100 nvl", 835.5e12),
    ("h100 pcie", 756.0e12),
)


def device_peak_flops(device: Optional[torch.device] = None
                      ) -> Optional[float]:
    """Dense bf16 peak FLOP/s of a CUDA device (default: the current one);
    None on the CPU and for a card the table does not name."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    kind = torch.cuda.get_device_name(device).lower()
    for tag, peak in _PEAKS:
        if tag in kind:
            return peak
    return None


def compiled_flops(fn, *args, **kwargs) -> Optional[float]:
    """FLOPs of one call `fn(*args, **kwargs)`, counted by
    `FlopCounterMode`; None when nothing was counted or the call raised.

    It differs from the JAX package's XLA count in three ways:
    - it runs the call: a train step advances its state and generator, so
      count on a state that is thrown away afterwards;
    - it counts convolutions and matrix products, forward and backward,
      and no elementwise or reduction work, so it stands within a few
      percent of XLA's total for these models;
    - a CUDA graph replay dispatches no aten operation, so it counts
      nothing: count a chained step from an eager call at its shapes.

    K eager steps (`StepFns.train_step_chain`) count K times one step.
    XLA counts a `lax.scan` body once, whatever its trip count, so the JAX
    package's count of a chain is that of one step.
    """
    counter = FlopCounterMode(display=False)
    try:
        with counter:
            fn(*args, **kwargs)
    except Exception:  # the JAX contract: a count or None, never a raise
        return None
    flops = float(counter.get_total_flops())
    return flops if flops > 0 else None


def mfu(flops_per_step: Optional[float], step_time_s: float,
        device: Optional[torch.device] = None) -> Optional[float]:
    """Model FLOPs utilisation in [0, 1]; None when the peak or the count
    is unknown or the time is not positive."""
    peak = device_peak_flops(device)
    if not peak or not flops_per_step or step_time_s <= 0:
        return None
    return flops_per_step / (step_time_s * peak)
