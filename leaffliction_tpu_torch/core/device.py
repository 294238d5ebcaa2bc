"""Device selection for the port.

`resolve_device` turns a `--device` value into a `torch.device`. It defaults
to CUDA and raises when CUDA is absent: the port never drops to the CPU on
its own. The CPU is used only when asked for by name (tests, references).

It also pins float32 precision: cuDNN runs f32 convolutions in TF32 by
default, and f32 serving here means full f32, so TF32 is switched off for
both convolutions and matrix products.
"""

from __future__ import annotations

import torch


def resolve_device(name: str | None = "cuda") -> torch.device:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(name or "cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--device {device}: CUDA is not available (pass --device cpu "
                "to run on the CPU on purpose)")
        if device.index is not None and device.index >= \
                torch.cuda.device_count():
            raise RuntimeError(f"--device {device}: only "
                               f"{torch.cuda.device_count()} CUDA device(s)")
    elif device.type != "cpu":
        raise RuntimeError(f"--device {device}: only cuda and cpu are "
                           "supported")
    return device
