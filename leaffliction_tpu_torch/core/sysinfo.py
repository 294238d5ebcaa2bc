"""Host and device summary for `meta.json`'s "system" block.

The host fields are those of `leaffliction_tpu/core/sysinfo.py`
(`get_system_info`: platform, Python version, processor, CPU count), and
`get_optimal_worker_count` is its copy (the balancer's host pool size). The
device fields keep the JAX block's keys but describe the torch device the
run used: backend `cuda` (or `cpu`), the CUDA device count, the card's name
(`torch.cuda.get_device_name`) and the run's process count (the
data-parallel world size, 1 without one). The JAX function's own probe
imports jax, which the port never does.
"""

from __future__ import annotations

import os
import platform
from typing import Any, Dict

import torch


def get_cpu_count() -> int:
    return os.cpu_count() or 1


def get_optimal_worker_count() -> int:
    """Reference heuristic: ≤2 cores → 1; ≤4 → n-1; else 75% (capped ≥1)."""
    n = get_cpu_count()
    if n <= 2:
        return 1
    if n <= 4:
        return n - 1
    return max(1, int(n * 0.75))


def get_device_info(device: torch.device) -> Dict[str, Any]:
    from leaffliction_tpu_torch.parallel.distributed import world_size

    device = torch.device(device)
    if device.type == "cuda":
        return {"backend": "cuda",
                "device_count": torch.cuda.device_count(),
                "device_kind": torch.cuda.get_device_name(device),
                "process_count": world_size()}
    return {"backend": device.type, "device_count": 1,
            "device_kind": platform.processor() or platform.machine(),
            "process_count": world_size()}


def get_system_info(device: torch.device) -> Dict[str, Any]:
    info: Dict[str, Any] = {
        "platform": platform.platform(),
        "python_version": platform.python_version(),
        "processor": platform.processor() or platform.machine(),
        "cpu_count": get_cpu_count(),
    }
    info.update(get_device_info(device))
    return info
