"""Process-group set-up for data parallelism: one process per device.

Port of `leaffliction_tpu/parallel/distributed.py`. A JAX multi-host run
is one process per host over all of its devices; PyTorch's idiom is one
process per device, so a rank here plays the part of a JAX host with one
device. `maybe_initialize` reads the environment that
`python -m torch.distributed.run` (torchrun) sets for every rank (`RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`, `MASTER_ADDR`,
`MASTER_PORT`) and joins the default process group with an explicit
timeout. Without that environment, or with a world of one, it does
nothing: a single process needs no group.

The backend follows from the devices (`backend_for`): `nccl` when each
rank owns its own CUDA device (`--device cuda`: rank r takes
`cuda:LOCAL_RANK`), `gloo` on the CPU or when the ranks of a host share one
device (`--device cuda:N` with more than one local rank; NCCL refuses two
ranks on one GPU). Every rank decides from the same flags, so all agree.
Nothing retries on another backend after a failure.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from leaffliction_tpu_torch.core.logging import get_logger

LOGGER = get_logger(__name__)

TIMEOUT_S = 600.0  # every collective of the group gives up after this
_timeout = datetime.timedelta(seconds=TIMEOUT_S)  # the joined group's


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def world_size() -> int:
    """Processes in the run: the group's size once joined, else torchrun's
    `WORLD_SIZE`, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return _env_int("WORLD_SIZE", 1)


def rank() -> int:
    """This process's rank (0 without a group or torchrun's `RANK`)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return _env_int("RANK", 0)


def local_rank() -> int:
    """This process's rank on its host (torchrun's `LOCAL_RANK`, else 0)."""
    return _env_int("LOCAL_RANK", 0)


def local_world_size() -> int:
    """Processes on this host (torchrun's `LOCAL_WORLD_SIZE`, else the
    world size)."""
    return _env_int("LOCAL_WORLD_SIZE", world_size())


def rank_device(name: str = "cuda") -> torch.device:
    """`--device` → this rank's device: a bare `cuda` is `cuda:LOCAL_RANK`
    in a multi-process run; a named index or the CPU stays as given."""
    device = torch.device(name or "cuda")
    if device.type == "cuda" and device.index is None and world_size() > 1:
        device = torch.device("cuda", local_rank())
    return device


def backend_for(name: str = "cuda") -> str:
    """The collective backend for `--device name` (see the module doc)."""
    device = torch.device(name or "cuda")
    if device.type != "cuda":
        return "gloo"
    if device.index is not None and local_world_size() > 1:
        return "gloo"  # the ranks of this host share one card
    return "nccl"


def maybe_initialize(device_name: str = "cuda",
                     timeout_s: float = TIMEOUT_S) -> Optional[str]:
    """Join the default process group when torchrun's environment names a
    world of more than one process → the backend, or None for a single
    process. Idempotent: a second call returns the group's backend."""
    if dist.is_initialized():
        return dist.get_backend()
    world = _env_int("WORLD_SIZE", 1)
    if world <= 1:
        return None
    missing = [k for k in ("RANK", "MASTER_ADDR", "MASTER_PORT")
               if not os.environ.get(k)]
    if missing:
        raise ValueError(f"WORLD_SIZE={world} but {', '.join(missing)} "
                         "unset: launch with python -m "
                         "torch.distributed.run")
    global _timeout
    backend = backend_for(device_name)
    device = rank_device(device_name)
    if backend == "nccl":
        torch.cuda.set_device(device)
    _timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend, init_method="env://", rank=_env_int("RANK", 0),
        world_size=world, timeout=_timeout)
    LOGGER.info("torch.distributed: rank %d/%d (local %d/%d) on %s, "
                "backend %s", dist.get_rank(), world, local_rank(),
                local_world_size(), device, backend)
    return backend


def new_group(ranks) -> dist.ProcessGroup:
    """A subgroup of `ranks` with the default group's backend and timeout.
    Every rank of the world must make the same calls in the same order,
    members or not (`torch.distributed.new_group`)."""
    return dist.new_group(list(ranks), timeout=_timeout)


def shutdown() -> None:
    """Leave the default process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
