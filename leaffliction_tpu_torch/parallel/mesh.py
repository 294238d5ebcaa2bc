"""The data-parallel mesh: who holds which rows, and the few collectives.

Port of `leaffliction_tpu/parallel/mesh.py` for one process per device
(`parallel/distributed.py`). A JAX mesh run is one SPMD program over the
global batch; here each rank runs the same step on its own rows, and the
places where rows meet (BatchNorm's moments, the loss's mask count, the
gradients, the metrics) are explicit collectives on the data group. As in
the JAX package there is no hand-written communication kernel: the
collectives are `torch.distributed` calls, and only `all_reduce`,
`broadcast` and `all_gather` are used (gloo's CUDA support covers those
three).

`MeshSpec.resolve` keeps the JAX error text. `make_mesh` → `Mesh`, a small
record: the data size P (the world size), `model` = 1, this rank, its
device, the backend and the group (None for one process). `local_rows` is
the counterpart of `batch_sharding` / `global_batch_array`: the rows of a
global batch that a rank holds. `check_replicated` is the counterpart of
`replicate_global`: every rank already holds its copy, so it hashes the
copy, all-gathers the hashes and raises if any rank's differs. Tensor
parallelism (`tp_shardings`, a `model` axis above 1) is not ported.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from leaffliction_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape; `model=1` means pure data parallelism."""

    data: int = -1   # -1: use all remaining devices
    model: int = 1

    def resolve(self, n_devices: int) -> "MeshSpec":
        model = max(1, self.model)
        data = self.data if self.data > 0 else n_devices // model
        if data * model != n_devices:
            raise ValueError(
                f"mesh {data}x{model} does not cover {n_devices} devices"
            )
        return MeshSpec(data=data, model=model)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's view of the data-parallel mesh."""

    data: int
    rank: int
    device: torch.device
    backend: Optional[str] = None
    group: Optional[dist.ProcessGroup] = None
    model: int = 1

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    def rows(self, n_global: int) -> slice:
        return local_rows(n_global, self.rank, self.data)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the data group, in place → `t`."""
        if self.data > 1:
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's `t` (same shape and dtype), in rank order."""
        if self.data == 1:
            return [t]
        out = [torch.empty_like(t) for _ in range(self.data)]
        dist.all_gather(out, t.contiguous(), group=self.group)
        return out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s `t` on every rank, in place → `t`."""
        if self.data > 1:
            dist.broadcast(t, src, group=self.group)
        return t

    def barrier(self) -> None:
        if self.data > 1:
            dist.barrier(group=self.group)


def make_mesh(spec: MeshSpec | None = None,
              device: torch.device | str = "cpu") -> Mesh:
    """The mesh over this run's processes (`distributed.world_size()`),
    one device each; `device` is this rank's. Raises `MeshSpec.resolve`'s
    ValueError when `spec` does not cover the processes, and
    NotImplementedError for a `model` axis above 1."""
    spec = spec or MeshSpec()
    if spec.model > 1:
        raise NotImplementedError(
            f"mesh {spec.data}x{spec.model}: tensor parallelism over "
            "`model` is not ported")
    spec = spec.resolve(distributed.world_size())
    multi = spec.data > 1
    return Mesh(data=spec.data, rank=distributed.rank(),
                device=torch.device(device),
                backend=dist.get_backend() if multi else None,
                group=dist.group.WORLD if multi else None)


def local_rows(n_global: int, rank: int, n_ranks: int) -> slice:
    """Rank `rank`'s rows of a global batch of `n_global` rows split into
    `n_ranks` equal contiguous blocks (rank 0 first)."""
    if n_global % n_ranks:
        raise ValueError(f"global batch {n_global} not divisible by the "
                         f"mesh data axis ({n_ranks})")
    per = n_global // n_ranks
    return slice(rank * per, (rank + 1) * per)


def check_replicated(t: torch.Tensor, mesh: Mesh, what: str = "tensor"
                     ) -> str:
    """Raise ValueError unless every rank holds the same bytes in `t` (its
    shape and dtype included) → the sha256 hex digest. One all-gather of
    the 32-byte digest; the tensor itself never moves."""
    h = hashlib.sha256(f"{tuple(t.shape)} {t.dtype}".encode())
    h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
             .numpy().tobytes())
    digest = h.digest()
    words = torch.from_numpy(np.frombuffer(digest, "<i8").copy()).to(
        mesh.device)
    seen = [w.cpu().numpy().tobytes() for w in mesh.all_gather(words)]
    differ = [r for r, d in enumerate(seen) if d != digest]
    if differ:
        raise ValueError(f"{what} differs between ranks: rank "
                         f"{mesh.rank}'s copy is not the one of rank(s) "
                         f"{differ}")
    return digest.hex()
