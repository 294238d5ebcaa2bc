"""The device mesh: who holds which rows and channels, and the collectives.

Port of `leaffliction_tpu/parallel/mesh.py` for one process per device
(`parallel/distributed.py`). A JAX mesh run is one SPMD program over the
global batch and the whole model; here each rank runs the same step on its
rows and its channels, and the places where rows or channels meet are
explicit collectives. As in the JAX package there is no hand-written
communication kernel: the collectives are `torch.distributed` calls, and
only `all_reduce`, `broadcast` and `all_gather` are used (gloo's CUDA
support covers those three).

`make_mesh(MeshSpec(data=D, model=T))` over D·T processes puts rank r at
data index r // T and model index r % T, JAX's `reshape(data, model)` of
the device list. `Mesh` is a small record: D, T, this rank, its device,
the backend, its data group (the D ranks of its model index: BatchNorm's
moments, the loss's mask count, the gradients, the metrics) and its model
group (the T ranks of its data index: the channel gathers of tensor
parallelism). `MeshSpec.resolve` keeps the JAX error text. `local_rows` is
the counterpart of `batch_sharding` / `global_batch_array`: the rows of a
global batch that a data index holds. `check_replicated` is the
counterpart of `replicate_global`: every rank already holds its copy, so
it hashes the copy, all-gathers the hashes over the world and raises if
any rank's differs.

`tp_shardings` is JAX's rule for tensor parallelism over `model`, decided
on the flax shape of every state tensor (`convert.flax_shape`): a tensor
whose flax last dim is at least `min_size` and divides by T is sharded on
that dim, which is the output channel of every conv, Dense and BatchNorm
tensor and dim 0 of its torch layout; everything else is replicated.
`shard` / `channel_slice` give this rank's block, as JAX's
`PartitionSpec(..., "model")` does: model index m holds block m of T.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from leaffliction_tpu_torch.convert import flax_shape
from leaffliction_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"
TP_MIN_SIZE = 64  # JAX's `tp_shardings` default, the CLI's


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
    """A rank's view of the data × model mesh."""

    data: int
    rank: int  # global: data index rank // model, model index rank % model
    device: torch.device
    backend: Optional[str] = None
    group: Optional[dist.ProcessGroup] = None  # the data group
    model: int = 1
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def rows(self, n_global: int) -> slice:
        return local_rows(n_global, self.data_rank, self.data)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the data group, in place → `t`."""
        if self.data > 1:
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every data index's `t` (same shape and dtype), in order."""
        return _gathered(t, self.data, self.group)

    def model_all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the model group, in place → `t`."""
        if self.model > 1:
            dist.all_reduce(t, group=self.model_group)
        return t

    def model_all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every model index's `t` (same shape and dtype), in order."""
        return _gathered(t, self.model, self.model_group)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Global rank `src`'s `t` on every rank, in place → `t`."""
        if self.world > 1:
            dist.broadcast(t, src)
        return t

    def barrier(self) -> None:
        """Wait for every rank of the world."""
        if self.world > 1:
            dist.barrier()


def _gathered(t: torch.Tensor, n: int, group) -> List[torch.Tensor]:
    if n == 1:
        return [t]
    out = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def make_mesh(spec: MeshSpec | None = None,
              device: torch.device | str = "cpu") -> Mesh:
    """The mesh over this run's processes (`distributed.world_size()`),
    one device each; `device` is this rank's. Raises `MeshSpec.resolve`'s
    ValueError when `spec` does not cover the processes. With a `model`
    axis every rank makes every subgroup, in the same order: first the T
    data groups, then the D model groups."""
    spec = (spec or MeshSpec()).resolve(distributed.world_size())
    device = torch.device(device)
    if spec.data * spec.model == 1:
        return Mesh(data=1, rank=distributed.rank(), device=device)
    rank = distributed.rank()
    d_n, t_n = spec.data, spec.model
    data_group = dist.group.WORLD if t_n == 1 else None
    model_group = None
    if t_n > 1:
        if d_n > 1:
            for m in range(t_n):
                g = distributed.new_group(d * t_n + m for d in range(d_n))
                if rank % t_n == m:
                    data_group = g
        for d in range(d_n):
            g = distributed.new_group(d * t_n + m for m in range(t_n))
            if rank // t_n == d:
                model_group = g
    return Mesh(data=d_n, rank=rank, device=device,
                backend=dist.get_backend(), group=data_group, model=t_n,
                model_group=model_group)


def local_rows(n_global: int, rank: int, n_ranks: int) -> slice:
    """Rank `rank`'s rows of a global batch of `n_global` rows split into
    `n_ranks` equal contiguous blocks (rank 0 first)."""
    if n_global % n_ranks:
        raise ValueError(f"global batch {n_global} not divisible by the "
                         f"mesh data axis ({n_ranks})")
    per = n_global // n_ranks
    return slice(rank * per, (rank + 1) * per)


def tp_shardings(shapes: Mapping[str, Sequence[int]], model: int,
                 min_size: int = TP_MIN_SIZE) -> Dict[str, bool]:
    """JAX's `tp_shardings` on the port's state: {state_dict key: sharded
    over `model`} for every key of `shapes` (full torch shapes; the
    moments and EMA copies share their parameter's key). A tensor is
    sharded when its flax shape's last dim is at least `min_size` and
    divides by `model`; that dim is torch dim 0 for every such tensor."""
    out = {}
    for key, shape in shapes.items():
        fshape = flax_shape(key, tuple(shape))
        out[key] = bool(model > 1 and len(fshape) >= 1
                        and fshape[-1] >= min_size
                        and fshape[-1] % model == 0)
    return out


def channel_slice(n: int, mesh: Mesh) -> slice:
    """This model index's block of `n` channels."""
    per = n // mesh.model
    return slice(mesh.model_rank * per, (mesh.model_rank + 1) * per)


def shard(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This model index's block of dim 0 of a full tensor (a copy)."""
    return t[channel_slice(t.shape[0], mesh)].clone()


def check_replicated(t: torch.Tensor, mesh: Mesh, what: str = "tensor"
                     ) -> str:
    """Raise ValueError unless every rank of the world holds the same
    bytes in `t` (its shape and dtype included) → the sha256 hex digest.
    One all-gather of the 32-byte digest; the tensor itself never moves."""
    h = hashlib.sha256(f"{tuple(t.shape)} {t.dtype}".encode())
    h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
             .numpy().tobytes())
    digest = h.digest()
    words = torch.from_numpy(np.frombuffer(digest, "<i8").copy()).to(
        mesh.device)
    seen = [w.cpu().numpy().tobytes()
            for w in _gathered(words, mesh.world, None)]
    differ = [r for r, d in enumerate(seen) if d != digest]
    if differ:
        raise ValueError(f"{what} differs between ranks: rank "
                         f"{mesh.rank}'s copy is not the one of rank(s) "
                         f"{differ}")
    return digest.hex()
