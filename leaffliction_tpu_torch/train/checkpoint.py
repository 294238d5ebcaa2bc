"""Model export (`leaf_cnn.msgpack`) and mid-run resume checkpoints.

`flax.serialization.to_bytes` writes the variable tree as a msgpack map of
maps whose array leaves are msgpack ext type 1, each holding
`packb((shape, dtype name, C-order bytes))`. This module reads and writes
exactly that (`msgpack` is imported when a file is read or written), so
either package can load a model the other saved.

Resume checkpoints port `leaffliction_tpu/train/checkpoint.py:70-268` with
`torch.save` in place of orbax, in the same layout: `<ckpt_dir>/<id>/`
(here holding `state.pt`; epoch checkpoints are named by epoch, step
checkpoints by global step) and `step_meta_<id>.json` beside it
(`{"epoch", "step_in_epoch", "history"}`, written only after its checkpoint
has committed). A checkpoint holds everything a resumed run needs to
continue exactly: the model's `state_dict` (params, BatchNorm statistics,
`norm_mean`/`norm_var`), Adam's `mu` and `nu`, the EMA params and BatchNorm
statistics (all packed into one flat tensor a dtype, with each tensor's
place in it), `step`, `lr_scale`, and the state of the training generator
that draws the augmentation and dropout (one sequential generator, where
JAX folds a key per step, so a mid-epoch resume needs its state). A write
goes to `state.pt.tmp` and is renamed over `state.pt`, so a process killed
mid-write leaves the previous checkpoint as the latest; the newest two
checkpoints are kept.

Tensor parallel (a sharded state, `parallel/tensor.py`), a checkpoint is
the full state in the one-process layout: the save gathers every sharded
tensor over the model group (a collective: every rank of data index 0's
model group takes part, global rank 0 writes), and a restore slices each
one for this rank, so a checkpoint resumes on any mesh, one process
included.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from leaffliction_tpu_torch.core.logging import get_logger
from leaffliction_tpu_torch.parallel.tensor import (
    full_sections,
    shard_state_dict,
)

LOGGER = get_logger(__name__)

_EXT_NDARRAY = 1  # flax.serialization._MsgpackExtType.ndarray


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code != _EXT_NDARRAY:
        raise ValueError(f"unexpected msgpack ext type {code} in checkpoint")
    shape, name, buf = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buf, np.dtype(name.decode())).reshape(shape)


def load_model_msgpack(path: Path | str) -> Dict[str, Any]:
    """Raw nested dict of numpy arrays, as `flax.serialization.msgpack_restore`
    returns it."""
    import msgpack

    return msgpack.unpackb(Path(path).read_bytes(), ext_hook=_ext_hook,
                           raw=False)


def _ext_default(x):
    import msgpack

    if isinstance(x, np.ndarray):
        a = np.ascontiguousarray(x)
        payload = msgpack.packb((list(a.shape), a.dtype.name, a.tobytes("C")),
                                use_bin_type=True)
        return msgpack.ExtType(_EXT_NDARRAY, payload)
    raise TypeError(f"cannot serialise {type(x).__name__}")


def save_model_msgpack(path: Path | str, variables: Dict[str, Any]) -> None:
    """Write {params, batch_stats, norm_stats} of numpy arrays."""
    import msgpack

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(msgpack.packb(variables, default=_ext_default,
                                   strict_types=True))


# --- mid-run resume -------------------------------------------------------

STATE_FILE = "state.pt"
MAX_TO_KEEP = 2


_SECTIONS = ("model", "mu", "nu", "ema_params", "ema_batch_stats")


def _snapshot(state, generator: Optional[torch.Generator] = None
              ) -> Dict[str, Any]:
    """The checkpoint payload, its tensors still on the state's device:
    every tensor of the state copied on the current stream (no sync) into
    one flat buffer a dtype (`torch.cat`: for leafcnn-base one launch for
    266 tensors), each tensor's place in it (section, key, dtype, shape,
    offset), the host scalars and the generator's state (a CPU tensor on
    either device: CUDA's is seed and offset, read on the host). The file
    holds the same few buffers, so writing it is little Python work. A
    sharded state's tensors are gathered first (`full_sections`)."""
    sections = full_sections(state)
    groups: Dict[str, list] = {}
    sizes: Dict[str, int] = {}
    layout = []
    with torch.no_grad():
        for section in _SECTIONS:
            for key, t in sections[section].items():
                dt = str(t.dtype).removeprefix("torch.")
                offset = sizes.get(dt, 0)
                groups.setdefault(dt, []).append(t.detach().reshape(-1))
                sizes[dt] = offset + t.numel()
                layout.append((section, key, dt, list(t.shape), offset))
        flat = {dt: torch.cat(parts) for dt, parts in groups.items()}
    return {"flat": flat, "layout": layout, "step": int(state.step),
            "lr_scale": float(state.lr_scale),
            "generator": (None if generator is None
                          else generator.get_state())}


def _host_copy(snap: Dict[str, Any]) -> Dict[str, Any]:
    """`snap` with its flat buffers copied to the host (on a GPU: into
    pinned memory, one copy a dtype on the current stream, then that
    stream synchronised)."""
    host = {}
    for dt, flat in snap["flat"].items():
        if flat.is_cuda:
            buf = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            buf.copy_(flat, non_blocking=True)
            torch.cuda.current_stream(flat.device).synchronize()
        else:
            buf = flat.clone()
        host[dt] = buf
    return {**snap, "flat": host}


def _committed_steps(ckpt_dir: Path):
    """Ids of the committed checkpoints (a `<id>/state.pt`), ascending."""
    if not ckpt_dir.is_dir():
        return []
    return sorted(int(p.name) for p in ckpt_dir.iterdir()
                  if p.name.isdigit() and (p / STATE_FILE).is_file())


def _write(ckpt_dir: Path, step: int, payload: Dict[str, Any],
           max_to_keep: int = MAX_TO_KEEP) -> None:
    """Commit `payload` as checkpoint `step`, then drop all but the newest
    `max_to_keep` checkpoints."""
    d = Path(ckpt_dir) / str(step)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / (STATE_FILE + ".tmp")
    with tmp.open("wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, d / STATE_FILE)
    for old in _committed_steps(Path(ckpt_dir))[:-max_to_keep]:
        shutil.rmtree(Path(ckpt_dir) / str(old), ignore_errors=True)


def save_resume_checkpoint(ckpt_dir: Path, step: int, state,
                           generator: Optional[torch.Generator] = None
                           ) -> None:
    """Save a resume checkpoint `step` of `state` (and `generator`'s state),
    synchronously. A sharded state is gathered first: the other ranks of
    the model group call `full_sections(state)` meanwhile."""
    _write(Path(ckpt_dir), step, _host_copy(_snapshot(state, generator)))


def latest_resume_step(ckpt_dir: Path) -> Optional[int]:
    """The newest committed checkpoint's id, or None."""
    steps = _committed_steps(Path(ckpt_dir))
    return steps[-1] if steps else None


def restore_resume_checkpoint(ckpt_dir: Path, step: int, state
                              ) -> Tuple[Any, Optional[torch.Tensor]]:
    """Load checkpoint `step` into `state` in place (onto its device) →
    (state, the training generator's saved state or None). A sharded state
    takes its block of every sharded tensor."""
    device = next(state.model.parameters()).device
    data = torch.load(Path(ckpt_dir) / str(step) / STATE_FILE,
                      map_location=device, weights_only=True)
    saved: Dict[str, Dict[str, torch.Tensor]] = {n: {} for n in _SECTIONS}
    for section, key, dt, shape, offset in data["layout"]:
        n = int(np.prod(shape, dtype=np.int64))
        saved[section][key] = data["flat"][dt][offset:offset + n].view(
            shape)
    if getattr(state, "tp", None) is not None:
        saved = {name: shard_state_dict(t, state.sharded, state.tp)
                 for name, t in saved.items()}
    state.model.load_state_dict(saved["model"])
    with torch.no_grad():
        for name in _SECTIONS[1:]:
            live = getattr(state, name)
            if live.keys() != saved[name].keys():
                raise KeyError(f"checkpoint {step}: {name} has other "
                               "tensors than the state")
            for k, v in saved[name].items():
                live[k].copy_(v)
    state.step = int(data["step"])
    state.lr_scale = float(data["lr_scale"])
    gen = data["generator"]
    return state, None if gen is None else gen.cpu()


def step_meta_path(ckpt_dir: Path, step: int) -> Path:
    return Path(ckpt_dir) / f"step_meta_{step}.json"


def read_step_meta(ckpt_dir: Path, step: int) -> Optional[Dict]:
    """→ {"epoch", "step_in_epoch", "history"} for a step checkpoint, or
    None for an epoch checkpoint (whose id is the epoch)."""
    p = step_meta_path(ckpt_dir, step)
    if not p.exists():
        return None
    return json.loads(p.read_text())


class AsyncStepCheckpointer:
    """Resume checkpoints every N steps, off the training thread.

    `maybe_save` keeps the JAX package's single-process cadence: it skips
    while fewer than N steps have passed since the last save, and skips
    when the previous save is still in flight. It never waits for the
    device: it copies the state's tensors on the current stream (one flat
    buffer a dtype, `_snapshot`), reads the generator's state on the host,
    records an event and hands them to one worker thread. The worker waits
    for the event, copies the buffers to pinned host memory on a side
    stream and commits the checkpoint, then its step meta. The buffers
    stay referenced until their copy has finished, so the caching
    allocator cannot give their memory to a later step meanwhile. A failed
    save raises at the next save `maybe_save` would schedule, or from
    `close()`, which waits for the save in flight.

    Data parallel (`mesh`, `parallel.mesh.Mesh`): the ranks' states are the
    same, bit for bit, so only rank 0 saves and the save holds no
    collective; on every other rank `maybe_save` does nothing. `close()`
    ends with a barrier on every rank, so no rank leaves before rank 0's
    last save has committed. Tensor parallel (`mesh.model` > 1), the
    snapshot gathers over data index 0's model group, so its T ranks
    decide alike: when the cadence fires, rank 0 broadcasts its decision
    (skip while a save is in flight) over that group, all of them gather,
    and rank 0 alone keeps the snapshot; the other data indices do
    nothing.
    """

    def __init__(self, ckpt_dir: Path, every_steps: int,
                 max_to_keep: int = MAX_TO_KEEP, mesh=None) -> None:
        self.mesh = mesh
        self.writer = mesh is None or mesh.rank == 0
        self.gathers = mesh is not None and mesh.model > 1 \
            and mesh.data_rank == 0
        self.ckpt_dir = Path(ckpt_dir).resolve()
        self.every_steps = max(1, int(every_steps))
        self.max_to_keep = max_to_keep
        self._pool = cf.ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="ckpt")
        self._inflight: Optional[cf.Future] = None
        self._last_saved = -1
        self._stream = None

    def maybe_save(self, global_step: int, state, meta: Dict,
                   generator: Optional[torch.Generator] = None) -> bool:
        """Snapshot and schedule a save if the cadence fires → True when a
        save was scheduled."""
        if not (self.writer or self.gathers) or \
                global_step - self._last_saved < self.every_steps:
            return False
        busy = self.writer and self._inflight is not None \
            and not self._inflight.done()
        if self.gathers:  # rank 0's decision, on every rank that gathers
            flag = torch.tensor([int(busy)], device=self.mesh.device)
            dist.broadcast(flag, 0, group=self.mesh.model_group)
            busy = bool(flag.item())
        if busy:
            return False
        if not self.writer:  # a gathering rank: its part, then nothing
            full_sections(state)
            self._last_saved = global_step
            return False
        if self._inflight is not None:
            self._inflight.result()  # a failed save raises here
        snap = _snapshot(state, generator)
        event = None
        device = next(state.model.parameters()).device
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        # the history grows at each epoch's end: keep it as it is now
        meta = json.loads(json.dumps(meta))
        self._last_saved = global_step
        self._inflight = self._pool.submit(self._save, global_step, snap,
                                           event, device, meta)
        return True

    def _save(self, step: int, snap: Dict[str, Any], event, device,
              meta: Dict) -> None:
        if event is not None:
            event.synchronize()
            if self._stream is None:
                self._stream = torch.cuda.Stream(device)
            with torch.cuda.stream(self._stream):
                host = _host_copy(snap)
        else:
            host = _host_copy(snap)
        del snap  # the copies are done: release the clones
        _write(self.ckpt_dir, step, host, self.max_to_keep)
        tmp = step_meta_path(self.ckpt_dir, step).with_suffix(".tmp")
        tmp.write_text(json.dumps(meta))
        tmp.replace(step_meta_path(self.ckpt_dir, step))
        live = set(_committed_steps(self.ckpt_dir))
        for p in self.ckpt_dir.glob("step_meta_*.json"):
            stem = p.stem.rsplit("_", 1)[1]
            if stem.isdigit() and int(stem) not in live:
                p.unlink(missing_ok=True)
        LOGGER.info("Async checkpoint saved at step %d", step)

    def busy(self) -> bool:
        return self._inflight is not None and not self._inflight.done()

    def close(self) -> None:
        """Wait for the save in flight (raising its exception, if any),
        stop the worker and, data parallel, wait for every rank."""
        try:
            if self._inflight is not None:
                self._inflight.result()
        finally:
            self._pool.shutdown(wait=True)
            if self.mesh is not None:
                self.mesh.barrier()
