"""Training loop with the reference's callback semantics.

Port of `leaffliction_tpu/train/trainer.py`, single device:

- history keys loss/accuracy/val_loss/val_accuracy, one entry per epoch;
- ReduceLROnPlateau on val_loss (patience 3, ×0.3) through `lr_scale`;
- EarlyStopping on val_loss (patience 6) restoring the best weights;
- an optional stop once val_accuracy ≥ `target_val_acc`;
- after the loop, base and EMA weights are evaluated and the better one is
  kept (`srcs/train/utils.py:84-93`).

With `device_dataset=True` the decoded uint8 train and val sets are copied
to the device once and every step gathers its batch by index; otherwise each
batch's pixels are uploaded by `prefetch_to_device` (the streamed path):
after `skip_steps` and the chunking in `fit`, per batch in `evaluate`, and
on a mesh on this rank's own rows. `train_device_data`/`val_device_data`
hand in (images, labels) already on the device, as the fused balance path makes
them (`data/fused_balance.py`): the steps gather from those, and the stores
then hold no pixels (`DeviceImageStore`). Per-step metrics stay on the device until the
epoch ends (one copy to the host per epoch, plus one when a dispatch
crosses a multiple of `log_every` steps, for the log line). Best-weight
snapshots are clones, because the optimizer updates the weights in place.

Multi-step dispatch, as the JAX `fit(chain_steps=k)`: `chain_batches`
groups the epoch's batches into stacked chunks of k, the remainder left as
single batches. With k > 1 on the card (one process) a chunk is one replay
of a CUDA graph of k steps and a remainder batch one replay of the k = 1
graph (`train/graph.py`; a failed capture raises); on the CPU and on a
mesh the chunk's steps run eagerly (`StepFns.train_step_chain`, or
`train_step_gather` with `sel` [k, B]): a mesh's collectives go through
gloo or the host, which a graph cannot hold. k = 1 runs every step eagerly
(a single batch is a chunk of one).
The draws come from one sequential generator, so every grouping gives the
same steps. `step_callback` fires once a dispatch with `step_in_epoch`
counting the whole chunk, and the log line fires when a dispatch crosses a
multiple of `log_every` (JAX's rule), with the chunk's last loss.
`evaluate` on the device-resident path runs the whole val set as one
eager dispatch (`StepFns.eval_chain_gather`) and reads the host once; a
graph of it would not repay its capture in a run's evals (`train/graph.py`).

Mid-run resume follows `leaffliction_tpu/train/trainer.py:247-400`:
`start_epoch`, `history` (extended in place: the same dict object the
step meta captures), `skip_steps` (the first N batches of the first epoch
that runs are skipped before any upload or launch and do not count in its
metrics), `epoch_callback(epoch, state, history, generator)` after each
epoch's evaluation and `step_callback(epoch, step_in_epoch, state,
generator)` after each dispatch (`step_in_epoch` counts the skipped
steps). The skipped batches leave the stream before it is grouped: a chunk
wholly inside `skip_steps` is skipped, as in JAX, and with the k of the
interrupted run (whose checkpoints land on chunk boundaries) the chunks
are JAX's; a checkpoint saved under another k resumes at its own step
too, its epoch's chunks then starting there (JAX would rerun a chunk that
straddles it).
The augmentation and dropout come from one sequential generator, so a
resumed run hands in the saved state (`generator_state`) in place of the
seed. As in the JAX `fit`, the early-stop and plateau counters, the best
val_loss and the plateau multiplier start afresh on every call; only the
state's own `lr_scale` is carried in the checkpoint.

Spans (`core/trace.py`, recorded while a profiler runs): `trainer.epoch`
over each epoch, `trainer.dispatch` over each dispatch (graph or eager),
`trainer.epoch_end` over the epoch's blocking read of its metrics,
`trainer.evaluate` over each evaluation (the final base and EMA ones too)
and `trainer.callback` over each `step_callback` and `epoch_callback`.
Counters: `trainer.dispatches`, `trainer.steps` and `trainer.host_reads`
(the blocking device-to-host reads of `fit` and `evaluate`).

Data parallel (the step functions' mesh, `parallel/mesh.py`): each rank
runs this loop over its data index's rows (`local_batch` of the global
batch, or its own stride shard), the steps and `evaluate` return global
numbers, so the history, the plateau and early-stop decisions and
`target_val_acc` are the same on every rank and no rank takes a branch the
others skip. Tensor parallel, the ranks of a data index run the same rows
and every forward makes the model group's gathers; the best-weight
snapshots hold each rank's own blocks.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from leaffliction_tpu_torch.core import trace
from leaffliction_tpu_torch.core.logging import get_logger
from leaffliction_tpu_torch.data.loader import Batch, BatchIterator
from leaffliction_tpu_torch.train.config import TrainConfig
from leaffliction_tpu_torch.train.steps import StepFns, TrainState

LOGGER = get_logger(__name__)

DeviceData = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass
class FitResult:
    state: TrainState
    history: Dict[str, List[float]]
    best_variant: str          # "base" | "ema"
    val_accuracy: float        # of the saved variant
    epochs_ran: int
    steps_ran: int
    train_time_s: float
    images_per_sec: float
    generator_state: Optional[torch.Tensor] = None  # at the run's end


def put_dataset(store, device: torch.device) -> DeviceData:
    """uint8 images [N, S, S, 3] and int64 labels [N] on the device."""
    return (torch.from_numpy(store.images).to(device),
            torch.from_numpy(store.labels.astype(np.int64)).to(device))


def _device_rows(batch, device: torch.device):
    """(sel, mask) of a host batch for the gather path, uploaded without
    waiting for the device: a blocking copy would synchronise the stream
    once per step."""
    def put(a):
        return torch.from_numpy(a).to(device, non_blocking=True)

    return (put(np.asarray(batch.indices, np.int64)),
            put(np.asarray(batch.mask, np.float32)))


def _host_fields(batch: Batch) -> List[np.ndarray]:
    """The fields `prefetch_to_device` uploads, in the dtypes the steps
    take: uint8 images, int64 labels, f32 mask."""
    return [np.ascontiguousarray(batch.images, np.uint8),
            np.ascontiguousarray(batch.labels, np.int64),
            np.ascontiguousarray(batch.mask, np.float32)]


class _PinnedRing:
    """`prefetch_to_device`'s staging on a CUDA device: `slots` pinned host
    buffers used in turn, each batch's copies on a side stream and an event
    recorded after them. A slot is written again only after its last
    copy's event has completed."""

    _ALIGN = 256

    def __init__(self, device: torch.device, slots: int) -> None:
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.buffers: List[Optional[torch.Tensor]] = [None] * slots
        self.events: List[Optional[torch.cuda.Event]] = [None] * slots
        self.next = 0

    def put(self, batch: Batch) -> Tuple[Batch, torch.cuda.Event]:
        """Stage `batch`'s fields in the next slot and start their copies
        → (the batch with device tensors in place of them, host
        `indices` kept; the copies' event)."""
        slot = self.next
        self.next = (slot + 1) % len(self.buffers)
        if self.events[slot] is not None:
            self.events[slot].synchronize()  # its last copies are done
        fields = _host_fields(batch)
        offsets, size = [], 0
        for a in fields:
            offsets.append(size)
            size += -(-a.nbytes // self._ALIGN) * self._ALIGN
        buf = self.buffers[slot]
        if buf is None or buf.numel() < size:
            buf = self.buffers[slot] = torch.empty(size, dtype=torch.uint8,
                                                   pin_memory=True)
        staged = []
        for a, off in zip(fields, offsets):
            view = buf[off:off + a.nbytes].view(torch.from_numpy(a).dtype
                                                ).view(a.shape)
            np.copyto(view.numpy(), a)
            staged.append(view)
        with torch.cuda.stream(self.stream):
            out = [torch.empty(v.shape, dtype=v.dtype, device=self.device)
                   for v in staged]
            for dst, src in zip(out, staged):
                dst.copy_(src, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[slot] = event
        return Batch(*out, indices=batch.indices), event


def prefetch_to_device(batches: Iterable[Batch], mesh, lookahead: int = 2
                       ) -> Iterator[Batch]:
    """Upload host batches ahead of their use, as
    `leaffliction_tpu/train/trainer.py:prefetch_to_device`: the same
    batches in the same order, each as a `Batch` of device tensors (uint8
    images, int64 labels, f32 mask) with the host `indices`, `lookahead`
    batches in flight beyond the one handed over. `mesh` is a
    `parallel.mesh.Mesh` (its device) or a device; on a mesh the batches
    are this rank's own rows already (`local_batch`), as a JAX host's are
    its process-local data.

    On a CUDA device each batch goes through a ring of `lookahead + 1`
    pinned host buffers (`_PinnedRing`): copied on a side stream, the
    current stream waiting on the copies' event when the batch is handed
    over, and the tensors handed over recorded on that stream
    (`record_stream`), so the allocator keeps them until the consumer's
    work is done. There is no pageable fallback: a failure raises. On the
    CPU a batch is converted with no pinning and no copy."""
    device = torch.device(getattr(mesh, "device", mesh))
    if device.type != "cuda":
        for b in batches:
            images, labels, mask = map(torch.from_numpy, _host_fields(b))
            yield Batch(images.to(device), labels.to(device),
                        mask.to(device), b.indices)
        return
    ring = _PinnedRing(device, lookahead + 1)
    queue: collections.deque = collections.deque()
    it = iter(batches)
    for b in itertools.islice(it, lookahead):
        queue.append(ring.put(b))
    while queue:
        for b in itertools.islice(it, 1):
            queue.append(ring.put(b))
        batch, event = queue.popleft()
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for t in batch[:3]:
            t.record_stream(current)
        yield batch


def _device_of(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def local_batch(batch: Batch, mesh) -> Batch:
    """This rank's data index's rows (`parallel.mesh.local_rows`) of a
    global batch, or of each batch of a chained chunk; the batch itself
    without a mesh."""
    if mesh is None:
        return batch
    if np.ndim(batch.mask) == 2:
        rows = mesh.rows(batch.mask.shape[1])
        return Batch(*(a[:, rows] for a in batch))
    rows = mesh.rows(len(batch.mask))
    return Batch(*(a[rows] for a in batch))


def chain_batches(batches, k: int):
    """Group a batch stream into stacked chunks of k (images [k, B, S, S,
    3], labels, mask and indices [k, B]); the remainder passes as single
    batches. With k <= 1 the stream passes through untouched. A host copy
    of `leaffliction_tpu/train/trainer.py:chain_batches`."""
    if k <= 1:
        yield from batches
        return
    buf = []
    for b in batches:
        buf.append(b)
        if len(buf) == k:
            yield Batch(images=np.stack([x.images for x in buf]),
                        labels=np.stack([x.labels for x in buf]),
                        mask=np.stack([x.mask for x in buf]),
                        indices=np.stack([x.indices for x in buf]))
            buf = []
    yield from buf


def _gathered_preds(preds: List[torch.Tensor], mesh) -> np.ndarray:
    """The predictions of every eval batch, [K, B] with B the global batch,
    from each rank's [K, B / P] (one all-gather)."""
    mine = torch.stack(preds)
    parts = mesh.all_gather(mine) if mesh is not None else [mine]
    return torch.cat(parts, dim=1).cpu().numpy().astype(np.int32)


def evaluate(step_fns: StepFns, state: TrainState, val_iter: BatchIterator,
             use_ema: bool = False, collect_preds: bool = True,
             device_data: Optional[DeviceData] = None
             ) -> Tuple[float, float, np.ndarray, np.ndarray]:
    """→ (loss, accuracy, y_true, y_pred) over the whole masked val set,
    with one copy to the host at the end. On the device-resident path
    (`device_data`, one process) the whole set is one dispatch,
    `eval_chain_gather`, run eagerly. Data parallel (`step_fns`' mesh): `val_iter`
    yields global batches, each rank evaluates its rows batch by batch,
    the sums are all-reduced and the predictions all-gathered, so every
    rank returns the global numbers."""
    device = _device_of(state)
    mesh = getattr(step_fns, "data_mesh", None)
    batches = list(val_iter.epoch(0))
    if not batches:
        return 0.0, 0.0, np.zeros((0,), np.int32), np.zeros((0,), np.int32)
    if device_data is not None and mesh is None:
        sel = np.stack([np.asarray(b.indices, np.int64) for b in batches])
        msk = np.stack([np.asarray(b.mask, np.float32) for b in batches])
        m, preds = step_fns.eval_chain_gather(
            state, *device_data, torch.from_numpy(sel).to(device),
            torch.from_numpy(msk).to(device), use_ema)
        sums = torch.stack([m["loss_sum"], m["correct"], m["n"]]).sum(1)
        preds_all = list(preds)
    else:
        mine = [local_batch(batch, mesh) for batch in batches]
        if device_data is not None:
            results = (step_fns.eval_step_gather(
                state, *device_data, *_device_rows(b, device), use_ema)
                for b in mine)
        else:
            results = (step_fns.eval_step(state, b.images, b.labels, b.mask,
                                          use_ema)
                       for b in prefetch_to_device(mine, mesh or device))
        outs, preds_all = [], []
        for m, preds in results:
            outs.append(torch.stack([m["loss_sum"], m["correct"], m["n"]]))
            preds_all.append(preds)
        sums = torch.stack(outs).sum(0)
        if mesh is not None:
            mesh.all_reduce(sums)
    trace.count("trainer.host_reads")
    loss_sum, correct, n = sums.double().cpu().tolist()
    ys, ps = [], []
    if collect_preds:
        trace.count("trainer.host_reads")
        for batch, preds in zip(batches, _gathered_preds(preds_all, mesh)):
            keep = np.asarray(batch.mask) > 0
            ys.append(np.asarray(batch.labels)[keep])
            ps.append(preds[keep])
    y_true = np.concatenate(ys) if ys else np.zeros((0,), np.int32)
    y_pred = np.concatenate(ps) if ps else np.zeros((0,), np.int32)
    n = max(n, 1.0)
    return loss_sum / n, correct / n, y_true, y_pred


def _snapshot(state: TrainState) -> Tuple[Dict, Dict]:
    return ({k: v.detach().clone() for k, v in state.params.items()},
            {k: v.clone() for k, v in state.batch_stats.items()})


@torch.no_grad()
def _restore(state: TrainState, params: Dict, batch_stats: Dict) -> None:
    for live, saved in ((state.params, params),
                        (state.batch_stats, batch_stats)):
        for k, v in saved.items():
            live[k].copy_(v)


def fit(step_fns: StepFns, state: TrainState, train_iter: BatchIterator,
        val_iter: BatchIterator, cfg: TrainConfig, epochs: int, seed: int,
        target_val_acc: Optional[float] = None, log_every: int = 50,
        device_dataset: bool = False,
        train_device_data: Optional[DeviceData] = None,
        val_device_data: Optional[DeviceData] = None,
        start_epoch: int = 0,
        history: Optional[Dict[str, List[float]]] = None,
        epoch_callback=None, step_callback=None, skip_steps: int = 0,
        generator_state: Optional[torch.Tensor] = None,
        chain_steps: int = 1) -> FitResult:
    """Run the training loop; the random draws (augmentation, dropout) come
    from one `torch.Generator` on the device, seeded with `seed`, or set to
    `generator_state` when a resumed run hands one in. `chain_steps=k`
    runs k steps a dispatch (see the module docstring: CUDA graphs on the
    card, released when `fit` returns or raises). Data parallel
    (`step_fns`' mesh): the val iterator yields global batches, and so does
    the train iterator on the gather path (device-resident data), each step
    taking this rank's rows; on the streamed path the train iterator yields
    this rank's own batches (a stride shard padded to the global step
    count)."""
    device = _device_of(state)
    mesh = getattr(step_fns, "data_mesh", None)
    generator = torch.Generator(device=device)
    if generator_state is not None:
        generator.set_state(generator_state)
    else:
        generator.manual_seed(seed)
    train_dd = val_dd = None
    if train_device_data is not None:
        if val_device_data is None:
            raise ValueError("fit: train_device_data needs val_device_data")
        train_dd, val_dd = train_device_data, val_device_data
        LOGGER.info("Fused device-resident dataset: %.0f MB train + %.0f MB "
                    "val on %s", train_dd[0].nbytes / 1e6,
                    val_dd[0].nbytes / 1e6, device)
    elif device_dataset:
        train_dd = put_dataset(train_iter.store, device)
        val_dd = put_dataset(val_iter.store, device)
        LOGGER.info("Device-resident dataset: %.0f MB train + %.0f MB val "
                    "on %s", train_iter.store.images.nbytes / 1e6,
                    val_iter.store.images.nbytes / 1e6, device)
    own_rows = mesh if train_dd is not None else None
    if history is None:
        history = {"loss": [], "accuracy": [], "val_loss": [],
                   "val_accuracy": []}
    graphs = None
    if chain_steps > 1 and mesh is not None:
        LOGGER.info("Mesh: %d steps a dispatch, each run eagerly (a CUDA "
                    "graph cannot hold the mesh's collectives)", chain_steps)
    elif chain_steps > 1 and device.type == "cuda":
        from leaffliction_tpu_torch.train.graph import StepGraphs

        graphs = StepGraphs(step_fns, state, generator)

    def dispatch(batch: Batch) -> Dict[str, object]:
        """One dispatch of a chunk [k, B] (a single batch is a chunk of 1)
        → metrics [k]: host indices on the gather path, the device tensors
        of `prefetch_to_device` on the streamed one."""
        if batch.mask.ndim == 1:
            batch = Batch(*(a[None] for a in batch[:3]),
                          indices=np.asarray(batch.indices)[None])
        if train_dd is None:
            if graphs is not None:
                return graphs.train(batch, None)
            return step_fns.train_step_chain(state, batch.images,
                                             batch.labels, batch.mask,
                                             generator)
        chunk = local_batch(batch, own_rows)
        if graphs is not None:
            return graphs.train(chunk, train_dd)
        return step_fns.train_step_gather(
            state, *train_dd, *_device_rows(chunk, device), generator)

    def val(use_ema: bool = False):
        with trace.span("trainer.evaluate"):
            return evaluate(step_fns, state, val_iter, use_ema=use_ema,
                            collect_preds=False, device_data=val_dd)

    best_val_loss = float("inf")
    best = _snapshot(state)
    plateau_wait = early_wait = 0
    lr_scale = 1.0
    steps_ran = 0
    images_seen = 0.0
    epochs_ran = 0
    t0 = time.perf_counter()
    try:
        for epoch in range(start_epoch, epochs):
            with trace.span("trainer.epoch"):
                epochs_ran = epoch + 1
                pending = []
                # consumed before the checkpoint: the epoch's batch order is
                # fixed by its seed, so the rest follows unchanged
                skip = skip_steps if epoch == start_epoch else 0
                steps_in_epoch = skip
                stream = chain_batches(itertools.islice(
                    train_iter.epoch(epoch), skip, None), chain_steps)
                if train_dd is None:  # the streamed path: uploads ahead
                    stream = prefetch_to_device(stream, mesh or device)
                for batch in stream:
                    with trace.span("trainer.dispatch"):
                        m = dispatch(batch)
                    loss, n = m["loss"], m["n"]
                    prev = steps_ran
                    steps_ran += len(loss)
                    steps_in_epoch += len(loss)
                    trace.count("trainer.dispatches")
                    trace.count("trainer.steps", len(loss))
                    pending.append(torch.stack([loss * n, m["correct"], n],
                                               -1))
                    if step_callback is not None:
                        with trace.span("trainer.callback"):
                            step_callback(epoch, steps_in_epoch, state,
                                          generator)
                    if log_every and \
                            steps_ran // log_every > prev // log_every:
                        trace.count("trainer.host_reads")
                        LOGGER.info("step %d: loss=%.4f lr=%.2e", steps_ran,
                                    float(loss[-1]), m["lr"][-1])
                ep_loss, ep_correct, ep_n = 0.0, 0.0, 0.0
                if pending:
                    trace.count("trainer.host_reads")
                    with trace.span("trainer.epoch_end"):
                        ep_loss, ep_correct, ep_n = (
                            torch.cat(pending).sum(0).double().cpu().tolist())
                images_seen += ep_n

                val_loss, val_acc, _, _ = val()
                ep_n = max(ep_n, 1.0)
                history["loss"].append(ep_loss / ep_n)
                history["accuracy"].append(ep_correct / ep_n)
                history["val_loss"].append(val_loss)
                history["val_accuracy"].append(val_acc)
                LOGGER.info("epoch %d/%d: loss=%.4f acc=%.4f val_loss=%.4f "
                            "val_acc=%.4f", epoch + 1, epochs,
                            history["loss"][-1], history["accuracy"][-1],
                            val_loss, val_acc)
                if epoch_callback is not None:
                    with trace.span("trainer.callback"):
                        epoch_callback(epoch, state, history, generator)

                # EarlyStopping bookkeeping (min_delta=0, like Keras defaults)
                if val_loss < best_val_loss:
                    best_val_loss = val_loss
                    best = _snapshot(state)
                    early_wait = plateau_wait = 0
                else:
                    early_wait += 1
                    plateau_wait += 1

                if plateau_wait >= cfg.plateau_patience:
                    lr_scale *= cfg.plateau_factor
                    state.lr_scale = lr_scale
                    plateau_wait = 0
                    LOGGER.info("ReduceLROnPlateau: lr_scale -> %.4g",
                                lr_scale)

                if target_val_acc is not None and val_acc >= target_val_acc:
                    LOGGER.info("Target val_accuracy reached: %.4f >= %.4f; "
                                "stopping", val_acc, target_val_acc)
                    break

                if early_wait >= cfg.early_stop_patience:
                    LOGGER.info("EarlyStopping: restoring best weights "
                                "(val_loss=%.4f)", best_val_loss)
                    _restore(state, *best)
                    break

        train_time = time.perf_counter() - t0

        # base-vs-EMA winner selection (`srcs/train/utils.py:84-93`)
        _, base_acc, _, _ = val()
        best_variant, best_acc = "base", base_acc
        if cfg.ema_decay > 0:
            _, ema_acc, _, _ = val(use_ema=True)
            if ema_acc > base_acc:
                best_variant, best_acc = "ema", ema_acc
                _restore(state, state.ema_params, state.ema_batch_stats)
            LOGGER.info("Variant selection: base=%.4f ema=%.4f -> %s",
                        base_acc, ema_acc, best_variant)
    finally:
        if graphs is not None:
            graphs.close()

    return FitResult(state=state, history=history, best_variant=best_variant,
                     val_accuracy=float(best_acc), epochs_ran=epochs_ran,
                     steps_ran=steps_ran, train_time_s=train_time,
                     images_per_sec=images_seen / max(train_time, 1e-9),
                     generator_state=generator.get_state())
