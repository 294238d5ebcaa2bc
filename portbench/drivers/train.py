"""Driver of the `train` traffic kind: the train CLI's device-resident path
through `train.trainer.fit`, on a leaf-like set made from the seed.

Set-up makes the images and labels on the card (`images.py`), splits them
by the seed, makes the weights (`weights.py`) and builds one train state
in the port: its model with those weights, the step functions of the
configuration's optimizer preset and a cosine schedule over the
configuration's epochs. One `fit` call, with K-step dispatch, early
stopping off and more epochs than a window holds, then runs set-up and
window alike:

- its first epoch is set-up. It runs only the epoch's last K + R batches
  (`skip_steps`; R the epoch's remainder after its chunks of K): one
  K-step dispatch and R single steps, so it captures both CUDA graphs and
  warms every shape, then the epoch's evaluation;
- the window opens at that epoch's end and closes at the first epoch end
  past `--seconds`, each after a synchronise, so it holds whole epochs
  with their evaluations. A traced run profiles the window's first epoch.

What the comparison reads, all from that one `fit`:

- `start`: the state after the set-up epoch's K-step dispatch, the first
  steps from the benchmark's weights and the run's seed;
- `before` and `after`: the state at the window's opening, with the
  generator's state, and after the window's first K-step dispatch;
- `evals`: at the end of each of the window's first `compared_evals`
  epochs (the traffic's), the weights with the loss and accuracy that
  epoch's evaluation reported (a copy queued on the device, inside the
  window; the cap bounds what the copies add to the card's memory).

After the window the port's state is freed. The float32 reference
(`reference/step.py`) follows the first K steps from the weights and the
seed, and the window's first K steps from the port's state at the
window's opening, and evaluates each compared epoch's weights over the
validation set; the cell's limits judge the gaps (`numbers`).
"""

from __future__ import annotations

import dataclasses
import gc
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import devtrace, images, program, weights
from portbench.harness import Run, now, sub_seeds, sync
from portbench.reference import models, precision, step as ref_step

# the window's first epoch: the train iterator's epoch 1
WINDOW_EPOCH = 1


class _Stop(Exception):
    """Raised from a callback to end the `fit` call."""


@dataclasses.dataclass
class Data:
    """The training and validation sets on the device, and the weights."""

    train_images: torch.Tensor
    train_labels: torch.Tensor
    val_images: torch.Tensor
    val_labels: torch.Tensor
    weights: Dict[str, torch.Tensor]
    order_seed: int
    fit_seed: int


def make_data(cfg: dict, tr: dict, seed: int, device) -> Data:
    s_data, s_weights, s_order, s_fit = sub_seeds(seed, 4)
    gen = torch.Generator(device=device).manual_seed(s_data)
    k, n = cfg["num_classes"], tr["images"]
    labels = torch.randint(0, k, (n,), generator=gen, device=device)
    shifts = images.class_shifts(k, gen, device)
    pixels = images.leaf_images(labels, cfg["img_size"], shifts, gen)
    perm = torch.randperm(n, generator=gen, device=device)
    n_val = int(round(n * tr["val_share"]))
    val, train = perm[:n_val], perm[n_val:]
    wgen = torch.Generator(device=device).manual_seed(s_weights)
    train_images = pixels.index_select(0, train)
    w = weights.draw(cfg, train_images, wgen)
    return Data(train_images, labels.index_select(0, train),
                pixels.index_select(0, val), labels.index_select(0, val), w,
                s_order, s_fit)


def optimizer(cfg: dict, steps_per_epoch: int) -> ref_step.Optimizer:
    o = cfg["optimizer"]
    return ref_step.Optimizer(o["lr"], o["weight_decay"], o["clipnorm"],
                              o["label_smoothing"], o["ema_decay"],
                              cfg["epochs"] * steps_per_epoch)


@dataclasses.dataclass
class Plan:
    """The batches of the run: `steps` a full epoch, `k` a dispatch, the
    set-up epoch's first `skip` batches skipped."""

    n_train: int
    batch: int
    k: int

    @property
    def steps(self) -> int:
        return math.ceil(self.n_train / self.batch)

    @property
    def skip(self) -> int:
        return self.steps - self.k - self.steps % self.k

    def rows(self, order_seed: int, epoch: int, first: int, count: int
             ) -> List[torch.Tensor]:
        """The rows of batches [first, first + count) of an epoch: the
        train iterator's order (a permutation by `default_rng(seed +
        epoch)`)."""
        idx = np.arange(self.n_train)
        np.random.default_rng(order_seed + epoch).shuffle(idx)
        b = self.batch
        return [torch.from_numpy(idx[i * b:(i + 1) * b].copy())
                for i in range(first, first + count)]


@dataclasses.dataclass
class Evaluated:
    """An epoch's evaluation: the weights it ran on, and its loss and
    accuracy over the validation set."""

    weights: Dict[str, torch.Tensor]
    loss: float
    accuracy: float


@dataclasses.dataclass
class Seen:
    """What the port's `fit` left for the comparison (module docstring)."""

    start: ref_step.State
    before: ref_step.State
    after: ref_step.State
    evals: List[Evaluated]


def _copy(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    with torch.no_grad():
        return {k: v.detach().float().clone() for k, v in tensors.items()}


def _state(state, generator: Optional[torch.Generator] = None
           ) -> ref_step.State:
    """A float32 copy of the port's train state, keyed by its names."""
    return ref_step.State(
        _copy(state.model.state_dict()), _copy(state.mu), _copy(state.nu),
        {**_copy(state.ema_params), **_copy(state.ema_batch_stats)},
        int(state.step),
        generator.get_state() if generator is not None else None)


class Program:
    """The port's training objects for one run, on `data`."""

    def __init__(self, cfg: dict, tr: dict, data: Data, device) -> None:
        from leaffliction_tpu_torch.data.loader import (
            BatchIterator,
            DeviceImageStore,
        )
        from leaffliction_tpu_torch.train.config import TrainConfig
        from leaffliction_tpu_torch.train.steps import (
            build_step_fns,
            train_state_for,
        )

        self.cfg, self.tr, self.device = cfg, tr, device
        size = cfg["img_size"]
        batch = cfg["batch_size"]
        train_store = DeviceImageStore(data.train_labels.cpu().numpy(), size)
        val_store = DeviceImageStore(data.val_labels.cpu().numpy(), size)
        self.train_iter = BatchIterator(train_store, batch, shuffle=True,
                                        seed=data.order_seed)
        self.val_iter = BatchIterator(val_store, batch, shuffle=False)
        self.plan = Plan(len(data.train_labels), batch, tr["chain_steps"])
        if self.train_iter.steps_per_epoch() != self.plan.steps:
            raise RuntimeError("the train iterator's epoch is not the plan's")
        if self.plan.skip < 0:
            raise RuntimeError(f"an epoch of {self.plan.steps} steps holds "
                               f"no dispatch of {self.plan.k}")
        preset = getattr(TrainConfig, cfg["optimizer"]["preset"])()
        # early stopping off: the window must not end the run
        self.tcfg = dataclasses.replace(preset, early_stop_patience=10 ** 9)
        self.step_fns = build_step_fns(self.tcfg, cfg["num_classes"],
                                       cfg["epochs"] * self.plan.steps)
        self.state = train_state_for(program.model(cfg, data.weights,
                                                   device))
        self.train_dd = (data.train_images, data.train_labels)
        self.val_dd = (data.val_images, data.val_labels)
        self.seed = data.fit_seed

    def window(self, run: Run) -> Seen:
        """The one `fit` call: set-up epoch, then the window (module
        docstring)."""
        from leaffliction_tpu_torch.train.trainer import fit

        tracer = devtrace.Tracer(self.device) if run.trace else None
        win: Dict[str, float] = {}
        got: Dict[str, object] = {}
        evals: List[Evaluated] = []

        def on_step(epoch, step_in_epoch, state, generator):
            key = "start" if epoch < WINDOW_EPOCH else "after"
            if epoch <= WINDOW_EPOCH and key not in got:
                got[key] = _state(state)

        def on_epoch(epoch, state, history, generator):
            if "t0" not in win:
                got["before"] = _state(state, generator)
                sync(self.device)
                t = now()
                win.update(t0=t, epochs=0)
                run.setup_s = t - run.t0
                if tracer is not None:
                    tracer.start()
                return
            sync(self.device)
            t = now()
            win["epochs"] += 1
            if tracer is not None and win["epochs"] == 1:
                tracer.stop()
            if len(evals) < self.tr["compared_evals"]:
                evals.append(Evaluated(_copy(state.model.state_dict()),
                                       history["val_loss"][-1],
                                       history["val_accuracy"][-1]))
            if t - win["t0"] >= run.seconds:
                win["t1"] = t
                raise _Stop

        try:
            fit(self.step_fns, self.state, self.train_iter, self.val_iter,
                self.tcfg, epochs=self.cfg["epochs"], seed=self.seed,
                log_every=0, train_device_data=self.train_dd,
                val_device_data=self.val_dd, chain_steps=self.plan.k,
                skip_steps=self.plan.skip, epoch_callback=on_epoch,
                step_callback=on_step)
        except _Stop:
            pass
        if "t1" not in win:
            raise RuntimeError("the run's epochs ended inside the window")
        run.window_s = win["t1"] - win["t0"]
        run.images = win["epochs"] * self.plan.n_train
        run.attempted = win["epochs"] * self.plan.steps
        if tracer is not None:
            run.traced = tracer.read()
            run.counters["traced_rows"] = self.plan.steps * self.plan.batch
        return Seen(got["start"], got["before"], got["after"], evals)


def observe(r: Run, data: Data) -> Seen:
    """Set-up and the window of the port (on `data`), the peak memory
    read, and the port freed."""
    device = r.device
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    prog = Program(r.config, r.traffic, data, device)
    seen = prog.window(r)
    if device.type == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return seen


@dataclasses.dataclass
class Followed:
    """What one side produced from the same starting points: the state
    after the first K steps, after the window's first K steps, and each
    compared epoch's evaluation (loss, accuracy)."""

    start: ref_step.State
    after: ref_step.State
    evals: List[Tuple[float, float]]


def reference(cfg: dict, tr: dict, data: Data, seen: Seen, q=None,
              half: bool = False) -> Followed:
    """The float32 reference from the seed's weights and from the port's
    state at the window's opening (`q` rounds it to a lower precision for
    the control; `half` plants the half-batch fault: each batch's loss
    over its first half)."""
    q = q or precision.identity
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    plan = Plan(len(data.train_labels), cfg["batch_size"], tr["chain_steps"])
    opt = optimizer(cfg, plan.steps)
    loss_rows = plan.batch // 2 if half else 0
    device = data.train_images.device
    first = ref_step.start(cfg, data.weights, data.fit_seed, device)
    start = ref_step.follow(
        cfg, opt, first, data.train_images, data.train_labels,
        plan.rows(data.order_seed, 0, plan.skip, plan.k), q, loss_rows)
    # the state at the window's opening: the port's, with the step count
    # the set-up epoch ran
    before = dataclasses.replace(seen.before, step=plan.k
                                 + plan.steps % plan.k)
    after = ref_step.follow(
        cfg, opt, before, data.train_images, data.train_labels,
        plan.rows(data.order_seed, WINDOW_EPOCH, 0, plan.k), q, loss_rows)
    keep = None
    if half:
        keep = torch.arange(len(data.val_labels), device=device) \
            % plan.batch < plan.batch // 2
    evals = [ref_step.evaluate(cfg, e.weights, data.val_images,
                               data.val_labels, opt.label_smoothing, q, keep)
             for e in seen.evals]
    return Followed(start, after, evals)


def _norms(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([torch.linalg.vector_norm(t.double())
                        for t in tensors]).cpu()


def median_leaf(norms: torch.Tensor) -> float:
    """The median of the leaves that moved at all (leaves whose gradient
    is exactly zero would pull it to zero)."""
    moving = norms[norms > 0]
    return float(moving.median()) if len(moving) else 0.0


def leaf_gaps(prog: torch.Tensor, ref: torch.Tensor,
              keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each leaf's |‖program‖ − ‖reference‖| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    floor = median_leaf(ref)
    if keep is not None:
        prog, ref = prog[keep], ref[keep]
    return (prog - ref).abs() / torch.clamp_min(ref, floor)


def _moved(before: ref_step.State, after: ref_step.State, k: int,
           names: List[str], stats: List[str]) -> Dict[str, torch.Tensor]:
    """Per leaf, the norms of what K steps moved: the gradients as Adam's
    first moment took them (μ_after − b1^K·μ_before, the clipped
    gradients weighted as Adam weighs them), the parameters, the running
    statistics (only where the model has them) and the EMA."""
    decay = ref_step.B1 ** k
    out = {
        "grad": _norms([after.mu[n] - decay * before.mu[n] for n in names]),
        "change": _norms([after.weights[n] - before.weights[n]
                          for n in names]),
        "ema": _norms([after.ema[n] - before.ema[n] for n in names]),
    }
    if stats:
        out["stats"] = _norms([after.weights[n] - before.weights[n]
                               for n in stats])
    return out


def program_side(seen: Seen) -> Followed:
    return Followed(seen.start, seen.after,
                    [(e.loss, e.accuracy) for e in seen.evals])


def _rms(values) -> float:
    values = torch.as_tensor(values, dtype=torch.float64)
    return float(torch.sqrt(torch.mean(values ** 2)))


def numbers(cfg: dict, tr: dict, data: Data, seen: Seen, got: Followed,
            ref: Followed, detail: bool = False) -> Dict[str, object]:
    """The numbers a cell's limits judge, `got` against the float32
    reference `ref` (`PERF.md` gives the readings behind each):

    - over the window's first K-step dispatch, from the port's state at
      the window's opening, each leaf's gap of norms over the larger of
      the reference's norm of that leaf and of the median leaf, taken by
      the widest leaf (`*_gap`) and by the median leaf
      (`*_median_gap`): `grad` the gradients through Adam's first moment,
      `change` the parameters' change, `stats` the running statistics'
      change (a model with no running statistics has no `stats_*`
      numbers), `ema` the EMA's change. Parameters whose reference gradient
      is under a thousandth of the median leaf's move by round-off alone
      and are left out of the changes;
    - `start_change_gap` and `start_change_median_gap`: the parameters'
      change over the first K steps, from the benchmark's weights and the
      seed, by the widest and the median leaf;
    - `val_loss_gap` (relative) and `val_acc_gap` (absolute): the root
      mean square over the compared epochs of each evaluation's gap.

    `detail` adds the three widest leaves of each, by name."""
    names, stats = models.trainable(cfg), models.running(cfg)
    k = tr["chain_steps"]
    p = _moved(seen.before, got.after, k, names, stats)
    r = _moved(seen.before, ref.after, k, names, stats)
    moved = r["grad"] >= 1e-3 * median_leaf(r["grad"])
    gaps = {"grad": (leaf_gaps(p["grad"], r["grad"], r["grad"] > 0),
                     [n for n, m in zip(names, r["grad"] > 0) if m]),
            "change": (leaf_gaps(p["change"], r["change"], moved),
                       [n for n, m in zip(names, moved) if m])}
    if stats:
        gaps["stats"] = (leaf_gaps(p["stats"], r["stats"]), stats)
    gaps["ema"] = (leaf_gaps(p["ema"], r["ema"], moved),
                   [n for n, m in zip(names, moved) if m])
    first = ref_step.start(cfg, data.weights, data.fit_seed,
                           data.train_images.device)
    ps = _moved(first, got.start, k, names, stats)
    rs = _moved(first, ref.start, k, names, stats)
    start_moved = rs["grad"] >= 1e-3 * median_leaf(rs["grad"])
    out: Dict[str, object] = {}
    for key, (gap, _) in gaps.items():
        out[f"{key}_gap"] = float(gap.max())
        out[f"{key}_median_gap"] = float(gap.median())
    start = leaf_gaps(ps["change"], rs["change"], start_moved)
    out["start_change_gap"] = float(start.max())
    out["start_change_median_gap"] = float(start.median())
    pairs = list(zip(got.evals, ref.evals))
    out["val_loss_gap"] = _rms([(a[0] - b[0]) / b[0] for a, b in pairs])
    out["val_acc_gap"] = _rms([a[1] - b[1] for a, b in pairs])
    if detail:
        out["widest"] = {key: [(names_[i], float(gap[i]))
                               for i in torch.argsort(gap, descending=True)
                               [:3].tolist()]
                         for key, (gap, names_) in gaps.items()}
        out["val_losses"] = [[a[0], b[0]] for a, b in pairs]
    return out


def run(r: Run) -> None:
    cfg, tr = r.config, r.traffic
    data = make_data(cfg, tr, r.seed, r.device)
    seen = observe(r, data)
    ref = reference(cfg, tr, data, seen)
    got = numbers(cfg, tr, data, seen, program_side(seen), ref)
    unread = sorted(set(r.cell.limits) - set(got))
    if unread:
        raise RuntimeError(f"the limits of {r.cell.name} name numbers that "
                           f"this model does not give: {unread}")
    for name, value in got.items():
        if name in r.cell.limits:
            r.compare(name, value)


def readings(r: Run, detail: bool = False) -> Dict[str, Dict[str, object]]:
    """Every number of one run (`tools/readings.py`) for each side in the
    program's place: `program` the port; `control` the reference in the
    precision below the configuration's; `half_batch` the reference with
    the loss over half of each batch (and the evaluation over half of
    each of its batches). A state left unchanged reads 1 for the changes
    and needs no run."""
    cfg, tr = r.config, r.traffic
    data = make_data(cfg, tr, r.seed, r.device)
    seen = observe(r, data)
    ref = reference(cfg, tr, data, seen)
    low = precision.ROUNDINGS[precision.BELOW[cfg["compute_dtype"]]]
    return {
        "program": numbers(cfg, tr, data, seen, program_side(seen), ref,
                           detail),
        "control": numbers(cfg, tr, data, seen,
                           reference(cfg, tr, data, seen, q=low), ref,
                           detail),
        "half_batch": numbers(cfg, tr, data, seen,
                              reference(cfg, tr, data, seen, half=True),
                              ref, detail),
    }
