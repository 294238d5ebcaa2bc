"""Train and eval steps: augment → forward → loss → backward → update → EMA.

Port of `leaffliction_tpu/train/steps.py`. PyTorch runs eagerly, so a step
is a Python function over tensors on the state's device, not a compiled
program. It reads nothing from the host: the LR and Adam's two bias
corrections come in as a device row `hyper` = (lr, 1 − b1^c, 1 − b2^c), so
K steps (`StepFns.chain`) can be captured into one CUDA graph and replayed
(`train/graph.py`), JAX's `train_step_chain` on the card. The host fills a
[K, 3] table a dispatch (`hyper_table`), one copy; the single step runs the
same code through a K = 1 table. On a mesh
(`StepFns.mesh`) each rank runs the step on its rows of the global batch,
and with tensor parallelism on its channels (`parallel/tensor.py`), and
the collectives make it the JAX program's step over the whole batch (see
`StepFns`); a mesh's step runs eagerly (its collectives go through gloo or
the host, which a graph cannot hold). The state is
updated in place (parameters, BatchNorm statistics, optimizer moments, EMA)
where the JAX step returns a new tree; `TrainState.step` advances on the
host, by K a dispatch.

The optimizer is written by hand to optax's semantics (`make_optimizer`),
because torch's built-ins differ:

- `clip_by_global_norm(m)` keeps g where ‖g‖ < m, else g/‖g‖·m (torch's
  `clip_grad_norm_` divides by ‖g‖ + 1e-6);
- `scale_by_adam`: b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
  correction with the count incremented first;
- `add_decayed_weights(1e-4)` after Adam (AdamW), then p −= lr·u.

The FAST config is Adam with no clip, no decay, no EMA and integer-label CE.
The LR is cosine decay to 0 over `total_steps`, evaluated at the step count
before the update, times the plateau multiplier `lr_scale`; the table holds
it and the bias corrections rounded as the JAX step's f32 scalars are. The
Adam count is the step count (both start at 0 and move together in the JAX
state).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from leaffliction_tpu_torch.train.config import TrainConfig
from leaffliction_tpu_torch.models.leafcnn import init_model
from leaffliction_tpu_torch.ops.train_augment import train_augment_u8

B1, B2, EPS = 0.9, 0.999, 1e-8
Tensors = Dict[str, torch.Tensor]


def _is_norm(name: str) -> bool:
    return name in ("norm_mean", "norm_var")


@dataclasses.dataclass
class TrainState:
    """The model (params, BatchNorm statistics and norm_stats live in it),
    Adam's moments, EMA copies of params and BatchNorm statistics (distinct
    buffers), the step count and the ReduceLROnPlateau multiplier."""

    model: nn.Module
    mu: Tensors
    nu: Tensors
    ema_params: Tensors
    ema_batch_stats: Tensors
    step: int = 0
    lr_scale: float = 1.0
    # tensor parallel (`parallel/tensor.shard_train_state`): the mesh, and
    # for every key whether this rank holds only its block of channels
    tp: object = None
    sharded: Dict[str, bool] = dataclasses.field(default_factory=dict)

    @property
    def params(self) -> Tensors:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> Tensors:
        return {k: v for k, v in self.model.named_buffers()
                if not _is_norm(k)}


def create_train_state(model: nn.Module, seed: int,
                       device: torch.device | str) -> TrainState:
    """Fresh weights from `seed` (flax's initialisers, `init_model`: LeafCNN
    or LeafResNet) on `device`; see `train_state_for`."""
    return train_state_for(init_model(model, seed).to(device))


def train_state_for(model: nn.Module) -> TrainState:
    """The state for a model with its weights in place: zero moments, EMA
    copies of the params and BatchNorm statistics, step 0."""
    params = {k: v.detach() for k, v in model.named_parameters()}
    stats = {k: v for k, v in model.named_buffers() if not _is_norm(k)}
    return TrainState(
        model=model,
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
        ema_params={k: v.clone() for k, v in params.items()},
        ema_batch_stats={k: v.clone() for k, v in stats.items()},
    )


def make_lr_schedule(cfg: TrainConfig,
                     total_steps: int) -> Callable[[int], float]:
    """Cosine decay to 0 over total_steps (Keras CosineDecay alpha=0), or
    constant; f32 arithmetic as in the JAX schedule."""
    f32 = np.float32
    if not cfg.cosine_decay:
        return lambda step: float(f32(cfg.lr))

    def schedule(step: int) -> float:
        frac = np.clip(f32(step) / f32(max(total_steps, 1)), f32(0), f32(1))
        return float(f32(cfg.lr * 0.5)
                     * (f32(1.0) + np.cos(f32(np.pi) * frac)))

    return schedule


def loss_fn(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
            num_classes: int, label_smoothing: float,
            count: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked mean CE (targets (1−α)·onehot + α/K when α > 0) and the
    masked correct count. The denominator is max(Σmask, 1), or max(count,
    1) when given: a data-parallel step passes the global Σmask, so a
    rank's loss is its share of the global batch's mean."""
    logits = logits.float()
    if label_smoothing > 0:
        targets = ((1.0 - label_smoothing)
                   * F.one_hot(labels.long(), num_classes).float()
                   + label_smoothing / num_classes)
        per_ex = -(targets * torch.log_softmax(logits, -1)).sum(-1)
    else:
        per_ex = (torch.logsumexp(logits, -1)
                  - logits.gather(-1, labels.long()[:, None])[:, 0])
    denom = torch.clamp_min(mask.sum() if count is None else count, 1.0)
    loss = (per_ex * mask).sum() / denom
    correct = ((logits.argmax(-1) == labels).float() * mask).sum()
    return loss, correct


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        sharded: Optional[List[bool]] = None,
                        mesh=None) -> List[torch.Tensor]:
    """optax `clip_by_global_norm`: g if ‖g‖ < max_norm else g/‖g‖·max_norm,
    with no host sync. Tensor parallel (`sharded[i]`: grads[i] is this
    rank's block): ‖g‖² is the replicated gradients' squares once plus the
    model group's sum of the sharded blocks' squares."""
    if sharded is None or not any(sharded):
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    else:
        part = mesh.model_all_reduce(torch.stack(
            [torch.sum(g * g) for g, s in zip(grads, sharded) if s]).sum())
        g_norm = torch.sqrt(sum((torch.sum(g * g) for g, s in
                                 zip(grads, sharded) if not s), part))
    keep = g_norm < max_norm
    return [torch.where(keep, g, (g / g_norm) * max_norm) for g in grads]


def hyper_rows(steps, lr_scale: float, schedule: Callable[[int], float]
               ) -> np.ndarray:
    """[len(steps), 3] f32: the LR of each step (`schedule(step)` ×
    `lr_scale`) and Adam's bias corrections 1 − b1^c and 1 − b2^c at the
    count c = step + 1, each rounded to f32 as the JAX step's scalars
    are."""
    f32 = np.float32
    return np.asarray([(f32(schedule(s)) * f32(lr_scale),
                        f32(1.0) - f32(B1) ** f32(s + 1),
                        f32(1.0) - f32(B2) ** f32(s + 1)) for s in steps],
                      np.float32)


@torch.no_grad()
def apply_updates(params: List[torch.Tensor], grads: List[torch.Tensor],
                  mu: List[torch.Tensor], nu: List[torch.Tensor],
                  hyper: torch.Tensor, cfg: TrainConfig,
                  sharded: Optional[List[bool]] = None, mesh=None) -> None:
    """One optimizer step in place on aligned lists: [clip] → Adam → [decay]
    → p −= lr·u; mu and nu are updated in place too. `hyper` is the step's
    (lr, 1 − b1^c, 1 − b2^c) row on the params' device (`hyper_rows`), read
    there, so the step waits for nothing on the host. `sharded` and `mesh`:
    the clip's tensor-parallel norm."""
    if cfg.clipnorm > 0:
        grads = clip_by_global_norm(grads, cfg.clipnorm, sharded, mesh)
    lr, bc1, bc2 = hyper[0], hyper[1], hyper[2]
    new_mu = torch._foreach_add(torch._foreach_mul(grads, 1.0 - B1),
                                torch._foreach_mul(mu, B1))
    new_nu = torch._foreach_add(
        torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - B2),
        torch._foreach_mul(nu, B2))
    torch._foreach_copy_(mu, new_mu)
    torch._foreach_copy_(nu, new_nu)
    denom = torch._foreach_add(
        torch._foreach_sqrt(torch._foreach_div(new_nu, bc2)), EPS)
    updates = torch._foreach_div(torch._foreach_div(new_mu, bc1), denom)
    if cfg.optimizer == "adamw" and cfg.weight_decay > 0:
        updates = torch._foreach_add(
            updates, torch._foreach_mul(params, cfg.weight_decay))
    torch._foreach_sub_(params, torch._foreach_mul(updates, lr))


@torch.no_grad()
def update_ema(state: TrainState, decay: float) -> None:
    """e ← d·e + (1−d)·p over the new params and BatchNorm statistics."""
    for ema, live in ((state.ema_params, state.params),
                      (state.ema_batch_stats, state.batch_stats)):
        names = list(ema)
        e = [ema[k] for k in names]
        p = [live[k].detach() for k in names]
        torch._foreach_copy_(e, torch._foreach_add(
            torch._foreach_mul(e, decay), torch._foreach_mul(p, 1.0 - decay)))


def all_reduce_grads(grads: List[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Σ over the data group of every gradient (a sharded one is this
    rank's block, alike in shape on every rank of the group): one flat
    buffer and one all-reduce per dtype → the summed gradients, views of
    those buffers."""
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, g in enumerate(grads):
        by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = mesh.all_reduce(torch.cat([grads[i].reshape(-1)
                                          for i in idx]))
        for i, part in zip(idx, flat.split([grads[i].numel()
                                            for i in idx])):
            out[i] = part.view(grads[i].shape)
    return out


@dataclasses.dataclass
class StepFns:
    """The step functions for one model, config and schedule. With a
    `mesh` (`parallel.mesh.Mesh` of more than one rank) a train step takes
    this rank's rows of the global batch and computes what the one-device
    step computes on the global batch: draws for the global batch
    (`train_augment_u8`, `dropout`), BatchNorm over it, the loss over the
    global Σmask, the gradients summed over the data group before the
    clip, the update and the EMA, so the ranks of a model index hold the
    same state, bit for bit; `loss`, `correct` and `n` come back global.
    Tensor parallel (a sharded state, `parallel/tensor.py`), every rank
    holds its channels of the sharded tensors and all of the others, the
    model's layers make the model group's collectives, and the clip's
    norm adds the model group's share."""

    cfg: TrainConfig
    num_classes: int
    schedule: Callable[[int], float]
    augment: bool = True
    mesh: object = None

    @property
    def data_mesh(self):
        """The mesh when it has more than one rank (data × model), else
        None."""
        return self.mesh if self.mesh is not None and \
            self.mesh.data * self.mesh.model > 1 else None

    def hyper_table(self, state: TrainState, k: int) -> np.ndarray:
        """The [k, 3] f32 rows (`hyper_rows`) of the state's next k steps,
        at its `lr_scale`: a dispatch's one copy to the device."""
        return hyper_rows(range(state.step, state.step + k),
                          state.lr_scale, self.schedule)

    def _step(self, state: TrainState, images: torch.Tensor,
              labels: torch.Tensor, mask: torch.Tensor,
              generator: torch.Generator, hyper: torch.Tensor
              ) -> torch.Tensor:
        """One step on a uint8 N×H×W×3 batch with its `hyper` row, all on
        the state's device → (loss, correct, n) [3]. Reads nothing from the
        host and leaves `state.step` to the caller."""
        model, mesh = state.model, self.data_mesh
        if self.augment:
            x = train_augment_u8(generator, images, out_dtype=model.dtype,
                                 mesh=mesh)
        else:
            x = images.float() / 255.0
        n = mask.sum()
        if mesh is not None:
            n = mesh.all_reduce(n)
        logits = model(x, train=True, generator=generator, mesh=mesh)
        loss, correct = loss_fn(logits, labels, mask, self.num_classes,
                                self.cfg.label_smoothing, count=n)
        names = list(state.params)
        params = [state.params[k] for k in names]
        grads = list(torch.autograd.grad(loss, params))
        loss = loss.detach()
        if mesh is not None and mesh.data > 1:
            grads = all_reduce_grads(grads, mesh)
            loss, correct = mesh.all_reduce(torch.stack([loss, correct]))
        apply_updates(params, grads, [state.mu[k] for k in names],
                      [state.nu[k] for k in names], hyper, self.cfg,
                      sharded=[state.sharded.get(k, False) for k in names],
                      mesh=state.tp)
        if self.cfg.ema_decay > 0:
            update_ema(state, self.cfg.ema_decay)
        return torch.stack([loss, correct, n])

    def chain(self, state: TrainState, hyper: torch.Tensor,
              mask: torch.Tensor, generator: torch.Generator,
              images: Optional[torch.Tensor] = None,
              labels: Optional[torch.Tensor] = None,
              data: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              sel: Optional[torch.Tensor] = None) -> torch.Tensor:
        """K steps, all on the device: the batches `images` [K, B, S, S, 3]
        uint8 and `labels` [K, B], or the rows `sel` [K, B] of a
        device-resident dataset `data` (images, labels); `mask` [K, B] and
        `hyper` [K, 3] → (loss, correct, n) per step, [K, 3]. This is what
        a CUDA graph captures (`train/graph.py`); `state.step` is the
        caller's."""
        rows = []
        for i in range(mask.shape[0]):
            if sel is not None:
                im = data[0].index_select(0, sel[i])
                lb = data[1].index_select(0, sel[i])
            else:
                im, lb = images[i], labels[i]
            rows.append(self._step(state, im, lb, mask[i], generator,
                                   hyper[i]))
        return torch.stack(rows)

    def _dispatch(self, state: TrainState, generator: torch.Generator,
                  mask: torch.Tensor, **batches) -> Dict[str, object]:
        """One eager dispatch of K = mask.shape[0] steps: the table's one
        copy, `chain`, then the host step count → metrics stacked [K]
        (device) and the K LRs (host)."""
        k = mask.shape[0]
        table = self.hyper_table(state, k)
        hyper = torch.from_numpy(table).to(mask.device, non_blocking=True)
        out = self.chain(state, hyper, mask, generator, **batches)
        state.step += k
        return {"loss": out[:, 0], "correct": out[:, 1], "n": out[:, 2],
                "lr": table[:, 0]}

    def train_step(self, state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor, mask: torch.Tensor,
                   generator: torch.Generator) -> Dict[str, object]:
        """One step on a uint8 N×H×W×3 batch (on the state's device): the
        chain of one. Returns device tensors (loss, correct, n) and the host
        float lr."""
        m = self._dispatch(state, generator, mask[None], images=images[None],
                           labels=labels[None])
        return {"loss": m["loss"][0], "correct": m["correct"][0],
                "n": m["n"][0], "lr": float(m["lr"][0])}

    def train_step_chain(self, state: TrainState, images: torch.Tensor,
                         labels: torch.Tensor, mask: torch.Tensor,
                         generator: torch.Generator) -> Dict[str, object]:
        """K steps on images [K, B, S, S, 3] uint8, labels and mask [K, B],
        eagerly → loss, correct, n stacked [K] (device) and lr [K] (host):
        the same steps as K `train_step` calls, draws included."""
        return self._dispatch(state, generator, mask, images=images,
                              labels=labels)

    def train_step_gather(self, state: TrainState, data_images: torch.Tensor,
                          data_labels: torch.Tensor, sel: torch.Tensor,
                          mask: torch.Tensor, generator: torch.Generator
                          ) -> Dict[str, object]:
        """Steps on the rows `sel` of a device-resident uint8 dataset: one
        step for `sel` [B] (as `train_step`), K for `sel` [K, B] (as
        `train_step_chain`)."""
        if sel.dim() == 1:
            return self.train_step(state, data_images.index_select(0, sel),
                                   data_labels.index_select(0, sel), mask,
                                   generator)
        return self._dispatch(state, generator, mask,
                              data=(data_images, data_labels), sel=sel)

    @torch.no_grad()
    def eval_step(self, state: TrainState, images: torch.Tensor,
                  labels: torch.Tensor, mask: torch.Tensor,
                  use_ema: bool = False
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Eval on uint8 images (value/255, no augmentation) with the base
        or EMA weights → (loss_sum, correct, n on the device; preds)."""
        x = images.float() / 255.0
        if use_ema:
            logits = torch.func.functional_call(
                state.model, {**state.ema_params, **state.ema_batch_stats},
                (x,))
        else:
            logits = state.model(x)
        loss, correct = loss_fn(logits, labels, mask, self.num_classes,
                                self.cfg.label_smoothing)
        n = mask.sum()
        return ({"loss_sum": loss * torch.clamp_min(n, 1.0),
                 "correct": correct, "n": n}, logits.argmax(-1))

    def eval_step_gather(self, state: TrainState, data_images: torch.Tensor,
                         data_labels: torch.Tensor, sel: torch.Tensor,
                         mask: torch.Tensor, use_ema: bool = False):
        return self.eval_step(state, data_images.index_select(0, sel),
                              data_labels.index_select(0, sel), mask,
                              use_ema)

    def eval_chain_gather(self, state: TrainState, data_images: torch.Tensor,
                          data_labels: torch.Tensor, sel: torch.Tensor,
                          mask: torch.Tensor, use_ema: bool = False):
        """JAX's `eval_chain_gather`: the whole val set on the device, the
        rows `sel` [K, B] of a device-resident dataset with `mask` [K, B]
        → ({loss_sum, correct, n} stacked [K], preds [K, B])."""
        ms, preds = [], []
        for i in range(sel.shape[0]):
            m, p = self.eval_step_gather(state, data_images, data_labels,
                                         sel[i], mask[i], use_ema)
            ms.append(m)
            preds.append(p)
        return ({k: torch.stack([m[k] for m in ms])
                 for k in ("loss_sum", "correct", "n")}, torch.stack(preds))

    def eval_chain_ema_gather(self, state: TrainState,
                              data_images: torch.Tensor,
                              data_labels: torch.Tensor, sel: torch.Tensor,
                              mask: torch.Tensor):
        """`eval_chain_gather` with the EMA weights."""
        return self.eval_chain_gather(state, data_images, data_labels, sel,
                                      mask, use_ema=True)


def build_step_fns(cfg: TrainConfig, num_classes: int, total_steps: int,
                   augment: bool = True, mesh=None) -> StepFns:
    return StepFns(cfg, num_classes, make_lr_schedule(cfg, total_steps),
                   augment, mesh)
