"""The training step and the evaluation in plain float32 PyTorch.

One step: augment the uint8 batch (`augment.py`), forward in training mode
with dropout, cross-entropy with label smoothing over the masked rows,
gradients by autograd, then the Leaffliction reference's REGULARIZED
optimizer as optax composes it: clip by global norm (g·m/‖g‖ where
‖g‖ ≥ m), Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
corrections at the count after the increment), decoupled weight decay
added to the update and p −= lr·u. Each BatchNorm then moves its running
statistics as m·r + (1 − m)·batch (the batch's biased variance; a model
with no running statistics moves none and has no m), and the
EMA of the weights and statistics moves as d·e + (1 − d)·new. The LR is a
cosine decay to 0 over the run's steps, read at the step count before the
update. The random draws come from a generator on the images' device, in
the order the step makes them: the augmentation's [3, n] draw, then each
dropout mask as the forward reaches it.

The evaluation: the eval-mode forward of value/255 (no augmentation) over
a whole set, the mean label-smoothed cross-entropy and the accuracy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import augment, models

B1, B2, EPS = 0.9, 0.999, 1e-8
Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class Optimizer:
    lr: float
    weight_decay: float
    clipnorm: float
    label_smoothing: float
    ema_decay: float
    total_steps: int

    def lr_at(self, step: int) -> float:
        frac = min(max(step / max(self.total_steps, 1), 0.0), 1.0)
        return self.lr * 0.5 * (1.0 + math.cos(math.pi * frac))


@dataclasses.dataclass
class State:
    """A training state: the weights (parameters and BatchNorm statistics,
    keyed by the port's names), Adam's moments, the EMA of the parameters
    and statistics, the step count and the generator's state."""

    weights: Tensors
    mu: Tensors
    nu: Tensors
    ema: Tensors
    step: int
    generator_state: Optional[torch.Tensor] = None


def start(cfg: dict, weights: Tensors, seed: int, device) -> State:
    """A fresh state: zero moments, the EMA at the weights, step 0, the
    generator seeded with `seed`."""
    names = models.trainable(cfg)
    w = {k: v.detach().float().clone() for k, v in weights.items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    return State(w, {k: torch.zeros_like(w[k]) for k in names},
                 {k: torch.zeros_like(w[k]) for k in names},
                 {k: w[k].clone() for k in names + models.running(cfg)},
                 0, gen.get_state())


def loss_fn(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
            smoothing: float) -> torch.Tensor:
    return (per_example_loss(logits, labels, smoothing) * mask).sum() \
        / mask.sum().clamp_min(1.0)


def per_example_loss(logits: torch.Tensor, labels: torch.Tensor,
                     smoothing: float) -> torch.Tensor:
    k = logits.shape[-1]
    targets = (1.0 - smoothing) * F.one_hot(labels.long(), k).float() \
        + smoothing / k
    return -(targets * torch.log_softmax(logits.float(), -1)).sum(-1)


def follow(cfg: dict, opt: Optimizer, state: State, images_u8: torch.Tensor,
           labels: torch.Tensor, batches: Sequence[torch.Tensor],
           q=models._ident, loss_rows: int = 0) -> State:
    """Run `len(batches)` steps from `state` on the rows `batches[i]` of
    `images_u8` (uint8 N×S×S×3 on the device) with their `labels` → the
    state after them (`state` is left as it was). `loss_rows` > 0 counts
    only a batch's first rows in the loss (a planted fault)."""
    names = models.trainable(cfg)
    stat_names = models.running(cfg)
    momentum = models.bn_momentum(cfg) if stat_names else None
    w = {k: v.detach().float().clone() for k, v in state.weights.items()}
    mu = {k: v.clone() for k, v in state.mu.items()}
    nu = {k: v.clone() for k, v in state.nu.items()}
    ema = {k: v.clone() for k, v in state.ema.items()}
    device = images_u8.device
    gen = torch.Generator(device=device)
    gen.set_state(state.generator_state)
    for t, rows in enumerate(batches):
        step = state.step + t
        rows = rows.to(device)
        flip, angles, factors = augment.draws(len(rows), gen, device)
        x = augment.augment(images_u8.index_select(0, rows), flip, angles,
                            factors)
        for k in names:
            w[k].requires_grad_(True)
        stats: Tensors = {}
        logits = models.forward(cfg, w, x,
                                models.Context(True, gen, q=q, stats=stats))
        mask = torch.ones(len(rows), device=device)
        if loss_rows:
            mask[loss_rows:] = 0.0
        loss = loss_fn(logits, labels.index_select(0, rows), mask,
                       opt.label_smoothing)
        grads = torch.autograd.grad(loss, [w[k] for k in names])
        with torch.no_grad():
            for k in names:
                w[k] = w[k].detach()
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            if opt.clipnorm > 0 and float(norm) >= opt.clipnorm:
                grads = [g / norm * opt.clipnorm for g in grads]
            lr = opt.lr_at(step)
            c = step + 1
            for k, g in zip(names, grads):
                mu[k] = B1 * mu[k] + (1 - B1) * g
                nu[k] = B2 * nu[k] + (1 - B2) * g * g
                u = (mu[k] / (1 - B1 ** c)) / (
                    torch.sqrt(nu[k] / (1 - B2 ** c)) + EPS)
                w[k] = w[k] - lr * (u + opt.weight_decay * w[k])
            for k in stat_names:
                w[k] = momentum * w[k] + (1 - momentum) * stats[k]
            for k in ema:
                ema[k] = opt.ema_decay * ema[k] + (1 - opt.ema_decay) * w[k]
    return State(w, mu, nu, ema, state.step + len(batches), gen.get_state())


@torch.no_grad()
def evaluate(cfg: dict, weights: Tensors, images_u8: torch.Tensor,
             labels: torch.Tensor, smoothing: float, q=models._ident,
             keep: Optional[torch.Tensor] = None, block: int = 128
             ) -> Tuple[float, float]:
    """(mean loss, accuracy) of the eval-mode forward over the whole set,
    in blocks of `block` images; `keep` (bool per image) counts only those
    images (a planted fault)."""
    w = {k: v.float() for k, v in weights.items()}
    losses, hits = [], []
    for s in range(0, len(labels), block):
        x = images_u8[s:s + block].float() / 255.0
        logits = models.forward(cfg, w, x, models.Context(False, q=q))
        lab = labels[s:s + block]
        losses.append(per_example_loss(logits, lab, smoothing).double())
        hits.append((logits.argmax(-1) == lab).double())
    loss, hit = torch.cat(losses), torch.cat(hits)
    if keep is not None:
        loss, hit = loss[keep], hit[keep]
    return float(loss.mean()), float(hit.mean())
