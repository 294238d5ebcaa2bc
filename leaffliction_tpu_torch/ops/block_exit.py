"""The exit of a residual block: `pool(drop(relu(shortcut + y * se)))`.

Every part is optional, and the models pass what their block has:

- `se`: the SE gate, a per-(image, channel) scale [N, C, 1, 1] in y's
  dtype (`models.leafcnn.SEBlock`);
- `shortcut`: the block's input or its projection, like y;
- `relu`: `torch.relu` of the sum;
- `drop`: spatial dropout (`Drop`: a mask [N, C, 1, 1] drawn by
  `models.leafcnn.dropout_mask`, and keep = 1 − rate), kept values
  divided by keep, as flax `Dropout` does;
- `pool`: a k×k/s max-pool (`Pool`), VALID (floored) or flax "SAME" with
  −inf padding (`ops.layout.pad_same`).

LeafCNN's `ResBlock` takes all five (no pool after stage 0 of the s2d
stem), the ResNet's `BasicBlock` the first three, its conv stem the pool
alone. The models reach the exit through this module's `block_exit`, the
one name a caller patches to run the twin instead (`chip_smoke.Decisions`
records and replays the twin's ReLU signs and max-pool picks).

Where it runs. A CUDA tensor takes the hand-written kernels of
`csrc/block_exit.cu` (`ops/kernels/block_exit.py`): where a gradient is
wanted, `_ExitKernel`, whose forward saves a one-byte pick a pooled element
(no int64 indices, no tensor before the pool: the backward rebuilds the
ReLU's sign from y, the shortcut and se); otherwise the forward kernel
alone. A CPU tensor takes the plain twin, `block_exit_plain`: the models'
eager expressions, so the CPU computes bit for bit what it computed
before, and which runs on any device for the tests. Nothing on the card
falls back to the twin; any other device raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from leaffliction_tpu_torch.ops.layout import channels_first, channels_last
from leaffliction_tpu_torch.ops.layout import pad_same


class Drop(NamedTuple):
    """Spatial dropout as the exit takes it: `mask` bool [N, C, 1, 1], True
    where the channel is kept, and `keep` = 1 − rate."""
    mask: torch.Tensor
    keep: float


class Pool(NamedTuple):
    """A k×k max-pool at stride s: `same` pads as flax "SAME" does, with
    −inf; otherwise VALID, the ragged edge cut off."""
    k: int
    s: int
    same: bool = False


def dropped(x: torch.Tensor, mask: torch.Tensor, keep: float
            ) -> torch.Tensor:
    """flax `Dropout`'s output: x / keep where `mask`, else 0."""
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def block_exit_plain(y: torch.Tensor, se: Optional[torch.Tensor] = None,
                     shortcut: Optional[torch.Tensor] = None,
                     relu: bool = True, drop: Optional[Drop] = None,
                     pool: Optional[Pool] = None) -> torch.Tensor:
    """The exit in plain PyTorch on any device: the twin of the kernels."""
    x = y if se is None else y * se
    if shortcut is not None:
        x = shortcut + x
    if relu:
        x = torch.relu(x)
    if drop is not None:
        x = dropped(x, drop.mask, drop.keep)
    if pool is None:
        return x
    if pool.same:
        x, pad = pad_same(x, pool.k, pool.s, value=float("-inf"))
        return F.max_pool2d(x, pool.k, pool.s, padding=pad)
    return F.max_pool2d(x, pool.k, pool.s)


def _kernels():
    """The card's wrappers (`ops/kernels/block_exit.py`), imported at first
    use: importing the models imports no kernel module."""
    from leaffliction_tpu_torch.ops.kernels import block_exit

    return block_exit


def _on_card(y, se, shortcut, relu, drop, pool, with_code):
    """(y and the shortcut as the kernels read them, the output in y's
    layout, the picks or None): the forward kernel on channels-last copies
    of a channels-first y or shortcut (counted), its output copied back."""
    kernels = _kernels()
    count = kernels.launches
    yc = channels_last(y, count, "block_exit")
    sc = None if shortcut is None else channels_last(shortcut, count,
                                                     "block_exit")
    out, code = kernels.forward(yc, se, sc, relu, drop, pool, with_code)
    return yc, sc, out if yc is y else channels_first(out, count), code


class _ExitKernel(torch.autograd.Function):
    """The exit on the card's kernels. Saves y where the ReLU or se reads
    it, the shortcut where the ReLU does, se, the dropout's mask and the
    pool's picks."""

    @staticmethod
    def forward(ctx, y, se, shortcut, relu, drop, pool):
        yc, sc, out, code = _on_card(y, se, shortcut, relu, drop, pool, True)
        ctx.save_for_backward(yc if relu or se is not None else None, se,
                              sc if relu else None, code,
                              None if drop is None else drop.mask)
        ctx.relu = relu
        ctx.keep = None if drop is None else drop.keep
        ctx.geometry = _kernels().geometry(yc, pool)
        ctx.copied = (yc is not y, sc is not shortcut)
        return out

    @staticmethod
    def backward(ctx, grad):
        y, se, sc, code, mask = ctx.saved_tensors
        kernels = _kernels()
        drop = None if mask is None else Drop(mask, ctx.keep)
        count = kernels.launches
        dy, dsc, dse = kernels.backward(
            channels_last(grad, count, "block_exit", gradient=True), code,
            ctx.geometry, y, se, sc, ctx.needs_input_grad[2], ctx.relu, drop)
        if ctx.copied[0]:
            dy = channels_first(dy, count)
        if dsc is not None and ctx.copied[1]:
            dsc = channels_first(dsc, count)
        return (dy, None if dse is None else dse.view(se.shape), dsc, None,
                None, None)


def block_exit(y: torch.Tensor, se: Optional[torch.Tensor] = None,
               shortcut: Optional[torch.Tensor] = None, relu: bool = True,
               drop: Optional[Drop] = None,
               pool: Optional[Pool] = None) -> torch.Tensor:
    """`pool(drop(relu(shortcut + y * se)))` of y [N, C, H, W], in y's dtype
    (module docstring). Differentiable in y, se and the shortcut. The
    card's kernels for a CUDA y, the twin for a CPU one."""
    if y.device.type == "cpu":
        return block_exit_plain(y, se, shortcut, relu, drop, pool)
    if y.device.type != "cuda":
        raise ValueError(f"block_exit: no path for device {y.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (y, se, shortcut)):
        return _ExitKernel.apply(y, se, shortcut, relu, drop, pool)
    return _on_card(y, se, shortcut, relu, drop, pool, False)[2]
