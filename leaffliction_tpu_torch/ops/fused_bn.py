"""BatchNorm with flax's numerics, in eval and training mode.

Port of `leaffliction_tpu/ops/fused_bn.py` over NCHW (channels are dim 1):

- eval: `(x.float() − mean) · (rsqrt(var + eps) · scale) + bias` in f32,
  cast back to the module's compute dtype;
- training: `bn_train`, a `torch.autograd.Function` with the JAX package's
  custom VJP (`_bn_train_fwd_math` / `_bn_train_bwd`). Statistics are Σx and
  Σx² in f32, mean = Σx/M and the *biased* var = max(Σx²/M − mean², 0); the
  backward rebuilds x̂ from the saved input in two passes (dγ, dβ reduce,
  then dx). The module then moves its running statistics as
  `m·ra + (1 − m)·batch`, with the module's momentum m (0.99, LeafCNN's;
  the ResNet passes 0.9).

Data parallel (`group`): JAX runs one program over the global batch, so
its statistics are the global batch's. Here each rank all-reduces Σx and
Σx² (f32) before the mean and variance, with M the global count, and the
backward all-reduces Σdy and Σdy·x̂ before dx; dγ and dβ come back as this
rank's sums, because the step's gradient all-reduce adds them up (summed
here as well, they would count P times).

`nn.BatchNorm2d` / `F.batch_norm` are not used: they keep the unbiased
running variance, take the other momentum convention and compute the
variance by another formula. The JAX package's lane packing (`_pack_factor`,
`fold`) is a TPU layout and has no counterpart here. The passes are plain
PyTorch; a fused Hopper kernel for them is queued performance work.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn


def _c(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """[C] → broadcastable over channels-first [N, C, ...]."""
    return v.view((1, -1) + (1,) * (ndim - 2))


def _all_reduced(group, a: torch.Tensor, b: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σ a, Σ b) over `group`, in one all-reduce of [a, b]."""
    both = torch.cat([a, b])
    dist.all_reduce(both, group=group)
    return both[:a.numel()], both[a.numel():]


class _BNTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, group):
        xf = x.float()
        m = float(x.numel() // x.shape[1])
        dims = (0,) + tuple(range(2, x.dim()))
        s1 = xf.sum(dim=dims)
        s2 = (xf * xf).sum(dim=dims)
        if group is not None:
            # the global batch's moments: every rank holds as many rows
            s1, s2 = _all_reduced(group, s1, s2)
            m *= dist.get_world_size(group)
        mean = s1 / m
        var = torch.clamp_min(s2 / m - mean * mean, 0.0)
        inv = torch.rsqrt(var + eps)
        sf = scale.float()
        mul = inv * sf
        y = ((xf - _c(mean, x.dim())) * _c(mul, x.dim())
             + _c(bias.float(), x.dim())).to(x.dtype)
        ctx.save_for_backward(x, mean, inv, sf)
        ctx.m = m
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, inv, sf = ctx.saved_tensors
        nd = x.dim()
        dims = (0,) + tuple(range(2, nd))
        dyf = dy.float()
        xhat = (x.float() - _c(mean, nd)) * _c(inv, nd)
        # pass 1: dβ = Σ dy, dγ = Σ dy·x̂
        db = dyf.sum(dim=dims)
        dg = (dyf * xhat).sum(dim=dims)
        gdb, gdg = db, dg
        if ctx.group is not None:
            gdb, gdg = _all_reduced(ctx.group, db, dg)
        # pass 2: dx = γ·inv · (dy − dβ/M − x̂·dγ/M), over the global batch
        dx = (_c(sf * inv, nd) * (dyf - _c(gdb / ctx.m, nd)
                                  - xhat * _c(gdg / ctx.m, nd))).to(x.dtype)
        # this rank's dγ and dβ: the step's gradient all-reduce sums them
        return dx, dg, db, None, None


def bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float, group: Optional[dist.ProcessGroup] = None):
    """Training BatchNorm over channels-first x → (y in x.dtype, f32 batch
    mean [C], f32 biased batch var [C]). Differentiable in x, scale and
    bias; mean and var carry no gradient. With a data-parallel `group`,
    x is this rank's rows of a global batch (every rank the same count):
    the statistics and the backward's two sums are the global batch's
    (one all-reduce each way), and dγ, dβ are this rank's share."""
    return _BNTrain.apply(x, scale, bias, eps, group)


class BatchNorm(nn.Module):
    """BatchNorm over NCHW; same variables as the flax module: params
    `scale`/`bias`, batch_stats `mean`/`var` (buffers here). `momentum` m
    moves the running statistics as `m·ra + (1 − m)·batch`; `zero_scale`
    records flax's `scale_init=zeros` (the scale starts at 0, not 1, here
    and in `models.leafcnn.init_model`)."""

    def __init__(self, channels: int, epsilon: float = 1e-3,
                 dtype: torch.dtype = torch.float32, momentum: float = 0.99,
                 zero_scale: bool = False) -> None:
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.momentum = momentum
        self.zero_scale = zero_scale
        self.scale = nn.Parameter(torch.full((channels,),
                                             0.0 if zero_scale else 1.0))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False,
                group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
        if train:
            y, mean, var = bn_train(x, self.scale, self.bias, self.epsilon,
                                    group)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
            return y.to(self.dtype)
        nd = x.dim()
        mul = torch.rsqrt(self.var + self.epsilon) * self.scale.float()
        y = ((x.float() - _c(self.mean, nd)) * _c(mul, nd)
             + _c(self.bias.float(), nd))
        return y.to(self.dtype)
