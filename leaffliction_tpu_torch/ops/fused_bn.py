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

ReLU (`relu=True`): the models apply one right after most BatchNorms
(LeafCNN's `ConvBlock`, the ResNet stem and each block's first) and pass
it here: `relu(bn(x))` in the module's dtype, as `torch.relu` after the
BatchNorm gives it, and on the card one pass with it.

Where it runs. A CUDA tensor takes the hand-written kernels of
`csrc/batch_norm.cu` (`ops/kernels/batch_norm.py`): training is
`_BNTrainKernel`, four kernels (the statistics, whose finalisation also
moves the running statistics; the normalise with the ReLU; the backward's
two passes, which rebuild x̂ and the ReLU's mask from x and so save no
output), and eval is the normalise kernel on the running statistics. The
kernels read channels-last tensors, the layout the models hand over; a
channels-first contiguous input is copied in and its outputs copied back
(counted; `ops/layout.py`), and any other layout raises. A CPU
tensor takes the plain twin (`bn_train_plain`, `bn_eval_plain`: `_BNTrain`
and the eval arithmetic, then `torch.relu`), which runs on any device for
the tests. Nothing on the card falls back to the twin; any other device
raises.

`nn.BatchNorm2d` / `F.batch_norm` are not used: they keep the unbiased
running variance, take the other momentum convention and compute the
variance by another formula. The JAX package's lane packing (`_pack_factor`,
`fold`) is a TPU layout and has no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from leaffliction_tpu_torch.ops.layout import channels_first, channels_last


def _kernels():
    """The card's wrappers (`ops/kernels/batch_norm.py`), imported at first
    use: importing the models imports no kernel module."""
    from leaffliction_tpu_torch.ops.kernels import batch_norm

    return batch_norm


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
    """The plain twin of the training kernels."""

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


class _BNTrainKernel(torch.autograd.Function):
    """`_BNTrain` with the ReLU, on the card's kernels. `running` (the
    module's mean and var buffers, or None) moves by `momentum` in the
    statistics' finalisation. Saves x (channels-last, as the kernels read
    it), the batch mean and var, and the scale and bias (the backward
    derives inv and the ReLU's mask from them as the forward did)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, group, relu, running, momentum):
        kernels = _kernels()
        xc = channels_last(x, kernels.launches, "batch_norm")
        mean, var = kernels.moments(xc, group, running, momentum)
        y = kernels.normalize(xc, mean, var, scale, bias, eps, relu)
        ctx.save_for_backward(xc, mean, var, scale, bias)
        ctx.eps, ctx.group, ctx.relu = eps, group, relu
        ctx.copied = xc is not x
        ctx.mark_non_differentiable(mean, var)
        if ctx.copied:
            y = channels_first(y, kernels.launches)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, var, scale, bias = ctx.saved_tensors
        kernels = _kernels()
        dy = channels_last(dy, kernels.launches, "batch_norm", gradient=True)
        sums = kernels.grad_sums(x, dy, mean, var, scale, bias, ctx.eps,
                                 ctx.relu)
        total, count = sums, float(x.numel() // x.shape[1])
        if ctx.group is not None:
            total = sums.clone()
            dist.all_reduce(total, group=ctx.group)
            count *= dist.get_world_size(ctx.group)
        dx = kernels.grad_input(x, dy, mean, var, scale, bias, total,
                                ctx.eps, count, ctx.relu)
        if ctx.copied:
            dx = channels_first(dx, kernels.launches)
        # this rank's dγ and dβ: the step's gradient all-reduce sums them
        return dx, sums[1], sums[0], None, None, None, None, None


def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"BatchNorm: no path for device {x.device}")
    return x.device.type


def bn_train_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float, group: Optional[dist.ProcessGroup] = None,
                   relu: bool = False):
    """`bn_train` in plain PyTorch on any device: the twin of the training
    kernels."""
    y, mean, var = _BNTrain.apply(x, scale, bias, eps, group)
    return (torch.relu(y) if relu else y), mean, var


def bn_eval_plain(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                  scale: torch.Tensor, bias: torch.Tensor, eps: float,
                  dtype: torch.dtype, relu: bool = False) -> torch.Tensor:
    """Eval BatchNorm in plain PyTorch on any device, in f32 and cast to
    `dtype`: the twin of the normalise kernel on the running
    statistics."""
    nd = x.dim()
    mul = torch.rsqrt(var + eps) * scale.float()
    y = ((x.float() - _c(mean, nd)) * _c(mul, nd)
         + _c(bias.float(), nd)).to(dtype)
    return torch.relu(y) if relu else y


def bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float, group: Optional[dist.ProcessGroup] = None,
             relu: bool = False):
    """Training BatchNorm over channels-first x → (y in x.dtype, f32 batch
    mean [C], f32 biased batch var [C]), y ReLU'd with `relu`.
    Differentiable in x, scale and bias; mean and var carry no gradient.
    With a data-parallel `group`, x is this rank's rows of a global batch
    (every rank the same count): the statistics and the backward's two sums
    are the global batch's (one all-reduce each way), and dγ, dβ are this
    rank's share. The card's kernels for a CUDA x, the twin for a CPU
    one."""
    if _device_of(x) == "cuda":
        return _BNTrainKernel.apply(x, scale, bias, eps, group, relu, None,
                                    0.0)
    return bn_train_plain(x, scale, bias, eps, group, relu)


class BatchNorm(nn.Module):
    """BatchNorm over NCHW; same variables as the flax module: params
    `scale`/`bias`, batch_stats `mean`/`var` (buffers here). `momentum` m
    moves the running statistics as `m·ra + (1 − m)·batch`; `zero_scale`
    records flax's `scale_init=zeros` (the scale starts at 0, not 1, here
    and in `models.leafcnn.init_model`). `forward(..., relu=True)` is
    `torch.relu` of the output."""

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
                group: Optional[dist.ProcessGroup] = None,
                relu: bool = False) -> torch.Tensor:
        if _device_of(x) == "cuda":
            return self._on_card(x, train, group, relu).to(self.dtype)
        if not train:
            return bn_eval_plain(x, self.mean, self.var, self.scale,
                                 self.bias, self.epsilon, self.dtype, relu)
        y, mean, var = bn_train_plain(x, self.scale, self.bias, self.epsilon,
                                      group, relu)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1.0 - m) * mean)
            self.var.copy_(m * self.var + (1.0 - m) * var)
        return y.to(self.dtype)

    def _on_card(self, x: torch.Tensor, train: bool, group,
                 relu: bool) -> torch.Tensor:
        if train:
            return _BNTrainKernel.apply(x, self.scale, self.bias,
                                        self.epsilon, group, relu,
                                        (self.mean, self.var),
                                        self.momentum)[0]
        if torch.is_grad_enabled() and (x.requires_grad
                                        or self.scale.requires_grad
                                        or self.bias.requires_grad):
            raise RuntimeError("BatchNorm: the eval kernel has no backward; "
                               "run eval under torch.no_grad() or "
                               "torch.inference_mode()")
        # the twin computes in f32 and casts to the module's dtype: an f32
        # module's kernel takes the input widened (exactly)
        if self.dtype == torch.float32:
            x = x.float()
        kernels = _kernels()
        xc = channels_last(x, kernels.launches, "batch_norm")
        y = kernels.normalize(xc, self.mean, self.var, self.scale, self.bias,
                              self.epsilon, relu)
        return y if xc is x else channels_first(y, kernels.launches)
