"""The plain float32 reference's shared pieces, and the entry points that
find a configuration's model by its `arch` (`portbench/arch.py`): the
model itself, its `layout` and its `forward`, is `reference/archs/<arch>.py`.

A model is a function of a flat dict of tensors whose names are the
port's state-dict keys, so that the one set of weights the benchmark makes
loads into either side. Everything runs in float32 with plain PyTorch ops
and autograd; `q` rounds every activation where the port's bf16 model
holds it in its compute dtype and the weights of every conv and dense
layer: that is where a control computed in a lower precision than the
configuration's differs from this reference (`precision.py`). Convs and
pools pad as "SAME" (total max((ceil(n/s) - 1)·s + k - n, 0), the smaller
half before). BatchNorm in training mode normalises with the batch mean
and biased variance and hands them to the caller (`Context.stats`), which
moves the running statistics with the model's momentum (`bn_momentum`).
Every random draw of a forward is a `dropout` mask, so a `Context` with
`dropout` off draws none (the FLOP count, `flops.py`).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench import arch

Tensors = Dict[str, torch.Tensor]


def _ident(x: torch.Tensor) -> torch.Tensor:
    return x


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0
             ) -> torch.Tensor:
    (ht, hb), (wl, wr) = (same_pads(n, k, stride) for n in x.shape[-2:])
    return F.pad(x, (wl, wr, ht, hb), value=value)


# --- parameter shapes -----------------------------------------------------


def conv_layout(name: str, cin: int, cout: int, k: int, bias: bool = False):
    yield f"{name}.weight", (cout, cin, k, k), "conv"
    if bias:
        yield f"{name}.bias", (cout,), "bias"


def bn_layout(name: str, c: int, zero_scale: bool = False):
    yield f"{name}.scale", (c,), "zero_scale" if zero_scale else "scale"
    yield f"{name}.bias", (c,), "bias"
    yield f"{name}.mean", (c,), "mean"
    yield f"{name}.var", (c,), "var"


def se_layout(name: str, c: int):
    mid = max(c // 8, 1)
    yield from conv_layout(f"{name}.Conv_0", c, mid, 1, bias=True)
    yield from conv_layout(f"{name}.Conv_1", mid, c, 1, bias=True)


def input_layout():
    """The input's fixed channel statistics (`standardise`)."""
    yield "norm_mean", (3,), "norm_mean"
    yield "norm_var", (3,), "norm_var"


def head_layout(cin: int, num_classes: int):
    """The dense head (`head`)."""
    yield "Dense_0.weight", (num_classes, cin), "dense"
    yield "Dense_0.bias", (num_classes,), "bias"


def _arch(cfg: dict):
    return arch.load(cfg["arch"], "reference")


def layout(cfg: dict) -> Iterator[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of the configuration's model,
    in the port's state-dict order (the arch's `layout`); kind is conv,
    dense, bias, scale, zero_scale, mean, var or norm_mean / norm_var
    (`weights.py` draws each)."""
    yield from _arch(cfg).layout(cfg)


def trainable(cfg: dict) -> list:
    """Names of the parameters (what the optimizer updates), in order."""
    return [n for n, _, kind in layout(cfg)
            if kind not in ("mean", "var", "norm_mean", "norm_var")]


def running(cfg: dict) -> list:
    """Names of the BatchNorm running statistics, in order (none for a
    model without them)."""
    return [n for n, _, kind in layout(cfg) if kind in ("mean", "var")]


def bn_momentum(cfg: dict) -> float:
    """The arch's running-statistics momentum (`BN_MOMENTUM`), which only a
    model with running statistics has."""
    return _arch(cfg).BN_MOMENTUM


# --- forward ----------------------------------------------------------------


class Context:
    """What one forward needs besides the weights: training or eval mode,
    the generator the dropout masks are drawn from (in the port's order),
    the operand rounding `q`, optionally a dict that receives each
    BatchNorm's batch mean and biased variance (BatchNorm then normalises
    with them, in either mode), and `dropout`: False makes every dropout
    the identity, so the forward draws nothing (the FLOP count)."""

    def __init__(self, train: bool, generator: Optional[torch.Generator]
                 = None, q: Callable = _ident,
                 stats: Optional[Tensors] = None, dropout: bool = True
                 ) -> None:
        self.train, self.generator, self.q, self.stats, self.dropout = \
            train, generator, q, stats, dropout


def conv(ctx: Context, w: Tensors, name: str, x: torch.Tensor,
         stride: int = 1) -> torch.Tensor:
    weight = w[f"{name}.weight"]
    x = pad_same(x, weight.shape[-1], stride)
    y = F.conv2d(ctx.q(x), ctx.q(weight), stride=stride)
    bias = w.get(f"{name}.bias")
    return ctx.q(y if bias is None else y + bias.view(1, -1, 1, 1))


def batchnorm(ctx: Context, w: Tensors, name: str, x: torch.Tensor,
              eps: float) -> torch.Tensor:
    if ctx.train or ctx.stats is not None:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        if ctx.stats is not None:
            ctx.stats[f"{name}.mean"] = mean.detach()
            ctx.stats[f"{name}.var"] = var.detach()
    else:
        mean, var = w[f"{name}.mean"], w[f"{name}.var"]
    scale = w[f"{name}.scale"] * torch.rsqrt(var + eps)
    return ctx.q((x - mean.view(1, -1, 1, 1)) * scale.view(1, -1, 1, 1)
                 + w[f"{name}.bias"].view(1, -1, 1, 1))


def dropout(ctx: Context, x: torch.Tensor, rate: float,
            channels_only: bool = False) -> torch.Tensor:
    """Keep with probability 1 - rate, kept values / (1 - rate); one mask
    entry per (image, channel) when `channels_only` (spatial dropout)."""
    if not ctx.train or not ctx.dropout or rate <= 0:
        return x
    keep = 1.0 - rate
    shape = x.shape[:2] + (1,) * (x.dim() - 2) if channels_only \
        else x.shape
    mask = torch.rand(shape, generator=ctx.generator,
                      device=x.device) < keep
    return ctx.q(torch.where(mask, x / keep,
                             torch.zeros((), device=x.device)))


def squeeze_excite(ctx: Context, w: Tensors, name: str, x: torch.Tensor
                   ) -> torch.Tensor:
    s = ctx.q(x.mean(dim=(2, 3), keepdim=True))
    s = torch.relu(conv(ctx, w, f"{name}.Conv_0", s))
    return ctx.q(x * ctx.q(torch.sigmoid(conv(ctx, w, f"{name}.Conv_1",
                                              s))))


def standardise(ctx: Context, w: Tensors, images: torch.Tensor
                ) -> torch.Tensor:
    """Float images N×H×W×3 in [0, 1] → N×3×H×W, standardised with the
    fixed channel statistics (eps 1e-7)."""
    x = (images - w["norm_mean"]) * torch.rsqrt(w["norm_var"] + 1e-7)
    return ctx.q(x.permute(0, 3, 1, 2))


def head(ctx: Context, w: Tensors, x: torch.Tensor, rate: float
         ) -> torch.Tensor:
    """Global average pooling, dropout at `rate` and the dense head →
    f32 logits N×K."""
    x = ctx.q(x.mean(dim=(2, 3)))
    x = dropout(ctx, x, rate)
    return ctx.q(x) @ ctx.q(w["Dense_0.weight"]).t() + w["Dense_0.bias"]


def forward(cfg: dict, w: Tensors, images: torch.Tensor, ctx: Context
            ) -> torch.Tensor:
    """Float images N×H×W×3 in [0, 1] → f32 logits N×K (the arch's
    `forward`)."""
    return _arch(cfg).forward(cfg, ctx, w, images)
