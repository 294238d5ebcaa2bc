"""Plain float32 LeafCNN and ResNet with SE blocks, written from their
descriptions, for judging the port.

LeafCNN (the Leaffliction reference's `srcs/cli/train.py` base preset): a
conv3x3-BN-ReLU stem, then per width a residual block (2 × conv3x3-BN-ReLU,
a squeeze-and-excitation gate of ratio 8, a 1x1 conv + BN shortcut where the
width changes), spatial dropout and a 2x2 max-pool; global average pooling,
dropout and a dense head. ResNet-18 (He et al., arXiv:1512.03385, Table 1):
a 7x7/2 conv-BN-ReLU stem and a 3x3/2 max-pool, then basic blocks 2/2/2/2
at widths 64-512, the first block of each later stage striding 2, each
block with an SE gate after its second BN; average pooling, dropout and a
dense head. Both standardise their input with fixed channel statistics
(eps 1e-7) and pad every conv and pool as "SAME" (total
max((ceil(n/s) - 1)·s + k - n, 0), the smaller half before).

The model is a function of a flat dict of tensors whose names are the
port's state-dict keys, so that the one set of weights the benchmark makes
loads into either side. Everything runs in float32 with plain PyTorch ops
and autograd; `q` rounds every activation where the port's bf16 model
holds it in its compute dtype (the standardised input, each conv, BatchNorm,
gate, residual sum, dropout and pooling output) and the weights of every
conv and of the head: that is where a control computed in a lower precision
than the configuration's differs from this reference (`precision.py`).
BatchNorm in training mode normalises with the batch mean and biased
variance and hands them to the caller (`Context.stats`), which moves the
running statistics with the model's momentum (`bn_momentum`: Keras's 0.99
for LeafCNN, 0.9 for the ResNet).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

Tensors = Dict[str, torch.Tensor]


def _ident(x: torch.Tensor) -> torch.Tensor:
    return x


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0
              ) -> torch.Tensor:
    (ht, hb), (wl, wr) = (same_pads(n, k, stride) for n in x.shape[-2:])
    return F.pad(x, (wl, wr, ht, hb), value=value)


# --- parameter shapes -----------------------------------------------------


def _conv(name: str, cin: int, cout: int, k: int, bias: bool = False):
    yield f"{name}.weight", (cout, cin, k, k), "conv"
    if bias:
        yield f"{name}.bias", (cout,), "bias"


def _bn(name: str, c: int, zero_scale: bool = False):
    yield f"{name}.scale", (c,), "zero_scale" if zero_scale else "scale"
    yield f"{name}.bias", (c,), "bias"
    yield f"{name}.mean", (c,), "mean"
    yield f"{name}.var", (c,), "var"


def _se(name: str, c: int):
    mid = max(c // 8, 1)
    yield from _conv(f"{name}.Conv_0", c, mid, 1, bias=True)
    yield from _conv(f"{name}.Conv_1", mid, c, 1, bias=True)


def layout(cfg: dict) -> Iterator[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of the configuration's model,
    in the port's state-dict order; kind is conv, dense, bias, scale,
    zero_scale, mean, var or norm_mean / norm_var."""
    k = cfg["num_classes"]
    yield "norm_mean", (3,), "norm_mean"
    yield "norm_var", (3,), "norm_var"
    if cfg["arch"] == "leafcnn":
        widths = cfg["widths"]
        yield from _conv("ConvBlock_0.Conv_0", 3, widths[0], 3)
        yield from _bn("ConvBlock_0.BatchNorm_0", widths[0])
        cin = widths[0]
        for i, w in enumerate(widths):
            p = f"ResBlock_{i}"
            yield from _conv(f"{p}.ConvBlock_0.Conv_0", cin, w, 3)
            yield from _bn(f"{p}.ConvBlock_0.BatchNorm_0", w)
            yield from _conv(f"{p}.ConvBlock_1.Conv_0", w, w, 3)
            yield from _bn(f"{p}.ConvBlock_1.BatchNorm_0", w)
            yield from _se(f"{p}.SEBlock_0", w)
            if cin != w:
                yield from _conv(f"{p}.Conv_0", cin, w, 1)
                yield from _bn(f"{p}.BatchNorm_0", w)
            cin = w
    elif cfg["arch"] == "resnet":
        widths = cfg["widths"]
        yield from _conv("Conv_0", 3, widths[0], 7)
        yield from _bn("BatchNorm_0", widths[0])
        cin, b = widths[0], 0
        for stage, (n, w) in enumerate(zip(cfg["blocks"], widths)):
            for j in range(n):
                stride = 2 if j == 0 and stage > 0 else 1
                p = f"BasicBlock_{b}"
                yield from _conv(f"{p}.Conv_0", cin, w, 3)
                yield from _bn(f"{p}.BatchNorm_0", w)
                yield from _conv(f"{p}.Conv_1", w, w, 3)
                yield from _bn(f"{p}.BatchNorm_1", w, zero_scale=True)
                yield from _se(f"{p}.SEBlock_0", w)
                if cin != w or stride != 1:
                    yield from _conv(f"{p}.Conv_2", cin, w, 1)
                    yield from _bn(f"{p}.BatchNorm_2", w)
                cin, b = w, b + 1
    else:
        raise ValueError(f"unknown arch {cfg['arch']!r}")
    yield "Dense_0.weight", (k, cin), "dense"
    yield "Dense_0.bias", (k,), "bias"


def trainable(cfg: dict) -> list:
    """Names of the parameters (what the optimizer updates), in order."""
    return [n for n, _, kind in layout(cfg)
            if kind not in ("mean", "var", "norm_mean", "norm_var")]


def running(cfg: dict) -> list:
    """Names of the BatchNorm running statistics, in order."""
    return [n for n, _, kind in layout(cfg) if kind in ("mean", "var")]


def bn_momentum(cfg: dict) -> float:
    return 0.99 if cfg["arch"] == "leafcnn" else 0.9


# --- forward ----------------------------------------------------------------


class Context:
    """What one forward needs besides the weights: training or eval mode,
    the generator the dropout masks are drawn from (in the port's order),
    the operand rounding `q`, and optionally a dict that receives each
    BatchNorm's batch mean and biased variance (BatchNorm then normalises
    with them, in either mode)."""

    def __init__(self, train: bool, generator: Optional[torch.Generator]
                 = None, q: Callable = _ident,
                 stats: Optional[Tensors] = None) -> None:
        self.train, self.generator, self.q, self.stats = \
            train, generator, q, stats


def conv(ctx: Context, w: Tensors, name: str, x: torch.Tensor,
         stride: int = 1) -> torch.Tensor:
    weight = w[f"{name}.weight"]
    x = _pad_same(x, weight.shape[-1], stride)
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
    if not ctx.train or rate <= 0:
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


def _leafcnn(cfg: dict, ctx: Context, w: Tensors, x: torch.Tensor
             ) -> torch.Tensor:
    eps = 1e-3

    def block(name: str, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(batchnorm(ctx, w, f"{name}.BatchNorm_0",
                                    conv(ctx, w, f"{name}.Conv_0", x), eps))

    x = block("ConvBlock_0", x)
    cin = cfg["widths"][0]
    for i, width in enumerate(cfg["widths"]):
        p = f"ResBlock_{i}"
        y = block(f"{p}.ConvBlock_1", block(f"{p}.ConvBlock_0", x))
        y = squeeze_excite(ctx, w, f"{p}.SEBlock_0", y)
        shortcut = x
        if cin != width:
            shortcut = batchnorm(ctx, w, f"{p}.BatchNorm_0",
                                 conv(ctx, w, f"{p}.Conv_0", x), eps)
        x = torch.relu(ctx.q(shortcut + y))
        x = dropout(ctx, x, cfg["drop_block"], channels_only=True)
        x = F.max_pool2d(x, 2)
        cin = width
    return x


def _resnet(cfg: dict, ctx: Context, w: Tensors, x: torch.Tensor
            ) -> torch.Tensor:
    eps = 1e-5
    x = torch.relu(batchnorm(ctx, w, "BatchNorm_0",
                             conv(ctx, w, "Conv_0", x, stride=2), eps))
    x = F.max_pool2d(_pad_same(x, 3, 2, value=float("-inf")), 3, 2)
    cin, b = cfg["widths"][0], 0
    for stage, (n, width) in enumerate(zip(cfg["blocks"], cfg["widths"])):
        for j in range(n):
            stride = 2 if j == 0 and stage > 0 else 1
            p = f"BasicBlock_{b}"
            y = torch.relu(batchnorm(ctx, w, f"{p}.BatchNorm_0",
                                     conv(ctx, w, f"{p}.Conv_0", x, stride),
                                     eps))
            y = batchnorm(ctx, w, f"{p}.BatchNorm_1",
                          conv(ctx, w, f"{p}.Conv_1", y), eps)
            y = squeeze_excite(ctx, w, f"{p}.SEBlock_0", y)
            shortcut = x
            if cin != width or stride != 1:
                shortcut = batchnorm(ctx, w, f"{p}.BatchNorm_2",
                                     conv(ctx, w, f"{p}.Conv_2", x, stride),
                                     eps)
            x = torch.relu(ctx.q(shortcut + y))
            cin, b = width, b + 1
    return x


def forward(cfg: dict, w: Tensors, images: torch.Tensor, ctx: Context
            ) -> torch.Tensor:
    """Float images N×H×W×3 in [0, 1] → f32 logits N×K."""
    x = (images - w["norm_mean"]) * torch.rsqrt(w["norm_var"] + 1e-7)
    x = ctx.q(x.permute(0, 3, 1, 2))
    body = _leafcnn if cfg["arch"] == "leafcnn" else _resnet
    x = ctx.q(body(cfg, ctx, w, x).mean(dim=(2, 3)))
    x = dropout(ctx, x, cfg["drop_top"])
    return ctx.q(x) @ ctx.q(w["Dense_0.weight"]).t() + w["Dense_0.bias"]
