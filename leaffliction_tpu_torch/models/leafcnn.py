"""LeafCNN in PyTorch, in eval and training mode.

Port of `leaffliction_tpu/models/leafcnn.py`: conv or space-to-depth stem,
per-width stages of [residual block (2 × conv3x3-BN-ReLU, SE ratio 8 unless
`use_se=False`, 1x1 projection shortcut) → spatial dropout → maxpool, the
block's exit one op from the SE scale to the pool (`ops/block_exit.py`)], GAP
→ dropout and a Dense head; optional depthwise-separable convs and input
standardisation (`norm_stats`, eps 1e-7). The model returns logits.

Input is N×H×W×3 float in [0, 1] (the JAX layout); the convolutions run in
NCHW. Submodules carry the flax auto-names (`ConvBlock_0`, `ResBlock_1`,
`Conv_0`, `BatchNorm_0`, `SEBlock_0`, `Dense_0`), so state_dict keys map
one to one onto the flax variable paths (`convert.py`).

Casts mirror flax instead of using autocast: the input is cast to the compute
dtype after standardisation, conv weights (and SE biases) are cast to it,
BatchNorm computes in f32 and casts back, the GAP result is rounded to the
compute dtype and then widened to f32, and the Dense head runs in f32.

`forward(x, train=True, generator=g)` is the training mode: BatchNorm
normalises with the batch statistics (`ops/fused_bn.bn_train`) and moves its
running statistics, SpatialDropout2D (rate `drop_block`) drops whole
channels after each residual block and dropout (rate `drop_top`) follows the
GAP, both as flax `Dropout` does: keep with probability 1 − rate, kept
values divided by 1 − rate, drawn from the explicit `torch.Generator`.
`forward(..., mesh=m)` with a `parallel.mesh.Mesh` of more than one rank
takes this rank's rows of the global batch: BatchNorm normalises with the
global batch's statistics (the data group) and dropout keeps this rank's
rows of masks drawn for the global batch, so D ranks compute what one JAX
program computes over the whole batch. Tensor parallelism
(`parallel/tensor.shard_train_state`) shards the output channels of the
`Conv` and `Dense` layers JAX's rule picks: those layers gather a sliced
input and sum a full input's gradient over the model group, activations
stay sliced between them, and dropout keeps this rank's channels of a
mask drawn for all of them.
Dropout has no variables. The lane-folded layout (`models/folded.py`) is a
TPU layout and is not ported: the plain layout computes the same function.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from leaffliction_tpu_torch.ops import block_exit as exits
from leaffliction_tpu_torch.ops.fused_bn import BatchNorm
from leaffliction_tpu_torch.ops.layout import pad_same
from leaffliction_tpu_torch.parallel.mesh import channel_slice
from leaffliction_tpu_torch.parallel.tensor import (
    copy_to_model,
    gather_channels,
)

# the JAX package's SCALE_PRESETS: widths, drop_block, drop_top
SCALE_PRESETS = {
    "tiny": {"widths": (16, 32, 64), "drop_block": 0.10, "drop_top": 0.30},
    "small": {"widths": (32, 64, 128), "drop_block": 0.15, "drop_top": 0.35},
    "base": {"widths": (32, 64, 128, 256), "drop_block": 0.15,
             "drop_top": 0.40},
}


def dropout_mask(x: torch.Tensor, rate: float, generator: torch.Generator,
                 channels_only: bool = False, mesh=None,
                 channels: Optional[int] = None) -> torch.Tensor:
    """flax `Dropout`'s mask for x, True where kept (probability 1 − rate).
    `channels_only` draws one entry per (image, channel) of an NCHW tensor
    (SpatialDropout2D, flax `broadcast_dims=(1, 2)` in NHWC), shaped [N, C,
    1, ...]. With a `mesh` (`parallel.mesh.Mesh`), x is this rank's rows:
    the mask is drawn for the global batch, as the JAX program draws it,
    and this rank keeps its rows; when x holds this rank's block of
    `channels` channels (tensor parallelism), the mask is drawn for all of
    them and this rank keeps its block."""
    keep = 1.0 - rate
    shape = list(x.shape[:2] + (1,) * (x.dim() - 2) if channels_only
                 else x.shape)
    cols = None
    if mesh is not None:
        shape[0] *= mesh.data
        if channels is not None and channels != shape[1]:
            cols = channel_slice(channels, mesh)
            shape[1] = channels
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if mesh is not None:
        mask = mask[mesh.rows(shape[0])]
    if cols is not None:
        mask = mask[:, cols]
    return mask


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            channels_only: bool = False, mesh=None,
            channels: Optional[int] = None) -> torch.Tensor:
    """flax `Dropout`: keep with probability 1 − rate (`dropout_mask`),
    kept values `x / (1 − rate)`."""
    return exits.dropped(x, dropout_mask(x, rate, generator, channels_only,
                                         mesh, channels), 1.0 - rate)


def spatial_dropout(rate: float, generator: torch.Generator, mesh=None,
                    channels: Optional[int] = None):
    """SpatialDropout2D at `rate` as a block's exit takes it: a function of
    the block's y [N, C, H, W] → `ops.block_exit.Drop`, its mask drawn by
    `dropout_mask` once the block has computed y, so each stage draws from
    the generator in the order the plain reference's dropout does."""
    def drop(y: torch.Tensor) -> exits.Drop:
        return exits.Drop(dropout_mask(y, rate, generator, True, mesh,
                                       channels), 1.0 - rate)
    return drop


def data_parallel(mesh):
    """(mesh, BatchNorm's group) for a training forward: the mesh when it
    has more than one rank (else None), and its data group when that has
    more than one (else None)."""
    if mesh is None or mesh.data * mesh.model <= 1:
        return None, None
    return mesh, mesh.group if mesh.data > 1 else None


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """f32 [N, C]: x's mean over H and W, taken over the channels-last view
    (the layout the convolutions hand over), so its gradient comes back
    channels-last and the last block's exit kernel reads it as it is (over
    the NCHW view, `mean`'s backward hands back a channels-first one). The
    same sums as `x.float().mean(dim=(2, 3))`."""
    return x.permute(0, 2, 3, 1).float().mean(dim=(1, 2))


def _tp_input(layer: nn.Module, x: torch.Tensor, cin: int) -> torch.Tensor:
    """A channel-mixing layer's input under tensor parallelism (`layer.tp`
    a mesh): a sliced x (fewer than the layer's `cin` channels) is
    gathered; a sharded layer takes it through `copy_to_model`."""
    if layer.tp is None:
        return x
    if x.shape[1] != cin:
        x = gather_channels(x, layer.tp)
    if layer.sharded:
        x = copy_to_model(x, layer.tp)
    return x


class Conv(nn.Module):
    """SAME-padded conv in the input's dtype, flax `nn.Conv` semantics: the
    pads computed from the input's size at each call (`ops.layout.pad_same`),
    the bias added after the conv, in the compute dtype. Tensor parallel
    (`tp`, set by `parallel/tensor.shard_model`): a sharded conv holds its
    block of the output channels; a channel-mixing conv gathers a sliced
    input (`_tp_input`); a depthwise conv is channel-local and acts on its
    input's channels as they are (its `groups` is then its block's)."""

    tp = None
    sharded = False

    def __init__(self, cin: int, cout: int, ksize: int, groups: int = 1,
                 bias: bool = False, stride: int = 1) -> None:
        super().__init__()
        self.groups = groups
        self.stride = stride
        self.weight = nn.Parameter(
            torch.zeros(cout, cin // groups, ksize, ksize))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.groups == 1:
            x = _tp_input(self, x, self.weight.shape[1])
        x, pad = pad_same(x, self.weight.shape[-1], self.stride)
        y = F.conv2d(x, self.weight.to(x.dtype), stride=self.stride,
                     padding=pad, groups=self.groups)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype).view(1, -1, 1, 1)
        return y


class SEBlock(nn.Module):
    """Squeeze-and-Excitation, ratio 8, with biased 1x1 convs: the gate
    [N, C, 1, 1] in x's dtype, which the block's exit multiplies x by
    (`ops.block_exit`)."""

    def __init__(self, channels: int) -> None:
        super().__init__()
        mid = max(channels // 8, 1)
        self.Conv_0 = Conv(channels, mid, 1, bias=True)
        self.Conv_1 = Conv(mid, channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        se = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
        return torch.sigmoid(self.Conv_1(torch.relu(self.Conv_0(se))))


class ConvBlock(nn.Module):
    """conv3x3 (no bias; depthwise + pointwise when separable) → BN → ReLU."""

    def __init__(self, cin: int, features: int, separable: bool,
                 dtype: torch.dtype) -> None:
        super().__init__()
        if separable:
            self.Conv_0 = Conv(cin, cin, 3, groups=cin)
            self.Conv_1 = Conv(cin, features, 1)
        else:
            self.Conv_0 = Conv(cin, features, 3)
        self.BatchNorm_0 = BatchNorm(features, 1e-3, dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                group=None) -> torch.Tensor:
        x = self.Conv_0(x)
        if hasattr(self, "Conv_1"):
            x = self.Conv_1(x)
        return self.BatchNorm_0(x, train, group, relu=True)


class ResBlock(nn.Module):
    """Two ConvBlocks, SE (unless `use_se` is False: then no `SEBlock_0`),
    and a 1x1 conv + BN shortcut when widths differ, then the exit
    `relu(shortcut + y·se)` with the stage's spatial dropout (`drop`, from
    `spatial_dropout`) and max-pool (`pool`) where the model passes them
    (`ops.block_exit`)."""

    def __init__(self, cin: int, features: int, separable: bool,
                 dtype: torch.dtype, use_se: bool = True) -> None:
        super().__init__()
        self.ConvBlock_0 = ConvBlock(cin, features, separable, dtype)
        self.ConvBlock_1 = ConvBlock(features, features, separable, dtype)
        if use_se:
            self.SEBlock_0 = SEBlock(features)
        if cin != features:
            self.Conv_0 = Conv(cin, features, 1)
            self.BatchNorm_0 = BatchNorm(features, 1e-3, dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                group=None, drop=None,
                pool: Optional[exits.Pool] = None) -> torch.Tensor:
        y = self.ConvBlock_1(self.ConvBlock_0(x, train, group), train, group)
        se = self.SEBlock_0(y) if hasattr(self, "SEBlock_0") else None
        shortcut = x
        if hasattr(self, "Conv_0"):
            shortcut = self.BatchNorm_0(self.Conv_0(x), train, group)
        return exits.block_exit(y, se, shortcut,
                                drop=None if drop is None else drop(y),
                                pool=pool)


class Dense(nn.Linear):
    """nn.Linear, tensor parallel as `Conv` (`tp`): a sliced input is
    gathered, and a sharded head's logits are gathered too."""

    tp = None
    sharded = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(_tp_input(self, x, self.in_features))
        return gather_channels(y, self.tp) if self.sharded else y


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """N×H×W×C → N×(H/b)×(W/b)×(C·b²), channel order (by, bx, c). H and W
    must be multiples of b (ValueError otherwise; nothing is cut off)."""
    n, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(f"space_to_depth: {h}x{w} is not a multiple of "
                         f"the block {block}")
    x = x.reshape(n, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // block, w // block, c * block * block)


class LeafCNN(nn.Module):
    """Classifier: N×H×W×3 float [0, 1] → logits N×K (f32)."""

    def __init__(self, num_classes: int,
                 widths: Sequence[int] = (32, 64, 128),
                 separable: bool = False, use_norm: bool = True,
                 stem: str = "conv",
                 dtype: torch.dtype = torch.float32,
                 drop_block: float = 0.0, drop_top: float = 0.0,
                 use_se: bool = True) -> None:
        super().__init__()
        if stem not in ("conv", "s2d"):
            raise ValueError(f"unknown stem {stem!r}")
        self.num_classes = num_classes
        self.widths = tuple(widths)
        self.drop_block = drop_block
        self.drop_top = drop_top
        self.separable = separable
        self.use_se = use_se
        self.use_norm = use_norm
        self.stem = stem
        self.dtype = dtype
        if use_norm:
            self.register_buffer("norm_mean", torch.zeros(3))
            self.register_buffer("norm_var", torch.ones(3))
        cin = 12 if stem == "s2d" else 3
        self.ConvBlock_0 = ConvBlock(cin, self.widths[0], separable, dtype)
        cin = self.widths[0]
        for i, features in enumerate(self.widths):
            setattr(self, f"ResBlock_{i}",
                    ResBlock(cin, features, separable, dtype, use_se))
            cin = features
        self.Dense_0 = Dense(cin, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                mesh=None) -> torch.Tensor:
        if train and (self.drop_block > 0 or self.drop_top > 0) \
                and generator is None:
            raise ValueError("LeafCNN: training with dropout needs a "
                             "torch.Generator")
        mesh, group = data_parallel(mesh)
        if self.use_norm:
            x = (x - self.norm_mean) * torch.rsqrt(self.norm_var + 1e-7)
        x = x.to(self.dtype)
        if self.stem == "s2d":
            x = space_to_depth(x, 2)
        x = self.ConvBlock_0(x.permute(0, 3, 1, 2), train, group)
        for i in range(len(self.widths)):
            drop = None
            if train and self.drop_block > 0:
                drop = spatial_dropout(self.drop_block, generator, mesh,
                                       self.widths[i])
            # s2d: the first stage's 2x downsample moved into the stem
            pool = None if self.stem == "s2d" and i == 0 \
                else exits.Pool(2, 2)
            x = getattr(self, f"ResBlock_{i}")(x, train, group, drop, pool)
        x = global_mean(x).to(self.dtype)
        if train and self.drop_top > 0:
            x = dropout(x, self.drop_top, generator, mesh=mesh,
                        channels=self.widths[-1])
        return self.Dense_0(x.float())


def build_leafcnn(num_classes: int, scale: str = "base",
                  separable: bool = False, use_norm: bool = True,
                  stem: str = "conv",
                  dtype: torch.dtype = torch.float32) -> LeafCNN:
    preset = SCALE_PRESETS[scale]
    return LeafCNN(num_classes, preset["widths"], separable=separable,
                   use_norm=use_norm, stem=stem, dtype=dtype,
                   drop_block=preset["drop_block"],
                   drop_top=preset["drop_top"])


def init_model(model: nn.Module, seed: int) -> nn.Module:
    """Fresh variables with flax's default initialisers, drawn on the CPU
    from `seed`, for any model built of this module's `Conv`, `nn.Linear`
    and `ops.fused_bn.BatchNorm` (LeafCNN, LeafResNet): conv and Dense
    kernels lecun-normal (a normal truncated at ±2σ, rescaled to variance
    1/fan_in), biases zero, BatchNorm scale 1 (0 where the module has
    `zero_scale`), bias 0, mean 0, var 1, norm_stats mean 0, var 1. The
    draws differ from JAX's; their distributions are the same."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            owner, leaf = name.rsplit(".", 1) if "." in name else ("", name)
            if leaf == "weight":
                fan_in = math.prod(p.shape[1:])
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                cpu = torch.empty(p.shape)
                nn.init.trunc_normal_(cpu, 0.0, std, -2 * std, 2 * std,
                                      generator=g)
                p.copy_(cpu)
            elif leaf == "scale":
                p.fill_(0.0 if model.get_submodule(owner).zero_scale
                        else 1.0)
            else:
                p.zero_()
        for name, b in model.named_buffers():
            b.fill_(1.0 if name.endswith("var") else 0.0)
    return model


init_leafcnn = init_model  # LeafCNN's name for it
