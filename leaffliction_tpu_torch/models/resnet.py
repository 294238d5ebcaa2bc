"""The ResNet-style backbone in PyTorch, in eval and training mode.

Port of `leaffliction_tpu/models/resnet.py`: a stem, then stages of basic
blocks (2 × conv3x3-BN, ReLU between, SE ratio 8, a 1x1 conv + BN shortcut
where the width or the stride changes; the first block of every stage
after the first strides 2), GAP → dropout (`drop_top`, 0.2) and a Dense
head; input standardisation (`norm_stats`, eps 1e-7). Presets: resnet10
(1, 1, 1, 1) and resnet18 (2, 2, 2, 2) blocks, widths 64/128/256/512. The
model returns logits; `forward(x, train=False, generator=None,
mesh=None)` is LeafCNN's (`mesh`: data parallel, global BatchNorm
statistics and dropout drawn for the global batch; tensor parallel, the
channel-sharded `Conv` and `Dense` of `leafcnn.py`, where an identity
shortcut's input is already sliced like the block's output and the
strided shortcut `Conv_2` is a sharded conv like the others), so the step
functions, the trainer and the predictor take either model.

Stems: `conv` is 7×7/2 → BN → ReLU → 3×3/2 max-pool; `s2d` is a 4×4
space-to-depth (224²×3 → 56²×48) → 2×2/1 conv → BN → ReLU. Every conv and
the max-pool pad as flax "SAME" does, from the input's size at each call
(`ops.layout.same_pads`): at 224 px the stem conv pads (2, 3), the pool and
each stage's strided conv (0, 1), the s2d conv (0, 1); the pool pads with
−inf (flax `nn.max_pool`). Each block's exit `relu(shortcut + y·se)` and
the stem's pool are `ops.block_exit`'s one op. BatchNorm uses momentum 0.9
and eps 1e-5, and each block's second BatchNorm starts with scale 0
(`zero_scale`).

Submodules carry the flax auto-names (`Conv_0`, `BatchNorm_0`,
`BasicBlock_0` … numbered across the stages, `Dense_0`; in a block
`Conv_0`, `BatchNorm_0`, `Conv_1`, `BatchNorm_1`, `SEBlock_0`, and the
shortcut's `Conv_2`, `BatchNorm_2`), so `convert.py` maps the state_dict
one to one onto the flax tree. Casts mirror flax as in `leafcnn.py`.

The JAX package runs the stem and the width-64 stage in a lane-folded
batch layout (`models/folded.py`) at b ≥ 16; that is a TPU layout of the
same function (the JAX package's own tests hold folded equal to plain), so
it is not ported, and parity tests build the JAX side with
`lane_fold=False`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from leaffliction_tpu_torch.models.leafcnn import (
    Conv,
    Dense,
    SEBlock,
    data_parallel,
    dropout,
    global_mean,
    space_to_depth,
)
from leaffliction_tpu_torch.ops import block_exit as exits
from leaffliction_tpu_torch.ops.fused_bn import BatchNorm

RESNET_PRESETS = {
    "resnet10": {"blocks": (1, 1, 1, 1), "widths": (64, 128, 256, 512)},
    "resnet18": {"blocks": (2, 2, 2, 2), "widths": (64, 128, 256, 512)},
}
BN_EPS, BN_MOMENTUM = 1e-5, 0.9


def _bn(channels: int, dtype: torch.dtype, zero_scale: bool = False):
    return BatchNorm(channels, BN_EPS, dtype, momentum=BN_MOMENTUM,
                     zero_scale=zero_scale)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int,
                 dtype: torch.dtype) -> None:
        super().__init__()
        self.Conv_0 = Conv(cin, features, 3, stride=stride)
        self.BatchNorm_0 = _bn(features, dtype)
        self.Conv_1 = Conv(features, features, 3)
        self.BatchNorm_1 = _bn(features, dtype, zero_scale=True)
        self.SEBlock_0 = SEBlock(features)
        if cin != features or stride != 1:
            self.Conv_2 = Conv(cin, features, 1, stride=stride)
            self.BatchNorm_2 = _bn(features, dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                group=None) -> torch.Tensor:
        y = self.BatchNorm_0(self.Conv_0(x), train, group, relu=True)
        y = self.BatchNorm_1(self.Conv_1(y), train, group)
        se = self.SEBlock_0(y)
        shortcut = x
        if hasattr(self, "Conv_2"):
            shortcut = self.BatchNorm_2(self.Conv_2(x), train, group)
        return exits.block_exit(y, se, shortcut)


class LeafResNet(nn.Module):
    """Classifier: N×H×W×3 float [0, 1] → logits N×K (f32)."""

    def __init__(self, num_classes: int,
                 blocks: Sequence[int] = (2, 2, 2, 2),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 use_norm: bool = True, drop_top: float = 0.2,
                 stem: str = "conv",
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        if stem not in ("conv", "s2d"):
            raise ValueError(f"unknown stem {stem!r}")
        self.drop_top = drop_top
        self.use_norm = use_norm
        self.stem = stem
        self.dtype = dtype
        if use_norm:
            self.register_buffer("norm_mean", torch.zeros(3))
            self.register_buffer("norm_var", torch.ones(3))
        if stem == "s2d":
            self.Conv_0 = Conv(48, widths[0], 2)
        else:
            self.Conv_0 = Conv(3, widths[0], 7, stride=2)
        self.BatchNorm_0 = _bn(widths[0], dtype)
        cin, k = widths[0], 0
        for stage, (n_blocks, width) in enumerate(zip(blocks, widths)):
            for block in range(n_blocks):
                stride = 2 if (block == 0 and stage > 0) else 1
                setattr(self, f"BasicBlock_{k}",
                        BasicBlock(cin, width, stride, dtype))
                cin, k = width, k + 1
        self.n_blocks = k
        self.Dense_0 = Dense(cin, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                mesh=None) -> torch.Tensor:
        if train and self.drop_top > 0 and generator is None:
            raise ValueError("LeafResNet: training with dropout needs a "
                             "torch.Generator")
        mesh, group = data_parallel(mesh)
        if self.use_norm:
            x = (x - self.norm_mean) * torch.rsqrt(self.norm_var + 1e-7)
        x = x.to(self.dtype)
        if self.stem == "s2d":
            x = space_to_depth(x, 4)
        x = self.BatchNorm_0(self.Conv_0(x.permute(0, 3, 1, 2)), train,
                             group, relu=True)
        if self.stem == "conv":
            # the BatchNorm applied the ReLU: the exit is the pool alone
            x = exits.block_exit(x, relu=False,
                                 pool=exits.Pool(3, 2, same=True))
        for k in range(self.n_blocks):
            x = getattr(self, f"BasicBlock_{k}")(x, train, group)
        x = global_mean(x).to(self.dtype)
        if train and self.drop_top > 0:
            x = dropout(x, self.drop_top, generator, mesh=mesh,
                        channels=self.Dense_0.in_features)
        return self.Dense_0(x.float())


def build_resnet(num_classes: int, preset: str = "resnet18",
                 use_norm: bool = True, stem: str = "conv",
                 dtype: torch.dtype = torch.float32) -> LeafResNet:
    return LeafResNet(num_classes, **RESNET_PRESETS[preset],
                      use_norm=use_norm, stem=stem, dtype=dtype)
