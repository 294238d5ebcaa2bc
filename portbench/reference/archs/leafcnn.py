"""LeafCNN, plain float32, written from its description (the Leaffliction
reference's `srcs/cli/train.py` base preset): the input standardised with
fixed channel statistics (eps 1e-7), a conv3x3-BN-ReLU stem, then per
width a residual block (2 × conv3x3-BN-ReLU, a squeeze-and-excitation gate
of ratio 8, a 1x1 conv + BN shortcut where the width changes), spatial
dropout and a 2x2 max-pool; global average pooling, dropout and a dense
head. BatchNorm eps 1e-3; the running statistics move with Keras's
momentum 0.99."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import models
from portbench.reference.models import (
    Context,
    Tensors,
    batchnorm,
    bn_layout,
    conv,
    conv_layout,
    dropout,
    se_layout,
    squeeze_excite,
)

BN_MOMENTUM = 0.99
# the configuration's overrides at which the benchmark's CPU tests run
# this arch (`portbench/tests/conftest.py`)
TINY = {"widths": [8, 16], "img_size": 32, "batch_size": 8,
        "compute_dtype": "float32"}


def layout(cfg: dict):
    widths = cfg["widths"]
    yield from models.input_layout()
    yield from conv_layout("ConvBlock_0.Conv_0", 3, widths[0], 3)
    yield from bn_layout("ConvBlock_0.BatchNorm_0", widths[0])
    cin = widths[0]
    for i, w in enumerate(widths):
        p = f"ResBlock_{i}"
        yield from conv_layout(f"{p}.ConvBlock_0.Conv_0", cin, w, 3)
        yield from bn_layout(f"{p}.ConvBlock_0.BatchNorm_0", w)
        yield from conv_layout(f"{p}.ConvBlock_1.Conv_0", w, w, 3)
        yield from bn_layout(f"{p}.ConvBlock_1.BatchNorm_0", w)
        yield from se_layout(f"{p}.SEBlock_0", w)
        if cin != w:
            yield from conv_layout(f"{p}.Conv_0", cin, w, 1)
            yield from bn_layout(f"{p}.BatchNorm_0", w)
        cin = w
    yield from models.head_layout(cin, cfg["num_classes"])


def forward(cfg: dict, ctx: Context, w: Tensors, images: torch.Tensor
            ) -> torch.Tensor:
    eps = 1e-3

    def block(name: str, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(batchnorm(ctx, w, f"{name}.BatchNorm_0",
                                    conv(ctx, w, f"{name}.Conv_0", x), eps))

    x = block("ConvBlock_0", models.standardise(ctx, w, images))
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
    return models.head(ctx, w, x, cfg["drop_top"])
