"""ResNet-18 and its kin with SE blocks, plain float32, written from He et
al., arXiv:1512.03385, Table 1: the input standardised with fixed channel
statistics (eps 1e-7), a 7x7/2 conv-BN-ReLU stem and a 3x3/2 max-pool,
then basic blocks (`blocks` a stage, 2/2/2/2 for ResNet-18) at `widths`,
the first block of each later stage striding 2, each block with an SE
gate (ratio 8) after its second BN and a 1x1 conv + BN shortcut where the
shape changes; average pooling, dropout and a dense head. BatchNorm eps
1e-5; the running statistics move with momentum 0.9."""

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
    pad_same,
    se_layout,
    squeeze_excite,
)

BN_MOMENTUM = 0.9
# the configuration's overrides at which the benchmark's CPU tests run
# this arch (`portbench/tests/conftest.py`)
TINY = {"widths": [8, 16, 16, 16], "blocks": [1, 1, 1, 1],
        "img_size": 32, "batch_size": 8, "compute_dtype": "float32"}


def layout(cfg: dict):
    widths = cfg["widths"]
    yield from models.input_layout()
    yield from conv_layout("Conv_0", 3, widths[0], 7)
    yield from bn_layout("BatchNorm_0", widths[0])
    cin, b = widths[0], 0
    for stage, (n, w) in enumerate(zip(cfg["blocks"], widths)):
        for j in range(n):
            stride = 2 if j == 0 and stage > 0 else 1
            p = f"BasicBlock_{b}"
            yield from conv_layout(f"{p}.Conv_0", cin, w, 3)
            yield from bn_layout(f"{p}.BatchNorm_0", w)
            yield from conv_layout(f"{p}.Conv_1", w, w, 3)
            yield from bn_layout(f"{p}.BatchNorm_1", w, zero_scale=True)
            yield from se_layout(f"{p}.SEBlock_0", w)
            if cin != w or stride != 1:
                yield from conv_layout(f"{p}.Conv_2", cin, w, 1)
                yield from bn_layout(f"{p}.BatchNorm_2", w)
            cin, b = w, b + 1
    yield from models.head_layout(cin, cfg["num_classes"])


def forward(cfg: dict, ctx: Context, w: Tensors, images: torch.Tensor
            ) -> torch.Tensor:
    eps = 1e-5
    x = models.standardise(ctx, w, images)
    x = torch.relu(batchnorm(ctx, w, "BatchNorm_0",
                             conv(ctx, w, "Conv_0", x, stride=2), eps))
    x = F.max_pool2d(pad_same(x, 3, 2, value=float("-inf")), 3, 2)
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
    return models.head(ctx, w, x, cfg["drop_top"])
