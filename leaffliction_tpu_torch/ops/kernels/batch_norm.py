"""BatchNorm (+ReLU) on the card: the wrappers of `csrc/batch_norm.cu`.

The plain twin, the autograd function and the module are
`ops/fused_bn.py`, which calls these for CUDA tensors (no Pallas kernel is
replaced: the JAX package's `bn_train` is a custom VJP that XLA fuses).
A training BatchNorm is four kernels and two small finalisations:

- `moments`: `bn_stats` (each block's Σx and Σx² from one read of x), then
  `bn_finalize` (the blocks' partials summed in a fixed order → mean, the
  biased var and the running statistics); with a data-parallel group the
  raw [Σx, Σx²] are all-reduced between the two;
- `normalize`: `bn_apply`, one read of x and one write of y, with the ReLU
  fused where the model applies one; eval runs it on the running
  statistics;
- `grad_sums`: `bn_grad_reduce` (Σdy′ and Σdy′·x̂, dy′ masked by the ReLU
  rebuilt from x) and `bn_finalize`;
- `grad_input`: `bn_dx`.

Each launches on PyTorch's current stream, allocates outputs and partials
with `torch.empty` and never synchronises, so CUDA graphs capture them;
the partials' count for a shape is asked of the library once and cached.
The kernels take x channels-last, bf16 or f32, and raise on anything else;
`ops/layout.py` holds that contract (the copies into and out of
channels-last, the 16-byte vector width). `launches` counts each kernel's
launches and, under `copy`, the tensors `ops/fused_bn.py` copied into or
out of channels-last; it is registered with `kernels/build.py` as
`batch_norm.<key>`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from leaffliction_tpu_torch.kernels import build
from leaffliction_tpu_torch.ops import layout

launches: Dict[str, int] = dict.fromkeys(
    ("stats", "apply", "grad_reduce", "dx", "finalize", "copy"), 0)
for _key in launches:
    build.register_launches(f"batch_norm.{_key}", launches, _key)

Geometry = Tuple[int, int, int]  # rows, c, vec


def _check(x: torch.Tensor) -> None:
    if x.dim() < 2:
        raise ValueError(f"batch_norm: want [N, C, ...], got {tuple(x.shape)}")
    if x.dtype not in layout.KERNEL_DTYPES:
        raise ValueError(f"batch_norm: no kernel for {x.dtype}")


def geometry(x: torch.Tensor, *more: torch.Tensor) -> Geometry:
    """(rows, c, vec) of a channels-last CUDA x [N, C, ...] and the tensors
    read beside it: vec is 8 where 16-byte accesses apply, else 1. Raises
    on another layout or dtype."""
    _check(x)
    if not layout.is_channels_last(x):
        raise ValueError(f"batch_norm: x of strides {x.stride()} is not "
                         "channels-last")
    c = x.shape[1]
    rows = x.numel() // c if c else 0
    if max(rows, c) >= 2 ** 31:
        raise ValueError(f"batch_norm: {tuple(x.shape)} is beyond int32 sizes")
    return rows, c, layout.vector_width(c, x, *more)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """A [C] parameter or statistic as the kernels read it."""
    return t if t.dtype == torch.float32 and t.is_contiguous() \
        else t.float().contiguous()


def _partials(g: Geometry, device: torch.device) -> torch.Tensor:
    blocks = build.blocks("leaf_bn_blocks", *g, device.index)
    return torch.empty((blocks, 2, g[1]), dtype=torch.float32, device=device)


def _finalize(lib, partials: torch.Tensor, count: float, out0: torch.Tensor,
              out1: torch.Tensor, running=None, momentum: float = 0.0,
              moments: bool = True) -> None:
    dev = partials.device.index
    run_mean, run_var = running if running is not None else (None, None)
    rc = lib.leaf_bn_finalize(
        partials.data_ptr(), out0.data_ptr(), out1.data_ptr(),
        None if run_mean is None else run_mean.data_ptr(),
        None if run_var is None else run_var.data_ptr(),
        partials.shape[0], partials.shape[-1], count, momentum,
        1.0 - momentum, int(moments), dev, build.current_stream(dev))
    launches["finalize"] += 1
    build.check(rc, "leaf_bn_finalize")


def moments(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None,
            running: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            momentum: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased var), f32 [C], of x's batch, which with `group` is
    every rank's rows. With `running` (the module's f32 mean and var
    buffers) they move to `momentum·running + (1 − momentum)·batch`, in
    place."""
    g = geometry(x)
    rows, c, vec = g
    if running is not None and not all(
            t.dtype == torch.float32 and t.is_contiguous()
            and t.device == x.device and t.shape == (c,) for t in running):
        raise ValueError("batch_norm: the running statistics must be "
                         "contiguous f32 [C] on x's device")
    lib = build.load()
    dev = x.device.index
    partials = _partials(g, x.device)
    rc = lib.leaf_bn_stats(x.data_ptr(), partials.data_ptr(), rows, c, vec,
                           int(x.dtype == torch.bfloat16), partials.shape[0],
                           dev, build.current_stream(dev))
    launches["stats"] += 1
    build.check(rc, "leaf_bn_stats")
    count = float(rows)
    if group is not None:
        # the global batch's moments: every rank holds as many rows
        sums = torch.empty((1, 2, c), dtype=torch.float32, device=x.device)
        _finalize(lib, partials, count, sums[0, 0], sums[0, 1],
                  moments=False)
        dist.all_reduce(sums, group=group)
        partials, count = sums, count * dist.get_world_size(group)
    mean = torch.empty(c, dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    _finalize(lib, partials, count, mean, var, running, momentum)
    return mean, var


def normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
              scale: torch.Tensor, bias: torch.Tensor, eps: float,
              relu: bool = False) -> torch.Tensor:
    """((x − mean)·(rsqrt(var + eps)·scale) + bias), ReLU'd with `relu`,
    in x's dtype and layout."""
    rows, c, vec = geometry(x)
    y = torch.empty_like(x)
    mean, var, scale, bias = map(_f32, (mean, var, scale, bias))
    dev = x.device.index
    rc = build.load().leaf_bn_apply(
        x.data_ptr(), y.data_ptr(), mean.data_ptr(), var.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), eps, rows, c, vec,
        int(x.dtype == torch.bfloat16), int(relu), dev,
        build.current_stream(dev))
    launches["apply"] += 1
    build.check(rc, "leaf_bn_apply")
    return y


def grad_sums(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
              var: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float, relu: bool = False) -> torch.Tensor:
    """f32 [2, C]: this batch's Σdy′ and Σdy′·x̂, x̂ = (x − mean)·rsqrt(var
    + eps), dy′ = dy where the forward's ReLU kept its value (with `relu`).
    dy must be channels-last, as x."""
    g = geometry(x, dy)
    rows, c, vec = g
    mean, var, scale, bias = map(_f32, (mean, var, scale, bias))
    lib = build.load()
    dev = x.device.index
    partials = _partials(g, x.device)
    rc = lib.leaf_bn_grad_reduce(
        x.data_ptr(), dy.data_ptr(), partials.data_ptr(), mean.data_ptr(),
        var.data_ptr(), scale.data_ptr(), bias.data_ptr(), eps, rows, c,
        vec, int(x.dtype == torch.bfloat16), int(relu), partials.shape[0],
        dev, build.current_stream(dev))
    launches["grad_reduce"] += 1
    build.check(rc, "leaf_bn_grad_reduce")
    sums = torch.empty((2, c), dtype=torch.float32, device=x.device)
    _finalize(lib, partials, 0.0, sums[0], sums[1], moments=False)
    return sums


def grad_input(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
               var: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               sums: torch.Tensor, eps: float, count: float,
               relu: bool = False) -> torch.Tensor:
    """dx = scale·inv·((dy′ − Σdy′/count) − x̂·Σdy′x̂/count) in x's dtype
    and layout, from `sums` [2, C] (`grad_sums`, over every rank with a
    group) of `count` rows."""
    rows, c, vec = geometry(x, dy)
    mean, var, scale, bias, sums = map(_f32, (mean, var, scale, bias, sums))
    dx = torch.empty_like(x)
    dev = x.device.index
    rc = build.load().leaf_bn_dx(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), mean.data_ptr(),
        var.data_ptr(), scale.data_ptr(), bias.data_ptr(), sums.data_ptr(),
        eps, count, rows, c, vec, int(x.dtype == torch.bfloat16),
        int(relu), dev, build.current_stream(dev))
    launches["dx"] += 1
    build.check(rc, "leaf_bn_dx")
    return dx
