"""Tensor parallelism over the mesh's `model` axis: channel-sharded layers.

The JAX package pins a channel-sharded state layout (`tp_shardings`) and
lets XLA's SPMD partitioner insert the collectives. Here the layout is
explicit: `shard_train_state` keeps, on each rank, its block of the output
channels of every tensor that `parallel.mesh.tp_shardings` shards (conv
and Dense weights and biases, BatchNorm's four tensors, and their Adam
moments and EMA copies), and marks the model's `Conv` and `Dense` layers.
The layers then follow Megatron's column-parallel pattern
(`models/leafcnn.Conv`, `Dense`):

- a sharded channel-mixing layer takes the full input and gives its output
  channels: the input passes `copy_to_model` (identity forward; backward,
  the model group's sum of the ranks' partial input gradients);
- activations stay sliced after a sharded layer: BatchNorm, ReLU, the
  pools, the SE multiply, the residual add and a depthwise conv act on
  the slice;
- a channel-mixing layer whose input is sliced first gathers it
  (`gather_channels`: all-gather over the model group; backward, this
  rank's block of the gradient, which is already the sum when the
  consumer is sharded, and every rank's same value when it is not);
- a sharded Dense head's logits are gathered.

The all-reduce of an activation gradient runs in f32 (a bf16 gradient is
widened, summed over the T ranks and rounded once), so the T partial sums
are rounded once, as the one-device backward rounds its sum once.

`gather_tensors` is the inverse of the sharding for whole state sections
(checkpoints, artifacts, tests): one all-gather a dtype over the model
group. `shard_state_dict` slices a full state for this rank (a resume, or
JAX's params through `convert.to_state_dict`: `from_flax`).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from leaffliction_tpu_torch.convert import to_state_dict
from leaffliction_tpu_torch.ops.fused_bn import BatchNorm
from leaffliction_tpu_torch.parallel.mesh import (
    TP_MIN_SIZE,
    Mesh,
    channel_slice,
    shard,
    tp_shardings,
)

Tensors = Dict[str, torch.Tensor]


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return torch.cat(mesh.model_all_gather(x), dim=1)

    @staticmethod
    def backward(ctx, grad):
        cols = channel_slice(grad.shape[1], ctx.mesh)
        return grad[:, cols].contiguous(), None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        total = torch.empty(grad.shape, dtype=torch.float32,
                            device=grad.device)
        total.copy_(grad)
        ctx.mesh.model_all_reduce(total)
        return total.to(grad.dtype), None


def gather_channels(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's channel block (dim 1) → the full tensor, every model
    index's block in order; the gradient flows back as this rank's
    block."""
    return _Gather.apply(x, mesh)


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x itself; its gradient is summed over the model group (in f32)."""
    return _CopyToModel.apply(x, mesh)


def plan_for(model: torch.nn.Module, mesh: Mesh,
             min_size: int = TP_MIN_SIZE) -> Dict[str, bool]:
    """`tp_shardings` of a full model's state_dict on `mesh`."""
    return tp_shardings({k: v.shape for k, v in model.state_dict().items()},
                        mesh.model, min_size)


def shard_model(model: torch.nn.Module, plan: Mapping[str, bool],
                mesh: Mesh) -> None:
    """Keep this rank's block of every sharded tensor of a full model, in
    place, and mark its `Conv` and `Dense` layers (the `tp` attribute: the
    mesh; `sharded`: their output channels are)."""
    for name, module in model.named_modules():
        prefix = f"{name}." if name else ""
        for store in (module._parameters, module._buffers):
            for leaf, t in list(store.items()):
                if t is None or not plan.get(prefix + leaf):
                    continue
                if not (hasattr(module, "tp")
                        or isinstance(module, BatchNorm)):
                    raise ValueError(f"tensor parallelism: {prefix}{leaf} "
                                     "would be sharded, but its layer is "
                                     "not a Conv, Dense or BatchNorm")
                part = shard(t.detach(), mesh)
                store[leaf] = (torch.nn.Parameter(part, t.requires_grad)
                               if isinstance(t, torch.nn.Parameter)
                               else part)
        if hasattr(module, "tp"):
            module.tp = mesh
            module.sharded = bool(plan.get(prefix + "weight"))
            if module.sharded and getattr(module, "groups", 1) > 1:
                module.groups = module.weight.shape[0]  # depthwise


def shard_state_dict(sd: Mapping[str, torch.Tensor],
                     plan: Mapping[str, bool], mesh: Mesh) -> Tensors:
    """A full state → this rank's: its block of every sharded tensor."""
    return {k: shard(v, mesh) if plan.get(k) else v for k, v in sd.items()}


def from_flax(variables, mesh: Mesh,
              min_size: int = TP_MIN_SIZE) -> Tensors:
    """The JAX package's variables (numpy, as `to_state_dict` takes them)
    → this rank's sharded state_dict."""
    sd = to_state_dict(variables)
    plan = tp_shardings({k: v.shape for k, v in sd.items()}, mesh.model,
                        min_size)
    return shard_state_dict(sd, plan, mesh)


def gather_tensors(tensors: Mapping[str, torch.Tensor],
                   plan: Mapping[str, bool], mesh: Mesh) -> Tensors:
    """This rank's tensors → the full ones: the sharded ones all-gathered
    over the model group (one flat all-gather a dtype) and put together
    along dim 0, the others as they are. Every rank of the model group
    must call it with the same keys."""
    out = dict(tensors)
    by_dtype: Dict[torch.dtype, list] = {}
    for k, v in tensors.items():
        if plan.get(k):
            by_dtype.setdefault(v.dtype, []).append(k)
    for keys in by_dtype.values():
        flat = torch.cat([tensors[k].detach().reshape(-1) for k in keys])
        parts = [p.split([tensors[k].numel() for k in keys])
                 for p in mesh.model_all_gather(flat)]
        for i, k in enumerate(keys):
            shape = tensors[k].shape
            out[k] = torch.cat([p[i].view(shape) for p in parts])
    return out


def shard_train_state(state, mesh: Mesh,
                      min_size: int = TP_MIN_SIZE) -> Dict[str, bool]:
    """Shard a full `train.steps.TrainState` for this rank, in place: the
    model (`shard_model`), Adam's moments and the EMA copies by their
    parameter's key → the plan, also kept as `state.sharded`, with the
    mesh as `state.tp`."""
    plan = plan_for(state.model, mesh, min_size)
    shard_model(state.model, plan, mesh)
    for name in ("mu", "nu", "ema_params", "ema_batch_stats"):
        setattr(state, name, shard_state_dict(getattr(state, name), plan,
                                              mesh))
    state.tp, state.sharded = mesh, plan
    return plan


def full_sections(state) -> Dict[str, Tensors]:
    """The state's tensor sections (`model` state_dict, `mu`, `nu`,
    `ema_params`, `ema_batch_stats`), full: gathered over the model group
    when the state is sharded (every rank of the group must call it)."""
    sections = {"model": state.model.state_dict(), "mu": state.mu,
                "nu": state.nu, "ema_params": state.ema_params,
                "ema_batch_stats": state.ema_batch_stats}
    if getattr(state, "tp", None) is None:
        return sections
    return {name: gather_tensors(t, state.sharded, state.tp)
            for name, t in sections.items()}
