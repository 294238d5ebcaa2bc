"""Parameter bridge between the flax variable tree and the port's state_dict.

The flax tree (`{"params", "batch_stats", "norm_stats"}` of numpy arrays, as
`leaf_cnn.msgpack` stores it) is walked by its auto-names, the same way
`leaffliction_tpu/train/keras_export.py` walks it:

- `Conv_k/kernel` HWIO → `Conv_k.weight` OIHW (a depthwise [3,3,1,C] becomes
  [C,1,3,3]); a conv `bias` (the SE 1x1 convs) carries over;
- `Dense_k/kernel` (in, out) → `Dense_k.weight` (out, in), with its bias;
- `BatchNorm_k` params `scale`/`bias` and batch_stats `mean`/`var` →
  `BatchNorm_k.{scale,bias,mean,var}`;
- `norm_stats` `mean`/`var` → `norm_mean`/`norm_var`;
- any other name (`ConvBlock_k`, `ResBlock_k`, `SEBlock_k`, the ResNet's
  `BasicBlock_k`) is a submodule, walked the same way.

`to_flax` is the inverse, and `flax_shape` gives a key's flax shape without
the values (tensor parallelism decides on it, `parallel/mesh.tp_shardings`).
`tests/test_torch_leafcnn.py` and
`tests/test_torch_resnet.py` hold the round trip exact against the JAX
init trees of both models.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

Tree = Dict[str, Any]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def to_state_dict(variables: Tree) -> Dict[str, torch.Tensor]:
    """flax variables → state_dict of f32 CPU tensors."""
    sd: Dict[str, torch.Tensor] = {}
    stats = variables.get("batch_stats", {})

    def walk(node: Tree, stat: Tree, path: List[str]) -> None:
        for name, child in node.items():
            key = ".".join(path + [name])
            if name.startswith("BatchNorm_"):
                sd[f"{key}.scale"] = _t(child["scale"])
                sd[f"{key}.bias"] = _t(child["bias"])
                sd[f"{key}.mean"] = _t(stat[name]["mean"])
                sd[f"{key}.var"] = _t(stat[name]["var"])
            elif name.startswith("Conv_"):
                sd[f"{key}.weight"] = _t(child["kernel"]).permute(
                    3, 2, 0, 1).contiguous()
                if "bias" in child:
                    sd[f"{key}.bias"] = _t(child["bias"])
            elif name.startswith("Dense_"):
                sd[f"{key}.weight"] = _t(child["kernel"]).t().contiguous()
                sd[f"{key}.bias"] = _t(child["bias"])
            else:
                walk(child, stat.get(name, {}), path + [name])

    walk(variables["params"], stats, [])
    norm = variables.get("norm_stats") or {}
    if norm:
        sd["norm_mean"] = _t(norm["mean"])
        sd["norm_var"] = _t(norm["var"])
    return sd


def _kind(key: str):
    """→ ("norm", "conv", "dense" or "other") for a state_dict key."""
    if key in ("norm_mean", "norm_var"):
        return "norm"
    *mod, leaf = key.split(".")
    if leaf == "weight" and mod[-1].startswith("Conv_"):
        return "conv"
    if leaf == "weight" and mod[-1].startswith("Dense_"):
        return "dense"
    return "other"


def flax_shape(key: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """The flax shape of the state_dict tensor `key` of torch `shape`:
    a conv weight OIHW is HWIO, a Dense weight (out, in) is (in, out),
    everything else keeps its shape."""
    kind = _kind(key)
    if kind == "conv":
        o, i, h, w = shape
        return (h, w, i, o)
    if kind == "dense":
        return tuple(shape[::-1])
    return tuple(shape)


def to_flax(state_dict: Dict[str, torch.Tensor]) -> Tree:
    """state_dict → flax variables of f32 numpy arrays (inverse of
    `to_state_dict`)."""
    out: Tree = {"params": {}, "batch_stats": {}, "norm_stats": {}}

    def put(tree: Tree, parts: List[str], value: np.ndarray) -> None:
        for p in parts[:-1]:
            tree = tree.setdefault(p, {})
        tree[parts[-1]] = value

    for key, value in state_dict.items():
        a = value.detach().cpu().float().numpy()
        kind = _kind(key)
        if kind == "norm":
            out["norm_stats"][key[len("norm_"):]] = a
            continue
        *mod, leaf = key.split(".")
        if mod[-1].startswith("BatchNorm_") and leaf in ("mean", "var"):
            put(out["batch_stats"], mod + [leaf], a)
        elif kind == "conv":
            put(out["params"], mod + ["kernel"], a.transpose(2, 3, 1, 0))
        elif kind == "dense":
            put(out["params"], mod + ["kernel"], a.T)
        else:  # conv/dense bias, BatchNorm scale/bias
            put(out["params"], mod + [leaf], a)
    return out
