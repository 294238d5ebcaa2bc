"""The `.keras` artifact of a LeafCNN: export and import.

Port of `leaffliction_tpu/train/keras_export.py`, on the port's `LeafCNN`
and its state dict. The reference ships its trained model as
`leaf_cnn.keras`; this package's own checkpoint is the flax msgpack. When
the `keras` package is importable:

- `export_keras` builds the reference's Keras graph (augment Sequential →
  input_norm Normalization → conv stem → residual/SE stages → GAP →
  Dropout → softmax Dense) and copies the model's weights into it, so
  `keras.models.load_model("leaf_cnn.keras")` works unchanged;
- `import_keras` loads a `.keras` file (exported here, by the JAX package,
  or trained by the reference) and maps its weights into a `LeafCNN`.

The name mapping walks the flax-shaped numpy tree that `convert.to_flax`
makes of the state dict (import goes back through `convert.to_state_dict`),
so both directions use the JAX module's names: every weighted layer is
named `fx__<flax path>` (`fx__ResBlock_1__SEBlock_0__Conv_0`). Import does
not rely on the file's names (reference-trained files use Keras defaults)
or on `model.layers` order (Keras sorts a functional model's layers
topologically): it infers the architecture from the graph, rebuilds the
same graph as a template and aligns the two layer lists by position.

Weight layouts (Keras 3): Conv2D/Dense kernels are flax's HWIO/(in, out);
SeparableConv2D stores [depthwise (kh, kw, C, 1), pointwise (1, 1, C, F)]
against flax's grouped conv (kh, kw, 1, C) and 1x1 conv;
BatchNormalization holds [gamma, beta, moving_mean, moving_variance];
`Normalization(mean, variance)` computes (x − mean) / sqrt(variance)
without an epsilon while LeafCNN uses rsqrt(var + 1e-7), so export writes
`variance + 1e-7` and import subtracts it.

keras is imported inside the functions only, never when this module is
imported. Importing keras itself loads JAX and TensorFlow into the process
where they are installed (keras imports them to probe its backends), so
the port's own import check runs without keras. Nothing here runs on the
card's train or serve path: the graph is built and saved on the host.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from leaffliction_tpu_torch.convert import to_flax, to_state_dict
from leaffliction_tpu_torch.core.logging import get_logger
from leaffliction_tpu_torch.models.leafcnn import LeafCNN

LOGGER = get_logger(__name__)

_NORM_EPS = 1e-7  # LeafCNN normalizes with rsqrt(var + 1e-7)
_FX = "fx__"      # weighted-layer name prefix: encodes the flax param path


def keras_available() -> bool:
    try:
        import keras  # noqa: F401

        return True
    except Exception:  # the environment's: no keras, or a broken install
        return False


def _keras():
    # The backend only runs the graph in memory: a saved .keras file does
    # not depend on it. torch is this package's own framework, so it is
    # the default here; a backend the caller set (or that keras already
    # loaded in this process) stays.
    os.environ.setdefault("KERAS_BACKEND", "torch")
    import keras

    return keras


def _np(x) -> np.ndarray:
    if not isinstance(x, np.ndarray):
        x = _keras().ops.convert_to_numpy(x)
    return np.asarray(x, dtype=np.float32)


# --------------------------------------------------------------------------
# The reference graph
# --------------------------------------------------------------------------


def build_keras_leafcnn(model: LeafCNN, img_size: int):
    """The reference's Keras graph for `model`'s architecture: the augment
    Sequential (RandomFlip, RandomRotation, RandomContrast: no-ops at
    inference, kept so the saved graph is the reference's), the s2d stem as
    Reshape → Permute → Reshape (no custom objects), and the weighted
    layers named `fx__<flax path>`."""
    keras = _keras()
    from keras import layers

    inputs = layers.Input((img_size, img_size, 3))
    x = keras.Sequential(
        [
            layers.RandomFlip("horizontal"),
            layers.RandomRotation(0.05),
            layers.RandomContrast(0.1),
        ],
        name="augment",
    )(inputs)
    if model.use_norm:
        x = layers.Normalization(axis=-1, name="input_norm",
                                 mean=[0.0, 0.0, 0.0],
                                 variance=[1.0, 1.0, 1.0])(x)

    if model.stem == "s2d":
        h = img_size // 2
        x = layers.Reshape((h, 2, h, 2, 3))(x)
        x = layers.Permute((1, 3, 2, 4, 5))(x)
        x = layers.Reshape((h, h, 12))(x)

    def conv_block(x, filters: int, path: str):
        if model.separable:
            x = layers.SeparableConv2D(filters, 3, padding="same",
                                       use_bias=False,
                                       name=f"{_FX}{path}__sepconv")(x)
        else:
            x = layers.Conv2D(filters, 3, padding="same", use_bias=False,
                              name=f"{_FX}{path}__Conv_0")(x)
        x = layers.BatchNormalization(
            name=f"{_FX}{path}__BatchNorm_0")(x)
        return layers.Activation("relu")(x)

    def res_block(x, filters: int, path: str):
        shortcut = x
        y = conv_block(x, filters, f"{path}__ConvBlock_0")
        y = conv_block(y, filters, f"{path}__ConvBlock_1")
        if model.use_se:
            c = int(y.shape[-1])
            se = layers.GlobalAveragePooling2D(keepdims=True)(y)
            se = layers.Conv2D(max(c // 8, 1), 1, activation="relu",
                               name=f"{_FX}{path}__SEBlock_0__Conv_0")(se)
            se = layers.Conv2D(c, 1, activation="sigmoid",
                               name=f"{_FX}{path}__SEBlock_0__Conv_1")(se)
            y = layers.Multiply()([y, se])
        if shortcut.shape[-1] != y.shape[-1]:
            proj = layers.Conv2D(filters, 1, padding="same", use_bias=False,
                                 name=f"{_FX}{path}__Conv_0")(shortcut)
            shortcut = layers.BatchNormalization(
                name=f"{_FX}{path}__BatchNorm_0")(proj)
        return layers.Activation("relu")(layers.Add()([shortcut, y]))

    x = conv_block(x, model.widths[0], "ConvBlock_0")
    for i, f in enumerate(model.widths):
        x = res_block(x, f, f"ResBlock_{i}")
        if model.drop_block > 0:
            x = layers.SpatialDropout2D(rate=model.drop_block)(x)
        if model.stem == "s2d" and i == 0:
            continue  # downsample folded into the stem
        x = layers.MaxPool2D(pool_size=2)(x)

    x = layers.GlobalAveragePooling2D()(x)
    if model.drop_top > 0:
        x = layers.Dropout(model.drop_top)(x)
    outputs = layers.Dense(model.num_classes, activation="softmax",
                           name=f"{_FX}Dense_0")(x)
    return keras.Model(inputs, outputs, name="leaf_cnn")


# --------------------------------------------------------------------------
# Flax path helpers
# --------------------------------------------------------------------------


def _parse_fx_name(name: str) -> List[str]:
    assert name.startswith(_FX), name
    return name[len(_FX):].split("__")


def _get_path(tree: Dict, parts: List[str]) -> Any:
    for p in parts:
        tree = tree[p]
    return tree


def _set_path(tree: Dict, parts: List[str], value: Any) -> None:
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


def _flax_weights_for(name: str, params: Dict, stats: Dict
                      ) -> List[np.ndarray]:
    """Keras `set_weights` list for the fx-named layer, from the flax
    tree."""
    parts = _parse_fx_name(name)
    kind = parts[-1]
    if kind == "sepconv":
        block = _get_path(params, parts[:-1])
        dw = _np(block["Conv_0"]["kernel"]).transpose(0, 1, 3, 2)  # (k,k,C,1)
        return [dw, _np(block["Conv_1"]["kernel"])]
    if kind == "BatchNorm_0":
        p = _get_path(params, parts)
        s = _get_path(stats, parts)
        return [_np(p["scale"]), _np(p["bias"]),
                _np(s["mean"]), _np(s["var"])]
    node = _get_path(params, parts)  # Conv_{0,1} / Dense_0
    out = [_np(node["kernel"])]
    if "bias" in node:
        out.append(_np(node["bias"]))
    return out


def _store_flax_weights(name: str, weights: List[np.ndarray],
                        params: Dict, stats: Dict) -> None:
    """Inverse of `_flax_weights_for`: write Keras weights into flax
    trees."""
    parts = _parse_fx_name(name)
    kind = parts[-1]
    if kind == "sepconv":
        dw, pw = weights
        _set_path(params, parts[:-1] + ["Conv_0"],
                  {"kernel": dw.transpose(0, 1, 3, 2)})
        _set_path(params, parts[:-1] + ["Conv_1"], {"kernel": pw})
        return
    if kind == "BatchNorm_0":
        gamma, beta, mmean, mvar = weights
        _set_path(params, parts, {"scale": gamma, "bias": beta})
        _set_path(stats, parts, {"mean": mmean, "var": mvar})
        return
    node: Dict[str, np.ndarray] = {"kernel": weights[0]}
    if len(weights) > 1:
        node["bias"] = weights[1]
    _set_path(params, parts, node)


def _weighted_layers(kmodel) -> List[Any]:
    """Weighted layers of a functional leaf_cnn, without the augment
    Sequential (seed-generator state) and the Normalization (its stats
    are config). Keras's topological order."""
    keras = _keras()
    from keras import layers

    out = []
    for layer in kmodel.layers:
        if isinstance(layer, (keras.Sequential, layers.Normalization)):
            continue
        if layer.get_weights():
            out.append(layer)
    return out


# --------------------------------------------------------------------------
# Export
# --------------------------------------------------------------------------


def export_keras(model: LeafCNN, state_dict: Dict[str, torch.Tensor],
                 img_size: int, path: Path) -> Path:
    """Write `path` (.keras) with the weights of `state_dict` (a full,
    unsharded state dict of `model`'s architecture, on any device). Raises
    ImportError when keras is unavailable: gate on `keras_available()`."""
    keras = _keras()

    variables = to_flax(state_dict)
    kmodel = build_keras_leafcnn(model, img_size)

    if model.use_norm:
        ns = variables.get("norm_stats") or {}
        mean = _np(ns.get("mean", np.zeros(3)))
        var = _np(ns.get("var", np.ones(3))) + _NORM_EPS
        # rebuild input_norm with the adapted stats (Normalization freezes
        # mean/variance at construction: they are config, not weights)
        cfg = kmodel.get_config()
        for lcfg in cfg["layers"]:
            if lcfg["config"].get("name") == "input_norm":
                lcfg["config"]["mean"] = mean.tolist()
                lcfg["config"]["variance"] = var.tolist()
        kmodel = keras.Model.from_config(cfg)

    params = variables["params"]
    stats = variables.get("batch_stats", {})
    for layer in _weighted_layers(kmodel):
        ws = _flax_weights_for(layer.name, params, stats)
        have = [tuple(w.shape) for w in layer.get_weights()]
        want = [tuple(w.shape) for w in ws]
        if have != want:
            raise RuntimeError(
                f"keras export: shape mismatch at {layer.name}: "
                f"{have} vs {want}")
        layer.set_weights(ws)

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    kmodel.save(path)
    LOGGER.info("Keras model exported to %s", path)
    return path


# --------------------------------------------------------------------------
# Import (reference-trained or exported files)
# --------------------------------------------------------------------------


def _infer_architecture(kmodel) -> Tuple[LeafCNN, Dict[str, Any]]:
    """(LeafCNN matching the graph, norm_stats) inferred from layer types
    and shapes only: no names, no meta.json."""
    from keras import layers

    norm_stats: Dict[str, Any] = {}
    drop_block, drop_top, stem = 0.0, 0.0, "conv"
    use_se = False
    widths3: List[int] = []
    num_classes = 0
    separable = False

    for layer in kmodel.layers:
        if isinstance(layer, layers.Normalization):
            mean = _np(layer.mean).reshape(-1)
            var = np.maximum(_np(layer.variance).reshape(-1) - _NORM_EPS, 0.0)
            norm_stats = {"mean": mean, "var": var}
        elif isinstance(layer, layers.SpatialDropout2D):
            drop_block = float(layer.rate)
        elif isinstance(layer, layers.Dropout):
            drop_top = float(layer.rate)
        elif isinstance(layer, layers.Permute):
            stem = "s2d"
        elif isinstance(layer, layers.SeparableConv2D):
            separable = True
            widths3.append(int(layer.get_weights()[1].shape[-1]))
        elif isinstance(layer, layers.Dense):
            num_classes = int(layer.get_weights()[0].shape[1])
        elif isinstance(layer, layers.Conv2D):
            k = layer.get_weights()[0]
            if k.shape[:2] == (3, 3):
                widths3.append(int(k.shape[3]))
            elif len(layer.get_weights()) == 2:
                use_se = True  # biased 1x1 conv pair = squeeze/excite

    # 3x3 convs appear as [stem, b0c0, b0c1, b1c0, b1c1, ...] in the
    # (depth-sorted) layer list; block i's convs share out-channels.
    n_blocks = (len(widths3) - 1) // 2
    widths = tuple(widths3[1 + 2 * i] for i in range(n_blocks))
    if not widths or num_classes <= 0:
        raise RuntimeError(
            "keras import: could not infer a leaf_cnn architecture "
            f"(widths={widths3}, classes={num_classes})")

    model = LeafCNN(
        num_classes=num_classes,
        widths=widths,
        drop_block=drop_block,
        drop_top=drop_top,
        separable=separable,
        use_se=use_se,
        use_norm=bool(norm_stats),
        stem=stem,
    )
    return model, norm_stats


def import_keras(path: Path, dtype: Optional[torch.dtype] = None
                 ) -> Tuple[LeafCNN, Dict[str, torch.Tensor]]:
    """Load a `.keras` leaf_cnn (reference-trained or exported) → (LeafCNN
    on the CPU holding its weights, computing in `dtype` (f32 by default),
    and its state dict). Alignment goes through a rebuilt template graph,
    so the file's layer names never matter."""
    keras = _keras()

    kmodel = keras.models.load_model(Path(path), compile=False)
    model, norm_stats = _infer_architecture(kmodel)

    img_size = int(kmodel.inputs[0].shape[1])
    template = build_keras_leafcnn(model, img_size)
    tmpl_layers = _weighted_layers(template)
    src_layers = _weighted_layers(kmodel)
    if len(tmpl_layers) != len(src_layers):
        raise RuntimeError(
            f"keras import: {len(src_layers)} weighted layers in file vs "
            f"{len(tmpl_layers)} in the inferred architecture "
            f"(widths {model.widths})")

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for tmpl, src in zip(tmpl_layers, src_layers):
        t_shapes = [tuple(w.shape) for w in tmpl.get_weights()]
        s_shapes = [tuple(w.shape) for w in src.get_weights()]
        if type(tmpl) is not type(src) or t_shapes != s_shapes:
            raise RuntimeError(
                "keras import: graph mismatch at "
                f"{tmpl.name} vs {src.name}: {t_shapes} vs {s_shapes}")
        _store_flax_weights(tmpl.name,
                            [_np(w) for w in src.get_weights()],
                            params, stats)

    variables: Dict[str, Any] = {"params": params, "batch_stats": stats}
    if norm_stats:
        variables["norm_stats"] = norm_stats
    state_dict = to_state_dict(variables)
    if dtype is not None and dtype != model.dtype:
        model = LeafCNN(model.num_classes, model.widths,
                        separable=model.separable, use_norm=model.use_norm,
                        stem=model.stem, dtype=dtype,
                        drop_block=model.drop_block,
                        drop_top=model.drop_top, use_se=model.use_se)
    model.load_state_dict(state_dict)
    LOGGER.info("Keras model imported from %s (%d classes, widths=%s)",
                path, model.num_classes, list(model.widths))
    return model, state_dict
