"""The port's `.keras` artifact (`leaffliction_tpu_torch/train/keras_export.py`
and the `.keras` branch of `predict/model_loader.py`), held against the JAX
package's `train/keras_export.py` on the CPU.

The same variables (a JAX init tree given distinct values, so a mis-mapped
weight cannot cancel out) go through JAX's `export_keras` and, through
`convert.to_state_dict`, the port's: every weighted layer of the two files
holds the same weights, exactly, and the input normalisation the same
statistics. keras's own `predict` on the port's file is within 2e-5 of the
port's f32 forward, and `import_keras` gives back the architecture and
probabilities within 1e-6. A JAX-exported artifact dir is served by the
port's `ModelLoader` and `Predictor` within 1e-4 of JAX's (f32; only the
summation order differs).

keras keeps the backend of whichever module imported it first in a
process (the JAX package asks for `jax`, the port for `torch`), so these
tests compare only numpy weights and keras's `predict`, which hold under
either backend. Skipped when keras is not importable.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from conftest import _leafish_image  # noqa: E402
from leaffliction_tpu.models.leafcnn import LeafCNN as JaxLeafCNN  # noqa: E402
from leaffliction_tpu.models.leafcnn import init_model as jax_init  # noqa: E402
from leaffliction_tpu.predict.model_loader import (  # noqa: E402
    ModelLoader as JaxModelLoader,
)
from leaffliction_tpu.predict.predictor import Predictor as JaxPredictor  # noqa: E402
from leaffliction_tpu.train import keras_export as jax_kx  # noqa: E402
from leaffliction_tpu_torch.convert import to_state_dict  # noqa: E402
from leaffliction_tpu_torch.models.leafcnn import LeafCNN  # noqa: E402
from leaffliction_tpu_torch.predict.model_loader import ModelLoader  # noqa: E402
from leaffliction_tpu_torch.predict.predictor import Predictor  # noqa: E402
from leaffliction_tpu_torch.train import keras_export as kx  # noqa: E402
import jax_native  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """The JAX side decodes through its JPEG helper loaded whole, or
    both sides through PIL (`tests/jax_native.py`)."""
    jax_native.ready()


pytestmark = pytest.mark.skipif(not kx.keras_available(),
                                reason="keras not importable")

torch.set_num_threads(1)

IMG = 32
WIDTHS = (16, 32, 64)  # the tiny preset
# (separable, stem, use_se), the last with the SE blocks left out
CASES = [(False, "conv", True), (True, "conv", True), (False, "s2d", True),
         (False, "conv", False)]
CASE_IDS = ["plain", "separable", "s2d", "no_se"]


def _models(separable, stem, use_se, classes=5):
    """(JAX LeafCNN, the port's) of one architecture, f32, the tiny
    preset's dropout rates (the plain layout on the JAX side)."""
    kw = dict(num_classes=classes, widths=WIDTHS, drop_block=0.10,
              drop_top=0.30, separable=separable, use_se=use_se, stem=stem)
    return JaxLeafCNN(lane_fold=False, **kw), LeafCNN(**kw)


def _randomized_variables(model, seed: int = 0):
    """Init variables with every leaf given a distinct value (fresh
    BatchNorm statistics are 0 and 1, and biases 0, which would hide
    swaps): each init value scaled by U(0.5, 1.5) plus N(0, 0.05), the
    statistics drawn, variances kept positive; the head's kernel scaled
    by 0.05, so that the probabilities of random weights do not saturate
    and the comparisons of probabilities have teeth."""
    params, batch_stats, _ = jax_init(model, IMG, seed)
    rng = np.random.default_rng(seed + 1)

    def jitter(leaf):
        leaf = np.asarray(leaf, np.float32)
        return (leaf * rng.uniform(0.5, 1.5, leaf.shape)
                + rng.normal(0.0, 0.05, leaf.shape)).astype(np.float32)

    def stats(tree):
        if isinstance(tree, dict):
            return {k: (rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                        if k == "var" else
                        rng.normal(0.0, 0.1, v.shape).astype(np.float32)
                        if k == "mean" else stats(v))
                    for k, v in tree.items()}
        return tree

    params = jax.tree_util.tree_map(jitter, params)
    params["Dense_0"]["kernel"] = params["Dense_0"]["kernel"] * 0.05
    return {
        "params": params,
        "batch_stats": stats(batch_stats),
        "norm_stats": {
            "mean": np.asarray(rng.normal(0.4, 0.1, (3,)), np.float32),
            "var": np.asarray(np.abs(rng.normal(0.05, 0.02, (3,))) + 0.01,
                              np.float32),
        },
    }


def _port_model(model, variables):
    model.load_state_dict(to_state_dict(variables))
    return model.eval()


def _port_probs(model, x):
    with torch.no_grad():
        return torch.softmax(model(torch.from_numpy(x)), -1).numpy()


def _jax_probs(model, variables, x):
    logits = model.apply(variables, jnp.asarray(x), train=False)
    return np.asarray(jax.nn.softmax(logits, axis=-1))


def _inputs(seed=3, n=4):
    return np.random.default_rng(seed).uniform(0, 1, (n, IMG, IMG, 3)
                                               ).astype(np.float32)


def _layer_weights(path):
    """{layer name: [weights]} of a saved leaf_cnn's weighted layers, and
    input_norm's (mean, variance) config."""
    import keras

    kmodel = keras.models.load_model(path, compile=False)
    weights = {layer.name: layer.get_weights()
               for layer in kx._weighted_layers(kmodel)}
    norm = [kx._np(getattr(layer, k)).reshape(-1)
            for layer in kmodel.layers if layer.name == "input_norm"
            for k in ("mean", "variance")]
    return weights, norm


@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def exported(request, tmp_path_factory):
    """Both packages' exports of one architecture's variables."""
    separable, stem, use_se = request.param
    jax_model, port_model = _models(separable, stem, use_se)
    variables = _randomized_variables(jax_model)
    port_model = _port_model(port_model, variables)
    d = tmp_path_factory.mktemp("keras")
    jax_path = jax_kx.export_keras(jax_model, variables, IMG,
                                   d / "jax" / "leaf_cnn.keras")
    port_path = kx.export_keras(port_model, port_model.state_dict(), IMG,
                                d / "port" / "leaf_cnn.keras")
    return {"case": request.param, "jax_model": jax_model,
            "variables": variables, "model": port_model,
            "jax_path": jax_path, "path": port_path}


def test_export_weights_equal_the_jax_export(exported):
    ours, our_norm = _layer_weights(exported["path"])
    ref, ref_norm = _layer_weights(exported["jax_path"])
    assert sorted(ours) == sorted(ref)
    assert any("SEBlock_0" in n for n in ours) == exported["case"][2]
    for name, ws in ref.items():
        assert len(ours[name]) == len(ws), name
        for got, want in zip(ours[name], ws):
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert len(our_norm) == 2
    for got, want in zip(our_norm, ref_norm):
        np.testing.assert_array_equal(got, want)


def test_keras_predict_matches_the_port_forward(exported):
    """keras's own forward of the port's file against the port's f32
    forward; the port's forward itself against JAX's (the `use_se=False`
    case included)."""
    import keras

    x = _inputs()
    want = _port_probs(exported["model"], x)
    assert want.max() < 0.999  # not saturated: the comparison has teeth
    np.testing.assert_allclose(
        want, _jax_probs(exported["jax_model"], exported["variables"], x),
        rtol=0, atol=1e-5)
    kmodel = keras.models.load_model(exported["path"], compile=False)
    got = np.asarray(kmodel.predict(x, verbose=0))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_import_gives_back_the_architecture(exported):
    model = exported["model"]
    imported, state_dict = kx.import_keras(exported["path"])
    for field in ("widths", "separable", "use_se", "stem", "num_classes",
                  "use_norm", "drop_block", "drop_top"):
        assert getattr(imported, field) == getattr(model, field), field
    assert imported.dtype == torch.float32
    assert state_dict.keys() == model.state_dict().keys()
    x = _inputs()
    np.testing.assert_allclose(_port_probs(imported.eval(), x),
                               _port_probs(model, x), rtol=0, atol=1e-6)


def test_use_se_false_has_no_se_block():
    _, model = _models(False, "conv", False)
    assert not any("SEBlock" in k for k in model.state_dict())
    _, with_se = _models(False, "conv", True)
    assert any("SEBlock" in k for k in with_se.state_dict())


LABELS = ["a", "b", "c"]


def _keras_dir(root, seed, model_file=None, mixed_precision=False):
    """An artifact dir the JAX package exported: `leaf_cnn.keras` and a
    meta.json pointing at it (`model_file`, default its absolute path)."""
    jax_model, _ = _models(False, "conv", True, classes=len(LABELS))
    variables = _randomized_variables(jax_model, seed)
    root.mkdir(parents=True, exist_ok=True)
    kpath = jax_kx.export_keras(jax_model, variables, IMG,
                                root / "leaf_cnn.keras")
    (root / "meta.json").write_text(json.dumps({
        "model_file": model_file or str(kpath),
        "labels": LABELS,
        "data": {"img_size": IMG, "num_classes": len(LABELS)},
        "training": {"mixed_precision": mixed_precision},
    }))
    return jax_model, variables


def test_loader_and_predictor_serve_a_jax_exported_dir(tmp_path):
    """The port's `ModelLoader` and `Predictor` on a `.keras` dir the JAX
    package exported, against JAX's loader and predictor: f32, the JAX
    loader's probabilities within 1e-4, same top-1 on JPEGs."""
    _keras_dir(tmp_path / "learn", seed=4)
    loader = ModelLoader(tmp_path / "learn", device="cpu").load()
    jl = JaxModelLoader(tmp_path / "learn").load()
    assert loader.num_classes == 3 and loader.img_size == IMG
    assert loader.model.dtype == torch.float32 and not loader.model.training
    x = _inputs(9, 2)
    np.testing.assert_allclose(_port_probs(loader.model, x),
                               _jax_probs(jl.model, jl.variables, x),
                               rtol=0, atol=1e-4)
    rng = np.random.default_rng(11)
    images = []
    for i in range(4):
        images.append(tmp_path / f"leaf{i}.jpg")
        Image.fromarray(_leafish_image(rng, 48)).save(images[-1], quality=95)
    ours = Predictor(tmp_path / "learn", device="cpu").load().predict_batch(
        images)
    ref = JaxPredictor(tmp_path / "learn").load().predict_batch(images)
    for a, b in zip(ours, ref):
        assert a["top_prediction"] == b["top_prediction"]
        np.testing.assert_allclose(
            [a["all_probabilities"][k] for k in LABELS],
            [b["all_probabilities"][k] for k in LABELS], rtol=0, atol=1e-4)


def test_loader_computes_in_bf16_when_meta_asks(tmp_path):
    _keras_dir(tmp_path, seed=4, mixed_precision=True)
    assert ModelLoader(tmp_path, device="cpu").load().model.dtype == \
        torch.bfloat16


def test_loader_refuses_a_head_wider_than_the_labels(tmp_path):
    _keras_dir(tmp_path, seed=4)
    meta = json.loads((tmp_path / "meta.json").read_text())
    meta["labels"] = LABELS[:2]
    (tmp_path / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="3-wide"):
        ModelLoader(tmp_path, device="cpu").load()
    with pytest.raises(ValueError, match="3-wide"):
        JaxModelLoader(tmp_path).load()


def test_model_file_resolution_prefers_learnings_dir(tmp_path, monkeypatch):
    """A relative `model_file` resolves against the learnings dir, not the
    caller's cwd: a different model at the same relative path under the
    cwd does not shadow the directory the user pointed at."""
    rel = "artifacts/models/leaf_cnn.keras"
    _keras_dir(tmp_path / "cwd" / "artifacts" / "models", 1, rel)  # decoy
    jax_model, variables = _keras_dir(tmp_path / "learnings", 2, rel)
    monkeypatch.chdir(tmp_path / "cwd")
    loader = ModelLoader(tmp_path / "learnings", device="cpu").load()
    x = _inputs(9, 2)
    np.testing.assert_allclose(_port_probs(loader.model, x),
                               _jax_probs(jax_model, variables, x),
                               rtol=0, atol=1e-4)


def test_import_of_reference_built_keras_model(tmp_path):
    """A model built by the reference's own `srcs/model/cnn.py` (from the
    checkout named by LEAF_REFERENCE_ROOT, not copied), its Normalization
    adapted and saved the reference's way, imported by the port: Keras's
    probabilities within 2e-5. Skipped without the reference."""
    root = os.environ.get("LEAF_REFERENCE_ROOT")
    if not root:
        pytest.skip("reference model not available (LEAF_REFERENCE_ROOT "
                    "unset)")
    sys.path.insert(0, root)
    try:
        from srcs.model.cnn import build_leafcnn as ref_build
    except Exception as exc:  # the environment's
        pytest.skip(f"reference model not importable: {exc}")
    finally:
        sys.path.remove(root)

    ref_model, norm_layer = ref_build(num_classes=4, img_size=IMG,
                                      widths=[16, 32], separable=False)
    rng = np.random.default_rng(5)
    norm_layer.adapt(rng.uniform(0, 1, (64, IMG, IMG, 3)).astype(np.float32))
    path = tmp_path / "leaf_cnn.keras"
    ref_model.save(path)
    x = rng.uniform(0, 1, (4, IMG, IMG, 3)).astype(np.float32)
    want = np.asarray(ref_model.predict(x, verbose=0))
    imported, _ = kx.import_keras(path)
    assert imported.widths == (16, 32)
    np.testing.assert_allclose(_port_probs(imported.eval(), x), want,
                               rtol=0, atol=2e-5)
