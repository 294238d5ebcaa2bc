"""Serving in the PyTorch port, held against the JAX package.

An artifact dir (`leaf_cnn.msgpack` written by the JAX package's
`save_model_msgpack`, plus `meta.json`) is served by both predictors on the
same JPEGs: same top-1, probabilities at atol 1e-4 with f32 compute (only
the summation order differs) and 2e-2 with bf16 compute (8-bit mantissa).
The port's CLI in batch mode writes a `batch_results.json` of the JAX CLI's
schema, and `--device cuda` without CUDA fails instead of using the CPU.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from flax import serialization  # noqa: E402
from PIL import Image  # noqa: E402

from conftest import _leafish_image  # noqa: E402
from leaffliction_tpu.cli import predict as jax_cli  # noqa: E402
from leaffliction_tpu.models.leafcnn import build_leafcnn  # noqa: E402
from leaffliction_tpu.models.leafcnn import init_model  # noqa: E402
from leaffliction_tpu.predict.predictor import Predictor as JaxPredictor  # noqa: E402
from leaffliction_tpu.train.checkpoint import save_model_msgpack  # noqa: E402
from leaffliction_tpu_torch.cli import predict as torch_cli  # noqa: E402
from leaffliction_tpu_torch.predict.predictor import Predictor  # noqa: E402
from leaffliction_tpu_torch.train import checkpoint as torch_ckpt  # noqa: E402
import jax_native  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """The JAX side decodes through its JPEG helper loaded whole, or
    both sides through PIL (`tests/jax_native.py`)."""
    jax_native.ready()


torch.set_num_threads(1)

LABELS = ["Apple_healthy", "Apple_rust", "Grape_spot", "Grape_healthy"]
SIZE = 32


def _write_artifacts(path, mixed_precision):
    model = build_leafcnn(len(LABELS), "tiny")
    params, stats, norm = init_model(model, SIZE, seed=5)
    rng = np.random.default_rng(5)
    stats = jax.tree_util.tree_map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32), stats)
    norm = {"mean": np.full(3, 0.45, np.float32),
            "var": np.full(3, 0.07, np.float32)}
    save_model_msgpack(path / "leaf_cnn.msgpack", params, stats, norm)
    meta = {
        "model_file": "leaf_cnn.msgpack",
        "labels": LABELS,
        "data": {"img_size": SIZE, "num_classes": len(LABELS)},
        "model": {"name": "leaf_cnn", "widths": [16, 32, 64],
                  "separable": False, "use_normalization": True,
                  "stem": "conv"},
        "training": {"mixed_precision": mixed_precision},
    }
    (path / "meta.json").write_text(json.dumps(meta))
    return path


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(11)
    for i in range(6):
        Image.fromarray(_leafish_image(rng, 48)).save(root / f"leaf{i}.jpg",
                                                      quality=95)
    return sorted(root.glob("*.jpg"))


@pytest.mark.parametrize("mixed_precision,atol", [(False, 1e-4),
                                                  (True, 2e-2)])
def test_predict_batch_matches_jax(tmp_path, images, mixed_precision, atol):
    learn = _write_artifacts(tmp_path, mixed_precision)
    ours = Predictor(learn, device="cpu").load().predict_batch(images)
    ref = JaxPredictor(learn).load().predict_batch(images)
    assert [r["image_path"] for r in ours] == [r["image_path"] for r in ref]
    for a, b in zip(ours, ref):
        assert a["top_prediction"] == b["top_prediction"]
        np.testing.assert_allclose(
            [a["all_probabilities"][k] for k in LABELS],
            [b["all_probabilities"][k] for k in LABELS], rtol=0, atol=atol)


def test_from_model_serves_like_load(tmp_path):
    """`Predictor.from_model` (an in-memory model, no artifact dir) gives the
    probabilities of the loaded path, padding a 70-image input over two
    serving chunks."""
    learn = _write_artifacts(tmp_path, False)
    loaded = Predictor(learn, device="cpu").load()
    model = loaded.model_loader.model
    arrays = np.random.default_rng(2).integers(0, 256, (70, SIZE, SIZE, 3),
                                               dtype=np.uint8)
    direct = Predictor.from_model(model, LABELS, SIZE, device="cpu")
    assert direct.model_loader.img_size == SIZE
    assert direct.model_loader.labels == LABELS
    got = direct._probs_for_arrays(arrays)
    assert got.shape == (70, len(LABELS))
    np.testing.assert_array_equal(got, loaded._probs_for_arrays(arrays))
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=1e-5)


def test_cli_evaluate_writes_jax_schema(tmp_path, images, monkeypatch):
    """`--evaluate` (target 0, so the first sample passes) writes
    `evaluation_results.json` with the JAX CLI's keys."""
    (tmp_path / "model").mkdir()
    learn = _write_artifacts(tmp_path / "model", False)
    manifest = tmp_path / "manifest.json"
    manifest.write_text(json.dumps({"items": [
        {"src": str(p), "label": LABELS[i % 2], "split": "val"}
        for i, p in enumerate(images)]}))
    monkeypatch.chdir(tmp_path)
    outs = {}
    for name, cli, extra in (("ours", torch_cli, ["--device", "cpu"]),
                             ("ref", jax_cli, [])):
        out_dir = tmp_path / name
        cli.main([str(images[0].parent), "--batch-mode", "--evaluate",
                  "--manifest", str(manifest), "--target-acc", "0",
                  "-learnings", str(learn), "-out", str(out_dir),
                  "-json", str(tmp_path / f"{name}.json"), *extra])
        outs[name] = json.loads(
            (out_dir / "evaluation" / "evaluation_results.json").read_text())
    ours, ref = outs["ours"], outs["ref"]
    assert set(ours) == set(ref)
    assert set(ours["metrics"]) == set(ref["metrics"])
    assert ours["evaluation_info"] == ref["evaluation_info"]
    # each CLI samples in a clock-seeded order: compare as sets of pairs
    assert sorted((r["image_path"], r["predicted_label"])
                  for r in ours["detailed_results"]) == \
        sorted((r["image_path"], r["predicted_label"])
               for r in ref["detailed_results"])


def test_checkpoint_reader_and_writer_match_flax(tmp_path):
    learn = _write_artifacts(tmp_path, False)
    data = (learn / "leaf_cnn.msgpack").read_bytes()
    ref = serialization.msgpack_restore(data)
    ours = torch_ckpt.load_model_msgpack(learn / "leaf_cnn.msgpack")
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    flat_ours = jax.tree_util.tree_leaves_with_path(ours)
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_ours]
    for (_, a), (_, b) in zip(flat_ours, flat_ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    torch_ckpt.save_model_msgpack(tmp_path / "again.msgpack", ours)
    assert (tmp_path / "again.msgpack").read_bytes() == data


def test_cli_batch_mode_writes_jax_schema(tmp_path, images, monkeypatch):
    (tmp_path / "model").mkdir()
    learn = _write_artifacts(tmp_path / "model", False)
    monkeypatch.chdir(tmp_path)
    img_dir = images[0].parent
    ours_json = tmp_path / "ours.json"
    ref_json = tmp_path / "ref.json"
    torch_cli.main([str(img_dir), "--batch-mode", "--device", "cpu",
                    "-learnings", str(learn), "-json", str(ours_json)])
    jax_cli.main([str(img_dir), "--batch-mode", "-learnings", str(learn),
                  "-json", str(ref_json)])
    ours = json.loads(ours_json.read_text())
    ref = json.loads(ref_json.read_text())
    assert set(ours) == set(ref) == {"batch_results", "summary"}
    assert set(ours["summary"]) == set(ref["summary"])
    assert len(ours["batch_results"]) == len(ref["batch_results"]) == 6
    for a, b in zip(ours["batch_results"], ref["batch_results"]):
        assert set(a) == set(b)
        assert a["image_path"] == b["image_path"]
        assert a["top_prediction"] == b["top_prediction"]


def test_cli_device_cuda_without_cuda_fails(tmp_path, images, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    learn = _write_artifacts(tmp_path, False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        torch_cli.main([str(images[0]), "--device", "cuda",
                        "-learnings", str(learn)])
    assert exc.value.code != 0
    assert not (tmp_path / "artifacts").exists()  # nothing ran on the CPU
