"""The PyTorch port's train CLI end to end on the CPU, held against the JAX
package's artifacts.

`python -m leaffliction_tpu_torch.cli.train` (in process) trains conftest's
`tiny_dataset` for 2 epochs at 32 px with `--device cpu
--no-mixed-precision`. Its artifact set and `meta.json` schema must equal
what the JAX package's `save_training_artifacts` writes for a JAX
`create_train_state` state (the only documented difference: `torch_version`
and `cuda_version` in place of `jax_version` and `flax_version`), its
`labels.json` must be byte-equal, and the JAX `ModelLoader` must load its
`leaf_cnn.msgpack` and give the port's eval logits within 1e-4 (f32; only
the summation order differs). Where keras is importable, both CLIs also
write `leaf_cnn.keras` by default and record it in `meta.json` as
`keras_file` (the JAX writer `save_training_artifacts` does not: the CLI
adds them), so the port's run is held to that too, and against the JAX
CLI at its defaults.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from leaffliction_tpu.cli import split as split_cli  # noqa: E402
from leaffliction_tpu.core.sysinfo import get_system_info  # noqa: E402
from leaffliction_tpu.models.leafcnn import build_leafcnn  # noqa: E402
from leaffliction_tpu.predict.model_loader import (  # noqa: E402
    ModelLoader as JaxModelLoader,
)
from leaffliction_tpu.train.artifacts import (  # noqa: E402
    save_training_artifacts as jax_save,
)
from leaffliction_tpu.train.checkpoint import (  # noqa: E402
    load_model_msgpack as jax_load_msgpack,
)
from leaffliction_tpu.train.config import TrainConfig  # noqa: E402
from leaffliction_tpu.train.keras_export import (  # noqa: E402
    keras_available,
)
from leaffliction_tpu.train.steps import create_train_state  # noqa: E402
from leaffliction_tpu.data.manifest import load_manifest  # noqa: E402
from leaffliction_tpu_torch.cli import train as train_cli  # noqa: E402
from leaffliction_tpu_torch.data.manifest import (  # noqa: E402
    write_split_manifest,
)
from leaffliction_tpu_torch.predict.model_loader import ModelLoader  # noqa: E402
import jax_native  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """The JAX side decodes through its JPEG helper loaded whole, or
    both sides through PIL (`tests/jax_native.py`)."""
    jax_native.ready()


torch.set_num_threads(1)

VERSION_KEYS = {"jax_version", "flax_version", "torch_version",
                "cuda_version"}
ARTIFACTS = ("leaf_cnn.msgpack", "labels.json", "history.json", "meta.json",
             "confusion_matrix.json")
# what the CLI adds to the writer's artifacts by default (keras importable)
KERAS = ("leaf_cnn.keras",) if keras_available() else ()


@pytest.fixture(scope="module")
def manifest(tiny_dataset, tmp_path_factory):
    out = tmp_path_factory.mktemp("split")
    split_cli.main(["--src", str(tiny_dataset), "--out", str(out),
                    "--val-ratio", "0.25", "--seed", "32"])
    return out / "manifest_split.json"


def _train(manifest, out_dir, *extra):
    train_cli.main(["--manifest", str(manifest), "--epochs", "2",
                    "--batch-size", "8", "--img-size", "32",
                    "--scale", "tiny", "--device", "cpu",
                    "--no-mixed-precision", "--out-dir", str(out_dir),
                    *extra])
    return out_dir


@pytest.fixture(scope="module")
def trained(manifest, tmp_path_factory):
    return _train(manifest, tmp_path_factory.mktemp("port_models"))


@pytest.fixture(scope="module")
def jax_written(trained, tmp_path_factory):
    """The JAX writer's artifact dir for a fresh JAX state of the same
    model, fed the run/data/model/training blocks of the port's meta and a
    JAX system block."""
    port_meta = json.loads((trained / "meta.json").read_text())
    label2idx = json.loads((trained / "labels.json").read_text())[
        "label2idx"]
    history = json.loads((trained / "history.json").read_text())
    model = build_leafcnn(len(label2idx), "tiny")
    state = create_train_state(model, TrainConfig.regularized(), 32, 0)
    meta = {k: port_meta[k] for k in ("run", "data", "model", "training")}
    meta["system"] = dict(get_system_info(), mesh={"data": 1, "model": 1})
    out = tmp_path_factory.mktemp("jax_models")
    jax_save(out, state, label2idx, history, "base",
             np.array([0, 1]), np.array([0, 1]), meta=meta)
    return out


def _schema(value):
    """Key structure and leaf types of a JSON value (lists by element)."""
    if isinstance(value, dict):
        return {k: _schema(v) for k, v in value.items()}
    if isinstance(value, list):
        return ["list", sorted({json.dumps(_schema(v)) for v in value})]
    if isinstance(value, bool) or value is None:
        return type(value).__name__
    return "number" if isinstance(value, (int, float)) else \
        type(value).__name__


def test_split_manifest_equals_split_cli(manifest, tiny_dataset, tmp_path):
    """The port's manifest writer gives the split CLI's items and meta keys
    (the creation time aside)."""
    path = tmp_path / "manifest_split.json"
    assert write_split_manifest(tiny_dataset, path, val_ratio=0.25,
                                seed=32) == 37
    meta, items = load_manifest(path)
    ref_meta, ref_items = load_manifest(manifest)
    assert items == ref_items
    assert {k: v for k, v in meta.items() if k != "created_at"} == \
        {k: v for k, v in ref_meta.items() if k != "created_at"}


def test_artifact_set_and_history(trained):
    for name in ARTIFACTS + KERAS:
        assert (trained / name).exists(), name
    history = json.loads((trained / "history.json").read_text())
    assert set(history) == {"loss", "accuracy", "val_loss", "val_accuracy"}
    assert all(len(v) == 2 for v in history.values())
    assert all(np.isfinite(v).all() for v in history.values())


def test_meta_schema_equals_jax_writer(trained, jax_written):
    ours = json.loads((trained / "meta.json").read_text())
    ref = json.loads((jax_written / "meta.json").read_text())
    assert set(ours) - VERSION_KEYS == set(ref) - VERSION_KEYS | (
        {"keras_file"} if KERAS else set())
    if KERAS:
        assert ours["keras_file"] == str(trained / "leaf_cnn.keras")
    assert {"torch_version", "cuda_version"} <= set(ours)
    for key in set(ours) - VERSION_KEYS - {"system", "keras_file"}:
        assert _schema(ours[key]) == _schema(ref[key]), key
    # the system block: same keys; the device fields describe torch's device
    assert set(ours["system"]) == set(ref["system"])
    assert ours["system"]["backend"] == "cpu"
    assert ours["system"]["mesh"] == {"data": 1, "model": 1}
    assert ours["saved_variant"] in ("base", "ema")
    assert ours["model"] == {**ours["model"], "name": "leaf_cnn",
                             "scale": "tiny", "widths": [16, 32, 64]}


@pytest.mark.parametrize("name", ["labels.json", "history.json",
                                  "confusion_matrix.json"])
def test_json_artifacts_match_jax_writer(trained, jax_written, name):
    ours = (trained / name).read_text()
    ref = (jax_written / name).read_text()
    if name == "labels.json":
        assert ours == ref          # byte-equal
    else:
        assert _schema(json.loads(ours)) == _schema(json.loads(ref))


def test_checkpoint_tree_matches_jax_writer(trained, jax_written):
    ours = jax_load_msgpack(trained / "leaf_cnn.msgpack")
    ref = jax_load_msgpack(jax_written / "leaf_cnn.msgpack")
    shapes = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: (a.shape, str(a.dtype)), t)
    assert shapes(ours) == shapes(ref)


def test_jax_loader_serves_the_port_model(trained):
    jl = JaxModelLoader(trained).load()
    pl = ModelLoader(trained, device="cpu").load()
    assert pl.labels == jl.labels and pl.img_size == jl.img_size == 32
    x = np.random.default_rng(3).random((6, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jl.model.apply(jl.variables, x, train=False))
    with torch.no_grad():
        got = pl.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_no_normalization_trains_and_loads(manifest, tmp_path):
    out = _train(manifest, tmp_path / "plain", "--no-normalization")
    meta = json.loads((out / "meta.json").read_text())
    assert meta["model"]["use_normalization"] is False
    pl = ModelLoader(out, device="cpu").load()
    assert not hasattr(pl.model, "norm_mean")
    jl = JaxModelLoader(out).load()
    x = np.random.default_rng(4).random((2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        got = pl.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jl.model.apply(jl.variables, x, train=False)),
        rtol=1e-4, atol=1e-4)


def test_streamed_fast_run_stops_at_target(manifest, tmp_path):
    """Pixels uploaded per batch (`--no-device-dataset`), FAST (no EMA, so
    the base weights are saved) and `--target-val-acc 0` (reached after the
    first epoch, so 1 of 3 epochs runs)."""
    out = tmp_path / "streamed"
    train_cli.main(["--manifest", str(manifest), "--epochs", "3",
                    "--batch-size", "8", "--img-size", "32", "--scale",
                    "tiny", "--device", "cpu", "--no-mixed-precision",
                    "--fast", "--no-device-dataset", "--target-val-acc",
                    "0", "--out-dir", str(out)])
    history = json.loads((out / "history.json").read_text())
    assert all(len(v) == 1 for v in history.values())
    meta = json.loads((out / "meta.json").read_text())
    assert meta["saved_variant"] == "base"
    assert meta["training"]["optimizer"] == "adam"
    assert ModelLoader(out, device="cpu").load().num_classes == 5


def _served_alike(out, size=32):
    """The JAX loader and the port's give the same eval logits (f32)."""
    jl = JaxModelLoader(out).load()
    pl = ModelLoader(out, device="cpu").load()
    x = np.random.default_rng(5).random((3, size, size, 3)).astype(
        np.float32)
    with torch.no_grad():
        got = pl.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jl.model.apply(jl.variables, x, train=False)),
        rtol=1e-4, atol=1e-4)
    return pl


def test_resnet10_manifest_run_matches_the_jax_cli(manifest, tmp_path):
    """`--arch resnet10` in manifest mode: the JAX loader serves the port's
    artifacts, and the meta's model block is the JAX CLI's for the same
    flags (its `widths`, `drop_block` and `drop_top` are the `--scale`
    preset's, as the JAX CLI writes them)."""
    from leaffliction_tpu.cli import train as jax_train_cli

    flags = ["--manifest", str(manifest), "--epochs", "1", "--batch-size",
             "8", "--img-size", "32", "--scale", "tiny",
             "--no-mixed-precision", "--arch", "resnet10"]
    train_cli.main(flags + ["--device", "cpu", "--out-dir",
                            str(tmp_path / "port")])
    jax_train_cli.main(flags + ["--no-export-keras", "--out-dir",
                                str(tmp_path / "jax")])
    ours = json.loads((tmp_path / "port" / "meta.json").read_text())
    ref = json.loads((tmp_path / "jax" / "meta.json").read_text())
    assert ours["model"] == ref["model"]
    assert ours["model"]["name"] == "resnet10"
    pl = _served_alike(tmp_path / "port")
    assert type(pl.model).__name__ == "LeafResNet"
    assert pl.model.stem == "conv"


def test_resnet10_s2d_balance_from_trains_and_serves(tiny_dataset,
                                                     tmp_path, monkeypatch):
    """`--arch resnet10 --stem s2d --balance-from` on the conftest tree:
    the fused path trains the ResNet, and both loaders serve it alike."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "models"
    run = train_cli.main(["--balance-from", str(tiny_dataset), "--epochs",
                          "1", "--batch-size", "8", "--img-size", "32",
                          "--arch", "resnet10", "--stem", "s2d", "--device",
                          "cpu", "--no-mixed-precision", "--out-dir",
                          str(out)])
    assert run is not None and run["fit"].steps_ran > 0
    meta = json.loads((out / "meta.json").read_text())
    assert (meta["model"]["name"], meta["model"]["stem"]) == ("resnet10",
                                                              "s2d")
    assert meta["data"]["manifest"] == str(tiny_dataset.resolve())
    pl = _served_alike(out)
    assert pl.model.stem == "s2d"


@pytest.mark.parametrize("flags,item", [
    # one process: a 2-way data mesh does not cover it (the JAX text),
    # and the error says how to launch two
    (["--mesh-data", "2"], "mesh 2x1 does not cover 1 devices; to train "
                           "on 2 devices, launch 2 processes with torchrun"),
    # tensor parallelism is ported: one process does not cover a model
    # axis of 2 (JAX's text: the data axis resolves to 1 // 2 = 0)
    (["--mesh-model", "2"], "mesh 0x2 does not cover 1 devices; to train "
                            "on 2 devices, launch 2 processes with torchrun "
                            "(python -m torch.distributed.run "
                            "--nproc-per-node 2 -m "
                            "leaffliction_tpu_torch.cli.train ... "
                            "--mesh-data 1 --mesh-model 2)"),
])
def test_later_slice_flags_name_their_roadmap_item(flags, item, capsys):
    with pytest.raises(SystemExit) as exc:
        train_cli.parse_args(flags)
    assert exc.value.code == 2
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("flags,field,value", [
    (["--resume"], "resume", True),
    (["--checkpoint-every", "1"], "checkpoint_every", 1),
    (["--checkpoint-every-steps", "5"], "checkpoint_every_steps", 5),
    (["--profile-dir", "p"], "profile_dir", "p"),
])
def test_resume_flags_are_parsed(flags, field, value):
    """The resume, checkpoint and profiler flags are ported: parsed, with
    the JAX CLI's defaults (no resume, no checkpoints, no profile) for the
    others."""
    from leaffliction_tpu.cli import train as jax_train_cli

    args = train_cli.parse_args(flags)
    got = getattr(args, field)
    assert (str(got) if field == "profile_dir" else got) == value
    ref = jax_train_cli.parse_args([])
    for other in ("resume", "checkpoint_every", "checkpoint_every_steps",
                  "profile_dir"):
        if other != field:
            assert getattr(args, other) == getattr(ref, other)


@pytest.mark.parametrize("flags,field,value", [
    (["--balance-from", "tree"], "balance_from", "tree"),
    (["--val-ratio", "0.3"], "val_ratio", 0.3),
    (["--split-seed", "3"], "split_seed", 3),
    (["--materialize-augmented"], "materialize_augmented", True),
    (["--transform"], "transform", True),
    (["--balance-from", "tree", "--transform"], "transform", True),
])
def test_balance_flags_are_parsed(flags, field, value):
    """The fused balance flags and `--transform` are ported: parsed, with
    the JAX CLI's defaults (val ratio 0.2, split seed 32) for the
    others."""
    args = train_cli.parse_args(flags)
    got = getattr(args, field)
    assert (str(got) if field == "balance_from" else got) == value
    if field != "val_ratio":
        assert args.val_ratio == 0.2
    if field != "split_seed":
        assert args.split_seed == 32


def test_parity_flags_are_accepted():
    args = train_cli.parse_args(["--steps-per-dispatch", "8",
                                 "--export-keras", "--small",
                                 "--mesh-data", "1"])
    assert args.scale == "small" and args.export_keras is True
    assert args.device == "cuda"


def test_cuda_default_fails_without_cuda(manifest, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--manifest", str(manifest), "--epochs", "1",
                        "--img-size", "32", "--out-dir", str(tmp_path)])


def _listing(d):
    return sorted(p.name for p in d.iterdir())


def _keras_probs(path, x):
    import keras

    return np.asarray(keras.models.load_model(path, compile=False).predict(
        x, verbose=0))


@pytest.mark.skipif(not KERAS, reason="keras not importable")
def test_default_artifacts_equal_the_jax_cli(manifest, tmp_path):
    """Both CLIs at their defaults (keras importable): the same artifact
    set, `leaf_cnn.keras` and `keras_file` included, the same meta keys
    with `keras_file` at the out-dir's `leaf_cnn.keras`; each `.keras`
    file holds its run's saved weights, keras's predictions on it within
    2e-5 of that run's f32 `leaf_cnn.msgpack` served by the port's
    loader (the two runs train different draws, so their weights
    differ)."""
    from leaffliction_tpu.cli import train as jax_train_cli

    flags = ["--manifest", str(manifest), "--epochs", "1", "--batch-size",
             "8", "--img-size", "32", "--scale", "tiny",
             "--no-mixed-precision"]
    train_cli.main(flags + ["--device", "cpu", "--out-dir",
                            str(tmp_path / "port")])
    jax_train_cli.main(flags + ["--out-dir", str(tmp_path / "jax")])
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    assert _listing(port) == _listing(jax_dir)
    assert "leaf_cnn.keras" in _listing(port)
    metas = [json.loads((d / "meta.json").read_text())
             for d in (port, jax_dir)]
    assert set(metas[0]) - VERSION_KEYS == set(metas[1]) - VERSION_KEYS
    for d, meta in zip((port, jax_dir), metas):
        assert meta["keras_file"] == str(d / "leaf_cnn.keras")
        assert meta["model_file"] == str(d / "leaf_cnn.msgpack")
    x = np.random.default_rng(6).random((4, 32, 32, 3)).astype(np.float32)
    for d in (port, jax_dir):
        served = ModelLoader(d, device="cpu").load().model
        with torch.no_grad():
            want = torch.softmax(served(torch.from_numpy(x)), -1).numpy()
        np.testing.assert_allclose(_keras_probs(d / "leaf_cnn.keras", x),
                                   want, rtol=0, atol=2e-5)


def _export_args(arch, explicit, out_dir):
    import argparse

    return argparse.Namespace(arch=arch, export_keras=explicit,
                              img_size=32, out_dir=out_dir)


@pytest.mark.parametrize("arch,explicit,keras_missing", [
    ("resnet10", True, False), ("resnet10", None, False),
    ("leafcnn", True, True), ("leafcnn", None, True)])
def test_export_skips_as_the_jax_cli(tmp_path, caplog, monkeypatch, arch,
                                     explicit, keras_missing):
    """`_export_keras_artifact` of both CLIs where it skips: a ResNet, or
    keras reported missing. Neither writes a file; each warns only for an
    explicit `--export-keras`, and both log the same warnings."""
    import logging

    from leaffliction_tpu.cli import train as jax_train_cli
    from leaffliction_tpu.train import keras_export as jax_kx
    from leaffliction_tpu_torch.train import keras_export as kx

    if keras_missing:
        monkeypatch.setattr(kx, "keras_available", lambda: False)
        monkeypatch.setattr(jax_kx, "keras_available", lambda: False)
    warned = []
    for name, export in (("port", train_cli._export_keras_artifact),
                         ("jax", jax_train_cli._export_keras_artifact)):
        out = tmp_path / name
        out.mkdir()
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            export(None, None, _export_args(arch, explicit, out))
        assert _listing(out) == []
        warned.append([r.getMessage() for r in caplog.records
                       if r.levelno >= logging.WARNING])
    assert warned[0] == warned[1]
    assert len(warned[0]) == (1 if explicit else 0)


def test_keras_missing_run_writes_no_keras_artifact(manifest, tmp_path,
                                                    monkeypatch, capsys):
    """The port's CLI at its defaults with keras reported missing: the
    writer's artifact set alone, no `keras_file` in meta.json, no
    warning; with an explicit `--export-keras`, one warning."""
    from leaffliction_tpu_torch.train import keras_export as kx

    monkeypatch.setattr(kx, "keras_available", lambda: False)
    capsys.readouterr()
    out = _train(manifest, tmp_path / "quiet")
    assert set(ARTIFACTS) <= set(_listing(out))
    assert "leaf_cnn.keras" not in _listing(out)
    assert "keras_file" not in json.loads((out / "meta.json").read_text())
    assert "WARNING" not in capsys.readouterr().out
    out = _train(manifest, tmp_path / "asked", "--export-keras")
    assert "leaf_cnn.keras" not in _listing(out)
    said = [ln for ln in capsys.readouterr().out.splitlines()
            if "WARNING" in ln]
    assert len(said) == 1 and "keras package is not importable" in said[0]
