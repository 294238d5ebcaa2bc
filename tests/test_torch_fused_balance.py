"""The fused balance → split → train slice against the JAX package on the
CPU.

On a two-plant tree with two deficient classes, the port's
`balance_to_device` + `split_fused_result` run with the JAX package's drawn
values (`tests/jax_draws.py`: JAX's per-task keys and key splits) and are
compared with JAX's: the task list, items, labels, `label2idx` and split
rows are identical; the three dataset artifacts are equal but for their
timestamps; the original pixels are equal; each augmented row is within
its op's bar (flip exact; skew, shear, crop, distortion ≤ 1 LSB; rotate,
the K2 twin plus the lanczos3 resize-back against the einsum rotate, ≤ 2).
With its own draws the port gives the same bytes for `device_batch=1` as
for the default chunking, the same bytes for the same seed and other
augmented rows for another. The train CLI runs `--balance-from` on the CPU
(tiny, 48 px, 2 epochs) and writes the JAX CLI's artifact set, with a
`labels.json` byte-equal to what the JAX writer gives for JAX's balance; a
bad `--val-ratio` stops before any decode.
"""

import csv
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax_draws import jax_params, jax_task_keys  # noqa: E402
from leaffliction_tpu.data import fused_balance as jf  # noqa: E402
from leaffliction_tpu_torch.cli import train as train_cli  # noqa: E402
from leaffliction_tpu_torch.data import fused_balance as tf  # noqa: E402
import jax_native  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """The JAX side decodes through its JPEG helper loaded whole, or
    both sides through PIL (`tests/jax_native.py`)."""
    jax_native.ready()


torch.set_num_threads(1)

SEED, SIZE = 42, 48
BARS = {"flip": 0, "skew": 1, "shear": 1, "crop": 1, "distortion": 1,
        "rotate": 2}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from PIL import Image

    from conftest import _leafish_image

    root = tmp_path_factory.mktemp("tree")
    rng = np.random.default_rng(9)
    spec = {"Apple": {"a_heal": 14, "a_rust": 5},
            "Grape": {"g_spot": 10, "g_blight": 3}}
    for plant, classes in spec.items():
        for cls, n in classes.items():
            d = root / plant / cls
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(_leafish_image(rng, 56)).save(
                    d / f"img{i}.jpg", quality=92)
    return root


def _jax_draw(transform, tasks, hw, device):
    return jax_params(transform, jax_task_keys(SEED, [t.task_seed
                                                      for t in tasks]), hw)


@pytest.fixture(scope="module")
def both(tree, tmp_path_factory):
    """(JAX result, port result with JAX's draws, their dataset dirs)."""
    out = tmp_path_factory.mktemp("both")
    target = out / "augmented"
    ref = jf.balance_to_device(tree, SIZE, seed=SEED, target_dir=target,
                               manifest_out_dir=out / "jax")
    got = tf.balance_to_device(tree, SIZE, seed=SEED, target_dir=target,
                               manifest_out_dir=out / "port", device="cpu",
                               draw=_jax_draw)
    ref_rows = jf.split_fused_result(ref, 0.2, 32, out / "jax", src_root=tree)
    got_rows = tf.split_fused_result(got, 0.2, 32, out / "port",
                                     src_root=tree)
    return ref, got, ref_rows, got_rows, out


def test_tasks_items_labels_and_split_identical(both):
    ref, got, ref_rows, got_rows, _ = both
    assert got.n_original == ref.n_original
    assert got.n_generated == ref.n_generated == (14 - 5) + (10 - 3)
    assert [it.to_json() for it in got.items] == \
        [it.to_json() for it in ref.items]
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert got.labels.dtype == np.int32
    assert got.label2idx == ref.label2idx
    for a, b in zip(got_rows, ref_rows):
        np.testing.assert_array_equal(a, b)


def _json_without(path, key):
    data = json.loads(path.read_text())
    data["meta"].pop(key)
    return data


def test_dataset_artifacts_equal_but_timestamps(both):
    *_, out = both
    assert _json_without(out / "port" / "manifest_augmented.json",
                         "augmented_at") == \
        _json_without(out / "jax" / "manifest_augmented.json",
                      "augmented_at")
    assert _json_without(out / "port" / "manifest_split.json",
                         "created_at") == \
        _json_without(out / "jax" / "manifest_split.json", "created_at")
    assert (out / "port" / "split_summary.csv").read_bytes() == \
        (out / "jax" / "split_summary.csv").read_bytes()


def test_pixels_within_each_ops_bar(both):
    ref, got, *_ = both
    a = np.asarray(ref.device_images).astype(np.int64)
    b = got.device_images.numpy().astype(np.int64)
    assert b.shape == a.shape == (len(ref.items), SIZE, SIZE, 3)
    np.testing.assert_array_equal(b[:ref.n_original], a[:ref.n_original])
    seen = set()
    for i in range(ref.n_original, len(ref.items)):
        op = ref.items[i].id.split("_aug_")[1].rsplit("_", 1)[0]
        seen.add(op)
        d = np.abs(a[i] - b[i])
        assert d.max() <= BARS[op], (i, op, d.max())
        assert (d > 1).mean() < 0.002, (i, op)
    assert seen == set(BARS)


def _own(tree, tmp_path, name, **kw):
    return tf.balance_to_device(tree, SIZE, target_dir=tmp_path / "aug",
                                manifest_out_dir=tmp_path / name,
                                device="cpu", **kw)


def test_own_draws_independent_of_chunking_and_seeded(tree, tmp_path):
    default = _own(tree, tmp_path, "a", seed=SEED)
    one = _own(tree, tmp_path, "b", seed=SEED, device_batch=1)
    again = _own(tree, tmp_path, "c", seed=SEED)
    other = _own(tree, tmp_path, "d", seed=7)
    assert torch.equal(default.device_images, one.device_images)
    assert torch.equal(default.device_images, again.device_images)
    n = default.n_original
    assert torch.equal(other.device_images[:n], default.device_images[:n])
    assert not torch.equal(other.device_images[n:],
                           default.device_images[n:])
    assert set(default.stages) == {"decode_s", "upload_s", "augment_s"}


def test_materialize_writes_the_augmented_tree(tree, tmp_path):
    res = _own(tree, tmp_path, "m", seed=SEED, materialize=True)
    written = sorted((tmp_path / "aug").rglob("*_aug_*.jpg"))
    assert len(written) == res.n_generated
    names = {p.relative_to(tmp_path / "aug").as_posix() for p in written}
    assert names == {it.id for it in res.items[res.n_original:]}
    assert len(sorted((tmp_path / "aug").rglob("img*.jpg"))) == \
        res.n_original + res.n_generated


def test_missing_tree_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tf.balance_to_device(tmp_path / "nope", SIZE, device="cpu")


@pytest.fixture(scope="module")
def cli_run(tree, tmp_path_factory):
    work = tmp_path_factory.mktemp("cli")
    mp = pytest.MonkeyPatch()
    mp.chdir(work)
    try:
        summary = train_cli.main([
            "--balance-from", str(tree), "--epochs", "2", "--img-size",
            str(SIZE), "--batch-size", "8", "--scale", "tiny", "--seed",
            str(SEED), "--device", "cpu", "--no-mixed-precision",
            "--out-dir", str(work / "models")])
    finally:
        mp.undo()
    return work, summary


def test_train_cli_balance_from_writes_the_jax_artifact_set(cli_run, both,
                                                            tree, tmp_path):
    from leaffliction_tpu.train.artifacts import save_training_artifacts
    from leaffliction_tpu.models.leafcnn import build_leafcnn
    from leaffliction_tpu.train.config import TrainConfig
    from leaffliction_tpu.train.steps import create_train_state

    work, summary = cli_run
    ref, _, ref_rows, _, out = both
    models = work / "models"
    datasets = work / "artifacts" / "datasets"
    for name in ("manifest_augmented.json", "manifest_split.json",
                 "split_summary.csv"):
        assert (datasets / name).exists(), name
    assert (datasets / "split_summary.csv").read_bytes() == \
        (out / "jax" / "split_summary.csv").read_bytes()
    def ids(path):  # `src` holds the run's own augmented_directory
        return [{k: v for k, v in it.items() if k != "src"}
                for it in json.loads(path.read_text())["items"]]

    assert ids(datasets / "manifest_split.json") == \
        ids(out / "jax" / "manifest_split.json")

    bal = summary["balance"]
    assert (bal["n_original"], bal["n_generated"]) == (ref.n_original,
                                                       ref.n_generated)
    assert (bal["train"], bal["val"]) == tuple(map(len, ref_rows))
    meta = json.loads((models / "meta.json").read_text())
    assert meta["data"]["manifest"] == str(tree.resolve())
    assert (meta["data"]["train_items"], meta["data"]["val_items"]) == \
        tuple(map(len, ref_rows))
    history = json.loads((models / "history.json").read_text())
    assert all(len(v) == 2 for v in history.values())

    # the JAX writer's artifact set for JAX's balance of the same tree
    jax_models = tmp_path / "jax_models"
    state = create_train_state(build_leafcnn(len(ref.label2idx), "tiny"),
                               TrainConfig.regularized(), SIZE, 0)
    save_training_artifacts(jax_models, state, ref.label2idx, history,
                            "base", np.array([0, 1]), np.array([0, 1]),
                            meta={k: meta[k] for k in
                                  ("run", "data", "model", "training")})
    # the JAX CLI adds leaf_cnn.keras by default where keras is importable
    from leaffliction_tpu.train.keras_export import keras_available

    assert sorted(p.name for p in models.iterdir()) == sorted(
        [p.name for p in jax_models.iterdir()]
        + (["leaf_cnn.keras"] if keras_available() else []))
    assert (models / "labels.json").read_bytes() == \
        (jax_models / "labels.json").read_bytes()


def test_train_cli_bad_val_ratio_stops_before_decoding(tree, tmp_path,
                                                       monkeypatch):
    def no_decode(*args, **kwargs):
        raise AssertionError("decoded before checking --val-ratio")

    monkeypatch.setattr(tf, "decode_batch_with_fallback", no_decode)
    monkeypatch.chdir(tmp_path)
    for ratio in ("1.5", "0"):
        assert train_cli.main(["--balance-from", str(tree), "--val-ratio",
                               ratio, "--device", "cpu", "--out-dir",
                               str(tmp_path / "models")]) is None
    assert not (tmp_path / "artifacts").exists()
    assert not (tmp_path / "models").exists()


def test_split_summary_counts_every_row(both):
    *_, out = both
    rows = list(csv.reader((out / "port" / "split_summary.csv").open()))
    total = rows[-1]
    assert total[0] == "_TOTAL_" and int(total[3]) == len(both[1].items)


def test_train_cli_balance_from_needs_cuda_by_default(tree, tmp_path,
                                                      monkeypatch):
    """No CPU fallback: without `--device cpu` the command asks for CUDA
    and, where there is none, stops before the balance runs."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--balance-from", str(tree), "--epochs", "1",
                        "--img-size", str(SIZE), "--out-dir",
                        str(tmp_path / "models")])
    assert not (tmp_path / "artifacts").exists()
