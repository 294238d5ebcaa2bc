"""The port's host CLIs against the JAX package's on the CPU: distribution,
split, augment (single image and dataset) and balance_dataset.

`distribution.csv` is byte-equal to the JAX CLI's, also when merged into an
existing CSV and with `--plants`, and the same PNGs are written where
matplotlib is installed. The split CLI's `manifest_split.json` (but for
`created_at`) and `split_summary.csv` are equal, under `--val-ratio` and
under `--out-manifest`. Augment's single-image mode writes the JAX CLI's
seven file names, and, with JAX's draws handed in (op i from
`fold_in(key(seed), i)`), each output has JAX's shape. Augment's dataset
mode and balance_dataset give JAX's counts, `manifest_augmented.json` meta
(but for `augmented_at`) and `balanced_distribution.csv` bytes; each runs
in its own working directory, where its relative `artifacts/` land.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax_draws import jax_params  # noqa: E402
from leaffliction_tpu.cli import augment as j_aug  # noqa: E402
from leaffliction_tpu.cli import balance_dataset as j_bal  # noqa: E402
from leaffliction_tpu.cli import distribution as j_dist  # noqa: E402
from leaffliction_tpu.cli import split as j_split  # noqa: E402
from leaffliction_tpu_torch.cli import augment as t_aug  # noqa: E402
from leaffliction_tpu_torch.cli import balance_dataset as t_bal  # noqa: E402
from leaffliction_tpu_torch.cli import distribution as t_dist  # noqa: E402
from leaffliction_tpu_torch.cli import split as t_split  # noqa: E402
import jax_native  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """The JAX side decodes through its JPEG helper loaded whole, or
    both sides through PIL (`tests/jax_native.py`)."""
    jax_native.ready()


torch.set_num_threads(1)


def _in(tmp_path, name, monkeypatch):
    d = tmp_path / name
    d.mkdir()
    monkeypatch.chdir(d)
    return d


def test_distribution_csv_bytes_match(tiny_dataset, tmp_path):
    existing = "plant,class,count\nApple,healthy,1\nPear,old,3\n"
    for name, cli in (("j", j_dist), ("t", t_dist)):
        out = tmp_path / name
        out.mkdir()
        (out / "distribution.csv").write_text(existing)
        cli.main([str(tiny_dataset), "--out-dir", str(out)])
        cli.main([str(tiny_dataset), "--plants", "Grape", "--out-dir",
                  str(out / "grape"), "--no-plots"])
    for rel in ("distribution.csv", "grape/distribution.csv"):
        assert (tmp_path / "t" / rel).read_bytes() == \
            (tmp_path / "j" / rel).read_bytes()
    rows = (tmp_path / "t" / "distribution.csv").read_text().splitlines()
    assert "Pear,old,3" in rows and "Apple,healthy,12" in rows
    assert sorted(p.name for p in (tmp_path / "t").glob("*.png")) == \
        sorted(p.name for p in (tmp_path / "j").glob("*.png"))
    assert not list((tmp_path / "t" / "grape").glob("*.png"))


@pytest.mark.parametrize("extra", [["--val-ratio", "0.3", "--seed", "7"],
                                   ["--out-manifest", "m/custom.json"]])
def test_split_manifest_and_summary_match(tiny_dataset, tmp_path,
                                          monkeypatch, extra):
    outs = {}
    for name, cli in (("j", j_split), ("t", t_split)):
        work = _in(tmp_path, name, monkeypatch)
        cli.main(["--src", str(tiny_dataset), "--out", "datasets", *extra])
        manifest = work / (extra[1] if "--out-manifest" in extra
                           else "datasets/manifest_split.json")
        data = json.loads(manifest.read_text())
        data["meta"].pop("created_at")
        outs[name] = (data, (work / "datasets/split_summary.csv")
                      .read_bytes())
    assert outs["t"] == outs["j"]
    assert len(outs["t"][0]["items"]) == 37


def test_split_reset_removes_stale_outputs(tmp_path):
    out = tmp_path / "datasets"
    out.mkdir()
    (out / "manifest_split.json").write_text("{}")
    t_split.reset_split_outputs(out)
    assert not (out / "manifest_split.json").exists()


SINGLE_NAMES = ["original_leaf.jpg"] + [f"{op}_leaf.jpg" for op in (
    "flip", "rotate", "skew", "shear", "crop", "distortion")]


@pytest.fixture(scope="module")
def leaf(tmp_path_factory):
    from PIL import Image

    from conftest import _leafish_image

    path = tmp_path_factory.mktemp("leaf") / "leaf.jpg"
    Image.fromarray(_leafish_image(np.random.default_rng(5), 64)[:40]).save(
        path, quality=95)
    return path


def _sizes(d):
    from PIL import Image

    out = {}
    for p in sorted(d.iterdir()):
        with Image.open(p) as im:
            out[p.name] = im.size
    return out


def test_single_image_names_and_shapes_match(leaf, tmp_path, monkeypatch):
    import argparse

    seed = 42
    _in(tmp_path, "j", monkeypatch)
    j_aug.main([str(leaf), "--output", str(tmp_path / "j_out"), "--seed",
                str(seed)])
    _in(tmp_path, "t", monkeypatch)
    t_aug.main([str(leaf), "--output", str(tmp_path / "t_out"), "--seed",
                str(seed), "--device", "cpu"])
    assert sorted(_sizes(tmp_path / "j_out")) == sorted(SINGLE_NAMES)
    assert sorted(_sizes(tmp_path / "t_out")) == sorted(SINGLE_NAMES)

    root = jax.random.key(seed)

    def jax_draw(transform, i, hw, device):
        return jax_params(transform, jax.random.fold_in(root, i)[None], hw)

    args = argparse.Namespace(output=str(tmp_path / "t_jax"), seed=seed)
    t_aug.single_image_mode(args, leaf, torch.device("cpu"), draw=jax_draw)
    assert _sizes(tmp_path / "t_jax") == _sizes(tmp_path / "j_out")


def _dataset_outputs(work):
    manifest = json.loads((work / "artifacts/datasets/manifest_augmented.json"
                           ).read_text())
    manifest["meta"].pop("augmented_at")
    return manifest["meta"], sorted(
        (it["id"], it["label"], it["augmented"]) for it in manifest["items"])


def test_dataset_mode_and_balance_dataset_match(tiny_dataset, tmp_path,
                                                monkeypatch):
    runs = {}
    for name, aug, bal, extra in (("j", j_aug, j_bal, []),
                                  ("t", t_aug, t_bal, ["--device", "cpu"])):
        work = _in(tmp_path, f"{name}_aug", monkeypatch)
        aug.main([str(tiny_dataset), "--seed", "3", *extra])
        runs[f"{name}_aug"] = (
            _dataset_outputs(work),
            (work / "artifacts/distribution/balanced_distribution.csv"
             ).read_bytes())
        work = _in(tmp_path, f"{name}_bal", monkeypatch)
        bal.main(["--source-dir", str(tiny_dataset), "--seed", "3", *extra])
        runs[f"{name}_bal"] = _dataset_outputs(work)
    assert runs["t_aug"] == runs["j_aug"]
    assert runs["t_bal"] == runs["j_bal"]
    meta, items = runs["t_aug"][0]
    assert (meta["original_images"], meta["augmented_images"]) == (37, 17)
    assert len(items) == 54
    csv_rows = runs["t_aug"][1].decode().splitlines()
    assert csv_rows[0] == "plant,class,count"
    assert "Apple,scab,12" in csv_rows and "Grape,spot,9" in csv_rows


def test_cli_device_defaults_to_cuda(leaf, tmp_path, monkeypatch):
    """Without `--device cpu` the augment CLI asks for CUDA and, where there
    is none, exits 1 before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    work = _in(tmp_path, "w", monkeypatch)
    with pytest.raises(SystemExit) as exc:
        t_aug.main([str(leaf)])
    assert exc.value.code == 1
    assert not (work / "artifacts").exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_bal.main(["--source-dir", str(leaf.parent)])
