"""The PyTorch port's transform CLI and the train CLI's `--transform`, held
against the JAX package's, on the CPU.

- `python -m leaffliction_tpu_torch.cli.transform` in single-image mode
  (the default config: 1.3× upscale, GrabCut, the device one on both
  sides, so no step depends on cv2), with `--types`, and in folder mode:
  the same file names as the JAX CLI, and every written image within
  1 LSB of the JAX CLI's on ≥ 99.9% of its pixels, but the Hist figure and
  the mosaic that holds it (`_same_outputs` says why);
- `data/loader.apply_training_transform` against JAX's on the same decoded
  store: ≥ 99.9% of the bytes equal; `apply_training_transform_device`
  equal to the host version;
- `cli.train --transform` runs in manifest mode and with `--balance-from`.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from conftest import _leafish_image  # noqa: E402
from leaffliction_tpu.cli import split as split_cli  # noqa: E402
from leaffliction_tpu.cli import transform as jcli  # noqa: E402
from leaffliction_tpu.data import loader as jloader  # noqa: E402
from leaffliction_tpu.data.manifest import (  # noqa: E402
    build_label_mapping,
    load_manifest,
    select_items,
)
from leaffliction_tpu_torch.cli import train as train_cli  # noqa: E402
from leaffliction_tpu_torch.cli import transform as tcli  # noqa: E402
from leaffliction_tpu_torch.data import loader as tloader  # noqa: E402
from leaffliction_tpu_torch.data.manifest import (  # noqa: E402
    load_manifest as t_load_manifest,
)
import jax_native  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """The JAX side decodes through its JPEG helper loaded whole, or
    both sides through PIL (`tests/jax_native.py`)."""
    jax_native.ready()


torch.set_num_threads(1)


def _read(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.int32)


def _same_outputs(ours_dir, ref_dir):
    """The same file names; each image within 1 LSB of the JAX CLI's on
    ≥ 99.9% of its pixels, but the Hist figures, and the mosaics where they
    hold one, within 2 LSB on ≥ 99%: their bars move with the pixels whose
    hue lies on a bin edge, where XLA's fused arithmetic lands an ulp to
    either side (`test_torch_seg_filters.py` holds the statistics exactly
    off those pixels)."""
    ours = sorted(p.name for p in ours_dir.iterdir())
    ref = sorted(p.name for p in ref_dir.iterdir())
    assert ours == ref
    hist = any(name.endswith("__T_Hist.jpg") for name in ours)
    for name in ours:
        a, b = _read(ours_dir / name), _read(ref_dir / name)
        assert a.shape == b.shape, name
        loose = name.endswith("__T_Hist.jpg") or (
            hist and name.endswith("_mosaic.jpg"))
        lsb, share = (2, 0.99) if loose else (1, 0.999)
        close = (np.abs(a - b) <= lsb).all(-1).mean()
        assert close >= share, (name, close)
    return ours


def _run_both(argv_ours, argv_ref):
    tcli.main(argv_ours + ["--device", "cpu"])
    jcli.main(argv_ref)


@pytest.fixture(scope="module")
def leaf_jpeg(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("leaf")
    path = root / "image (4).jpg"
    Image.fromarray(_leafish_image(np.random.default_rng(41), 64)).save(
        path, quality=95)
    return path


def test_single_image_mode_matches_jax_cli(leaf_jpeg, tmp_path,
                                           monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("LEAF_GRABCUT", "device")
    _run_both([str(leaf_jpeg), "--out-dir", "ours"],
              [str(leaf_jpeg), "--out-dir", "ref"])
    names = _same_outputs(tmp_path / "ours", tmp_path / "ref")
    assert "image (4)__T_Landmarks.jpg" in names
    assert "image4_mosaic.jpg" in names and len(names) == 8


def test_single_image_default_dir_and_types(leaf_jpeg, tmp_path,
                                            monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("LEAF_GRABCUT", "device")
    tcli.main([str(leaf_jpeg), "--types", "Mask,brown,bogus", "--preview",
               "--device", "cpu"])
    out = tmp_path / "artifacts" / "transformations" / "4"
    assert sorted(p.name for p in out.iterdir()) == [
        "image (4)__T_Brown.jpg", "image (4)__T_Mask.jpg",
        "image4_mosaic.jpg"]
    assert "Saved 3 outputs" in capsys.readouterr().out
    monkeypatch.chdir(tmp_path / "artifacts")
    jcli.main([str(leaf_jpeg), "--types", "Mask,brown,bogus", "--preview"])
    _same_outputs(out, tmp_path / "artifacts" / "artifacts"
                  / "transformations" / "4")


def test_folder_mode_matches_jax_cli(tmp_path, monkeypatch):
    from PIL import Image

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(43)
    for sub, size in (("a", 64), ("a", 64), ("b", 96)):
        d = tmp_path / "src" / sub
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(_leafish_image(rng, size)).save(
            d / f"leaf{len(list(d.iterdir()))}_{size}.jpg", quality=95)
    run = tcli.main(["-src", "src", "-dst", "ours", "--device", "cpu"])
    jcli.main(["-src", "src", "-dst", "ref"])
    names = _same_outputs(tmp_path / "ours", tmp_path / "ref")
    assert len(names) == 3 * 8
    assert run["images"] == 3 and set(run["stages"]) == {
        "decode", "masks", "filters", "encode"}


@pytest.fixture(scope="module")
def manifest(tiny_dataset, tmp_path_factory):
    out = tmp_path_factory.mktemp("split")
    split_cli.main(["--src", str(tiny_dataset), "--out", str(out),
                    "--val-ratio", "0.25", "--seed", "32"])
    return out / "manifest_split.json"


def test_training_transform_matches_jax(manifest):
    _, items = load_manifest(manifest)
    train = select_items(items, "train")
    label2idx = build_label_mapping(train)
    ref = jloader.ImageStore(train, label2idx, 64)
    _, t_items = t_load_manifest(manifest)
    ours = tloader.ImageStore([it for it in t_items if it.split == "train"],
                              label2idx, 64)
    np.testing.assert_array_equal(ours.images, ref.images)
    before = ours.images.copy()
    jloader.apply_training_transform(ref, device_batch=8)
    tloader.apply_training_transform(ours, device_batch=8, device="cpu")
    assert (ours.images == ref.images).mean() >= 0.999
    assert (ours.images != before).any()
    dev = tloader.apply_training_transform_device(
        torch.from_numpy(before), device_batch=8)
    np.testing.assert_array_equal(dev.numpy(), ours.images)


@pytest.mark.parametrize("mode", ["manifest", "balance_from"])
def test_train_cli_transform_runs(mode, manifest, tiny_dataset, tmp_path,
                                  monkeypatch):
    monkeypatch.chdir(tmp_path)
    source = (["--manifest", str(manifest)] if mode == "manifest"
              else ["--balance-from", str(tiny_dataset)])
    run = train_cli.main(source + [
        "--transform", "--epochs", "1", "--batch-size", "8", "--img-size",
        "32", "--scale", "tiny", "--device", "cpu", "--no-mixed-precision",
        "--out-dir", str(tmp_path / "models")])
    assert run is not None and run["fit"].steps_ran > 0
    assert run["transform_s"] > 0
    meta = json.loads((tmp_path / "models" / "meta.json").read_text())
    assert meta["data"]["img_size"] == 32
