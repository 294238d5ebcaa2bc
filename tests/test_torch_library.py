"""The library functions that no CLI calls, held against their JAX
originals on inputs made from a seed with numpy.

Tolerances: `_reflect_index`, `mask_utils`, `ImageTransforms`, `in_range`,
`quantize_gradient_sector` and the metric writers' bytes exactly; the
geometry matrix builders at 1e-6; `homography_warp`/`warp_image` at 1e-3
on [0, 255] on the same matrices (the port repeats the sample
coordinates' fused multiply-add that XLA compiles into the JAX warp; the
interpolation's rounding differs by ~3e-5) and at `tests/test_geometry.py`'s
bars against PIL; the other `ops/*` functions at 1e-6 (on [0, 1] or
[0, 255] scaled to 1e-6 of their range); `resize_bilinear` at 5e-3 on
[0, 255] (`jax.image.resize`'s weights are compiled with fused
multiply-adds; `tests/test_torch_seg_ops.py`'s bar for `ops/image.resize`);
`color_region_percentages` at `tests/test_hist_oracle.py`'s 1.5 points
against cv2 and exactly against JAX's; `evaluate_from_manifest` the same
metrics dict as JAX's.
"""

import json
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from PIL import Image  # noqa: E402

from conftest import _leafish_image  # noqa: E402
from leaffliction_tpu.ops import colorspace as jcs  # noqa: E402
from leaffliction_tpu.ops import filters as jfilters  # noqa: E402
from leaffliction_tpu.ops import geometry as jgeo  # noqa: E402
from leaffliction_tpu.ops import image as jimage  # noqa: E402
from leaffliction_tpu.ops import photometric as jphoto  # noqa: E402
from leaffliction_tpu.ops import threshold as jthr  # noqa: E402
from leaffliction_tpu.utils import mask_utils as jmu  # noqa: E402
from leaffliction_tpu.utils import metrics as jmetrics  # noqa: E402
from leaffliction_tpu.utils import image_io as jio  # noqa: E402
from leaffliction_tpu.utils import viz as jviz  # noqa: E402
from leaffliction_tpu_torch.ops import colorspace as tcs  # noqa: E402
from leaffliction_tpu_torch.ops import filters as tfilters  # noqa: E402
from leaffliction_tpu_torch.ops import geometry as tgeo  # noqa: E402
from leaffliction_tpu_torch.ops import image as timage  # noqa: E402
from leaffliction_tpu_torch.ops import photometric as tphoto  # noqa: E402
from leaffliction_tpu_torch.ops import threshold as tthr  # noqa: E402
from leaffliction_tpu_torch.utils import mask_utils as tmu  # noqa: E402
from leaffliction_tpu_torch.utils import metrics as tmetrics  # noqa: E402
from leaffliction_tpu_torch.utils import image_io as tio  # noqa: E402
from leaffliction_tpu_torch.utils import viz as tviz  # noqa: E402
import jax_native  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """The JAX side decodes through its JPEG helper loaded whole, or
    both sides through PIL (`tests/jax_native.py`)."""
    jax_native.ready()


torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- ops/geometry ---------------------------------------------------------


@pytest.mark.parametrize("size", [1, 2, 5, 17])
def test_reflect_index_exact(size):
    idx = np.arange(-60, 61, dtype=np.int32)
    got = tgeo._reflect_index(torch.from_numpy(idx).long(), size)
    np.testing.assert_array_equal(
        _np(got), np.asarray(jgeo._reflect_index(jnp.asarray(idx), size)))


def _builders():
    coeffs = np.random.default_rng(1).normal(0, 0.01, 8).astype(np.float32)
    coeffs[[0, 4]] += 1.0
    quad = [(0, 0), (64, 0), (64, 48), (0, 48)]
    dst = [(4, 2), (61, 5), (62, 44), (2, 43)]
    return [
        ("affine", lambda m: m.affine_matrix(1.1, 0.2, -3.0, -0.1, 0.9,
                                             4.5)),
        ("rotation", lambda m: m.rotation_matrix(17.0, (48, 64))),
        ("rotation_expand", lambda m: m.rotation_matrix(-31.5, (48, 64),
                                                        out_hw=(80, 90))),
        ("shear_h", lambda m: m.shear_matrix(0.15, True, (48, 64))),
        ("shear_v", lambda m: m.shear_matrix(-0.2, False, (48, 64))),
        ("perspective", lambda m: m.perspective_matrix_from_coeffs(coeffs)),
        ("solve", lambda m: m.solve_perspective_coeffs(dst, quad)),
    ]


@pytest.mark.parametrize("name,build", _builders(),
                         ids=[n for n, _ in _builders()])
def test_matrix_builders_match(name, build):
    got, ref = _np(build(tgeo)), np.asarray(build(jgeo))
    assert got.shape == ref.shape == (3, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def warp_images():
    rng = np.random.default_rng(7)
    return rng.uniform(0, 255, (3, 40, 52, 3)).astype(np.float32)


@pytest.mark.parametrize("name,build,out_hw", [
    ("identity", lambda m: m.affine_matrix(1, 0, 0, 0, 1, 0), (40, 52)),
    ("rotation", lambda m: m.rotation_matrix(23.0, (40, 52)), (40, 52)),
    ("rotation_expand", lambda m: m.rotation_matrix(-30.0, (40, 52),
                                                    out_hw=(62, 70)),
     (62, 70)),
    ("shear", lambda m: m.shear_matrix(0.18, True, (40, 52)), (40, 52)),
    ("perspective", lambda m: m.solve_perspective_coeffs(
        [(3, 2), (49, 4), (50, 37), (1, 38)],
        [(0, 0), (52, 0), (52, 40), (0, 40)]), (40, 52)),
])
@pytest.mark.parametrize("fill", [None, 255.0])
def test_homography_warp_matches(warp_images, name, build, out_hw, fill):
    """One image and a batch with a matrix each (NHWC), reflected or filled
    borders, against the JAX warp image by image, on the same matrices
    (the builders are held on their own above)."""
    mats = np.stack([np.asarray(m) for m in (
        build(jgeo), jgeo.shear_matrix(-0.1, False, (40, 52)),
        jgeo.rotation_matrix(5.0, (40, 52), out_hw))])
    ref = np.stack([np.asarray(jgeo.homography_warp(
        jnp.asarray(img), m, out_hw, fill)) for img, m in
        zip(warp_images, mats)])
    one = tgeo.homography_warp(torch.from_numpy(warp_images[0]),
                               torch.from_numpy(mats[0]), out_hw, fill)
    batch = tgeo.warp_image(torch.from_numpy(warp_images),
                            torch.from_numpy(mats), out_hw, fill)
    assert batch.shape == (3, *out_hw, 3) and batch.dtype == torch.float32
    np.testing.assert_allclose(_np(one), ref[0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(_np(batch), ref, rtol=0, atol=1e-3)


def test_uint8_warp_identity():
    img = np.random.default_rng(2).integers(0, 256, (16, 9, 3), np.uint8)
    out = tgeo.homography_warp(torch.from_numpy(img), torch.eye(3), (16, 9))
    assert np.abs(_np(out) - img).max() < 1e-3


# tests/test_geometry.py's bars against PIL, on the port's warp

@pytest.fixture(scope="module")
def pil_img():
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32)
    img = np.stack([xx * 4 % 255, yy * 4 % 255, (xx + yy) * 2 % 255], -1)
    return img.astype(np.uint8)


def _interior_close(ours, ref, margin=4, tol=18.0, frac=0.98):
    o = ours[margin:-margin, margin:-margin].astype(np.float32)
    r = ref[margin:-margin, margin:-margin].astype(np.float32)
    close = (np.abs(o - r) <= tol).mean()
    assert close >= frac, f"only {close:.3f} of interior pixels within {tol}"


def _warp(img, mat, out_hw):
    return _np(tgeo.homography_warp(torch.from_numpy(img), mat, out_hw,
                                    fill=255.0))


def _pil_cases(w=64, h=64):
    src = [(0, 0), (w, 0), (w, h), (0, h)]
    dst = [(4, 2), (w - 3, 5), (w - 2, h - 4), (2, h - 5)]
    cy = (h - 1) / 2.0
    return {
        "rotation": (lambda im: im.rotate(17.0, resample=Image.BILINEAR,
                                          fillcolor=(255, 255, 255)),
                     lambda _: tgeo.rotation_matrix(17.0, (64, 64)), 6,
                     0.98),
        "shear": (lambda im: im.transform(
            (64, 64), Image.AFFINE, (1.0, 0.15, -0.15 * cy, 0.0, 1.0, 0.0),
            resample=Image.BILINEAR, fillcolor=(255, 255, 255)),
            lambda _: tgeo.shear_matrix(0.15, True, (64, 64)), 6, 0.98),
        "perspective": (lambda im: im.transform(
            (w, h), Image.PERSPECTIVE, _np(tgeo.solve_perspective_coeffs(
                dst, src)).reshape(9)[:8].tolist(), resample=Image.BILINEAR,
            fillcolor=(255, 255, 255)),
            lambda _: tgeo.solve_perspective_coeffs(dst, src), 8, 0.98),
        "rotation_expand": (lambda im: im.rotate(
            30.0, resample=Image.BILINEAR, expand=True,
            fillcolor=(255, 255, 255)),
            lambda hw: tgeo.rotation_matrix(30.0, (64, 64), out_hw=hw), 10,
            0.95),
    }


@pytest.mark.parametrize("case", list(_pil_cases()))
def test_warps_match_pil(pil_img, case):
    pil_op, mat, margin, frac = _pil_cases()[case]
    pil = np.asarray(pil_op(Image.fromarray(pil_img)))
    out_hw = pil.shape[:2]
    _interior_close(_warp(pil_img, mat(out_hw), out_hw), pil, margin=margin,
                    frac=frac)


# --- utils/mask_utils -----------------------------------------------------


@pytest.fixture(scope="module")
def masks():
    rng = np.random.default_rng(9)
    img = _leafish_image(rng, 48)
    blob = ((img[..., 1].astype(int) - img[..., 0]) > 40).astype(np.uint8)
    noisy = (rng.random((48, 48)) < 0.3).astype(np.uint8) * 255
    return img, blob * 255, noisy


def test_mask_utils_numpy_functions_exact(masks):
    img, blob, noisy = masks
    for color in ("white", "BLACK"):
        for m in (blob, np.stack([blob] * 3, -1)):
            np.testing.assert_array_equal(tmu.apply_mask(img, m, color),
                                          jmu.apply_mask(img, m, color))
    np.testing.assert_array_equal(tmu.apply_mask(img[..., 0], blob),
                                  jmu.apply_mask(img[..., 0], blob))
    for src in (img, img[..., 1]):
        for t in (60, 127, 200):
            np.testing.assert_array_equal(tmu.create_binary_mask(src, t),
                                          jmu.create_binary_mask(src, t))
    np.testing.assert_array_equal(tmu.invert_mask(blob),
                                  jmu.invert_mask(blob))
    for op in ("or", "and"):
        np.testing.assert_array_equal(
            tmu.combine_masks([blob, noisy, blob], op),
            jmu.combine_masks([blob, noisy, blob], op))
    for m in (blob, noisy, np.zeros_like(blob)):
        assert tmu.get_mask_area(m) == jmu.get_mask_area(m)
        assert tmu.get_mask_bbox(m) == jmu.get_mask_bbox(m)
    for bad, exc in (((img, blob, "red"), ValueError),
                     ((img, blob[None, None], "white"), ValueError),
                     ((img.tolist(), blob, "white"), TypeError)):
        with pytest.raises(exc):
            tmu.apply_mask(*bad)
    with pytest.raises(ValueError):
        tmu.combine_masks([])
    with pytest.raises(ValueError):
        tmu.combine_masks([blob, blob], "xor")


@pytest.mark.parametrize("op", ["open", "close", "erode", "dilate"])
@pytest.mark.parametrize("ksize,iterations", [(3, 1), (5, 2), (7, 1)])
def test_morphological_operations_exact(masks, op, ksize, iterations):
    _, blob, noisy = masks
    for m in (blob, noisy):
        np.testing.assert_array_equal(
            tmu.apply_morphological_operations(m, op, ksize, iterations,
                                               device="cpu"),
            jmu.apply_morphological_operations(m, op, ksize, iterations))


def test_mask_to_contours_exact(masks):
    _, blob, noisy = masks
    for m in (blob, noisy, np.zeros_like(blob)):
        got, ref = tmu.mask_to_contours(m), jmu.mask_to_contours(m)
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tmu.apply_morphological_operations(blob, "tophat", device="cpu")


# --- predict/evaluation.evaluate_from_manifest ----------------------------


def test_evaluate_from_manifest_matches_jax(tiny_dataset, tmp_path):
    """A flax-layout artifact dir (JAX's writer, seeded weights) served by
    both predictors on the manifest's val split: the same metrics dict and
    the same `evaluation_results.json` apart from the confidences (1e-4)."""
    from leaffliction_tpu.cli import split as split_cli
    from leaffliction_tpu.models.leafcnn import build_leafcnn, init_model
    from leaffliction_tpu.predict.evaluation import (
        evaluate_from_manifest as jax_evaluate,
    )
    from leaffliction_tpu.predict.predictor import Predictor as JaxPredictor
    from leaffliction_tpu.train.checkpoint import save_model_msgpack
    from leaffliction_tpu_torch.predict.evaluation import (
        evaluate_from_manifest,
    )
    from leaffliction_tpu_torch.predict.predictor import Predictor

    split_cli.main(["--src", str(tiny_dataset), "--out", str(tmp_path),
                    "--val-ratio", "0.25", "--seed", "32"])
    manifest = tmp_path / "manifest_split.json"
    labels = sorted({it["label"] for it in json.loads(
        manifest.read_text())["items"]})
    learn = tmp_path / "model"
    model = build_leafcnn(len(labels), "tiny")
    params, stats, _ = init_model(model, 32, seed=3)
    save_model_msgpack(learn / "leaf_cnn.msgpack", params, stats,
                       {"mean": np.full(3, 0.6, np.float32),
                        "var": np.full(3, 0.05, np.float32)})
    (learn / "meta.json").write_text(json.dumps({
        "model_file": "leaf_cnn.msgpack", "labels": labels,
        "data": {"img_size": 32, "num_classes": len(labels)},
        "model": {"name": "leaf_cnn", "widths": [16, 32, 64],
                  "separable": False, "use_normalization": True,
                  "stem": "conv"},
        "training": {"mixed_precision": False}}))
    ours = evaluate_from_manifest(Predictor(learn, device="cpu").load(),
                                  manifest, "val", tmp_path / "ours")
    ref = jax_evaluate(JaxPredictor(learn).load(), manifest, "val",
                       tmp_path / "ref")
    assert ours == ref and "accuracy" in ours
    got, want = (json.loads((tmp_path / side / "evaluation_results.json")
                            .read_text()) for side in ("ours", "ref"))
    assert got["metrics"] == want["metrics"]
    assert got["evaluation_info"] == want["evaluation_info"]
    assert len(got["detailed_results"]) == 9
    for a, b in zip(got["detailed_results"], want["detailed_results"]):
        assert a["confidence"] == pytest.approx(b["confidence"], abs=1e-4)
        a.pop("confidence"), b.pop("confidence")
        assert a == b
    assert evaluate_from_manifest(Predictor(learn, device="cpu").load(),
                                  manifest, "nope") == {}


# --- utils/metrics, utils/viz, utils/image_io -----------------------------


@pytest.mark.parametrize("classes,seed", [(2, 0), (4, 1)])
def test_metric_writers_same_bytes(tmp_path, classes, seed, caplog):
    rng = np.random.default_rng(seed)
    y_true = rng.integers(0, classes, 40).tolist()
    y_pred = rng.integers(0, classes, 40).tolist()
    labels = [f"Plant__c{i}" for i in range(classes)]
    logs = {}
    for side, mod in (("t", tmetrics), ("j", jmetrics)):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            got = mod.compute_evaluation_metrics(y_true, y_pred, labels,
                                                 tmp_path / side)
        logs[side] = [r.getMessage() for r in caplog.records]
        mod.save_metrics_json(got, tmp_path / side / "again.json")
    for name in ("metrics.json", "again.json"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
    assert logs["t"] == logs["j"] and len(logs["t"]) == 4 + classes


def test_create_confusion_matrix_writes_json_and_png(tmp_path):
    pytest.importorskip("matplotlib")
    results = [{"image_path": f"/d/Plant__c{i % 3}/img{i}.jpg",
                "top_prediction": f"Plant__c{(i * 7) % 4}"}
               for i in range(20)]
    out = tviz.create_confusion_matrix(results, tmp_path / "t" / "cm.png")
    ref = jviz.create_confusion_matrix(results, tmp_path / "j" / "cm.png")
    assert out.name == ref.name == "cm.png"
    assert (tmp_path / "t" / "cm.json").read_bytes() == \
        (tmp_path / "j" / "cm.json").read_bytes()
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert tviz.create_confusion_matrix([], tmp_path / "none.png") is None


def test_create_confusion_matrix_without_matplotlib(tmp_path, monkeypatch,
                                                    caplog):
    """Where matplotlib is missing (the card's machine), the JSON is
    written, the PNG skipped with one warning."""
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.startswith("matplotlib"):
            raise ImportError("no matplotlib here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with caplog.at_level(logging.WARNING):
        out = tviz.create_confusion_matrix(
            [{"image_path": "/d/a/x.jpg", "top_prediction": "b"}],
            tmp_path / "cm.png")
    assert not out.exists()
    assert json.loads((tmp_path / "cm.json").read_text()) == {
        "matrix": [[0, 1], [0, 0]], "labels": ["a", "b"]}
    warnings = [r.getMessage() for r in caplog.records
                if r.levelno == logging.WARNING]
    assert len(warnings) == 1 and "matplotlib" in warnings[0]


def test_image_transforms_exact():
    rng = np.random.default_rng(4)
    arr = rng.integers(0, 256, (37, 23, 3), np.uint8)
    img = Image.fromarray(arr)
    for size in (16, (30, 11), 64):
        np.testing.assert_array_equal(
            np.asarray(tio.ImageTransforms.resize_image(img, size)),
            np.asarray(jio.ImageTransforms.resize_image(img, size)))
    got = tio.ImageTransforms.normalize_array(arr)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got,
                                  jio.ImageTransforms.normalize_array(arr))


# --- segment/hist.color_region_percentages --------------------------------


def test_color_region_percentages_match():
    cv2 = pytest.importorskip("cv2")
    from leaffliction_tpu.segment.hist import (
        color_region_percentages as jax_regions,
    )
    from leaffliction_tpu_torch.segment.hist import color_region_percentages

    rng = np.random.default_rng(7)
    img = _leafish_image(rng, 96)
    img[10:20, 10:25] = [150, 90, 40]
    img[70:80, 60:75] = [210, 200, 60]
    ours = color_region_percentages(img, device="cpu")
    assert ours == jax_regions(img)
    # tests/test_hist_oracle.py's cv2 oracle at its bar
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(int)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    mask = (s > 10) & (v > 15) & (v < 245)
    total = max(mask.sum(), 1)
    oracle = {
        "Vert Sain": (h >= 35) & (h <= 85) & (s >= 40) & (v >= 30),
        "Jaune": (h >= 15) & (h <= 35) & (s >= 50) & (v >= 50),
        "Zones Sombres": (v <= 50) & (s >= 20),
        "Zones Claires": (v >= 200) & (s <= 30),
    }
    for key, cond in oracle.items():
        assert ours[key] == pytest.approx((mask & cond).sum() / total * 100,
                                          abs=1.5), key


# --- ops: image, photometric, colorspace, threshold, filters --------------


@pytest.fixture(scope="module")
def batch_u8():
    return np.random.default_rng(12).integers(0, 256, (2, 20, 28, 3),
                                              np.uint8)


def test_image_helpers_match(batch_u8):
    f = batch_u8.astype(np.float32) / 255.0
    for x in (batch_u8, f):
        np.testing.assert_allclose(_np(timage.to_float(torch.from_numpy(x))),
                                   np.asarray(jimage.to_float(
                                       jnp.asarray(x))), rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            _np(timage.normalize_to_unit(torch.from_numpy(x))),
            np.asarray(jimage.normalize_to_unit(jnp.asarray(x))), rtol=0,
            atol=1e-6)
    mean = np.array([0.4, 0.5, 0.45], np.float32)
    var = np.array([0.05, 0.08, 0.06], np.float32)
    got = timage.standardize(torch.from_numpy(batch_u8),
                             torch.from_numpy(mean), torch.from_numpy(var))
    ref = np.asarray(jimage.standardize(jnp.asarray(batch_u8), mean, var))
    np.testing.assert_allclose(_np(got), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size", [(10, 14), (33, 50), (20, 9)])
@pytest.mark.parametrize("antialias", [True, False])
def test_resize_bilinear_matches(batch_u8, size, antialias):
    got = timage.resize_bilinear(torch.from_numpy(batch_u8), size, antialias)
    ref = np.asarray(jimage.resize_bilinear(jnp.asarray(batch_u8), size,
                                            antialias))
    assert got.shape == ref.shape == (2, *size, 3)
    # on [0, 255]: the output is in [0, 1], so the bar is 5e-3 / 255
    np.testing.assert_allclose(_np(got), ref, rtol=0, atol=5e-3 / 255.0)


def test_photometric_match(batch_u8):
    x = batch_u8.astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for factor in (0.5, 1.3, np.array([0.8, 1.6], np.float32)[:, None, None,
                                                               None]):
        np.testing.assert_allclose(
            _np(tphoto.adjust_contrast(xt, torch.as_tensor(factor))),
            np.asarray(jphoto.adjust_contrast(xj, factor)), rtol=0,
            atol=255e-6)
    for delta in (-40.0, 25.5):
        np.testing.assert_array_equal(
            _np(tphoto.adjust_brightness(xt, delta)),
            np.asarray(jphoto.adjust_brightness(xj, delta)))
    # JAX's draw injected: the key's N(0, 1) values
    key = jax.random.key(5)
    normal = np.array(jax.random.normal(key, x.shape, jnp.float32))
    for sigma in (5.0, 30.0):
        np.testing.assert_allclose(
            _np(tphoto.add_gaussian_noise(None, xt, sigma,
                                          normal=torch.from_numpy(normal))),
            np.asarray(jphoto.add_gaussian_noise(key, xj, sigma)), rtol=0,
            atol=255e-6)
    gen = torch.Generator().manual_seed(0)
    drawn = tphoto.add_gaussian_noise(gen, xt, 5.0)
    assert drawn.shape == xt.shape and 0 <= float(drawn.min()) and \
        float(drawn.max()) <= 255
    assert 3.5 < float((drawn - xt)[(xt > 30) & (xt < 225)].std()) < 6.5


def test_hsv_to_rgb_matches(batch_u8):
    hsv = np.array(jcs.rgb_to_hsv(jnp.asarray(batch_u8)))
    hsv[0, 0, :6, 0] = [0.0, 29.999, 30.0, 89.99, 150.0, 179.99]  # sectors
    got = tcs.hsv_to_rgb(torch.from_numpy(hsv))
    ref = np.asarray(jcs.hsv_to_rgb(jnp.asarray(hsv)))
    np.testing.assert_allclose(_np(got), ref, rtol=0, atol=255e-6)
    # and back: the round trip of rgb_to_hsv
    np.testing.assert_allclose(_np(got)[1], batch_u8[1], rtol=0, atol=1e-3)


def test_in_range_exact(batch_u8):
    lo, hi = [20, 40, 60], [200, 220, 240]
    np.testing.assert_array_equal(
        _np(tthr.in_range(torch.from_numpy(batch_u8), lo, hi)),
        np.asarray(jthr.in_range(jnp.asarray(batch_u8), lo, hi)))
    gray = batch_u8[0, ..., 0]
    np.testing.assert_array_equal(
        _np(tthr.in_range(torch.from_numpy(gray), np.full((20, 28), 50),
                          np.full((20, 28), 150))),
        np.asarray(jthr.in_range(jnp.asarray(gray), np.full((20, 28), 50),
                                 np.full((20, 28), 150))))


def test_sobel_magnitude_and_sectors_match(batch_u8):
    gray = batch_u8[0].astype(np.float32).mean(-1)
    got = tfilters.sobel_magnitude(torch.from_numpy(gray))
    ref = np.asarray(jfilters.sobel_magnitude(jnp.asarray(gray)))
    np.testing.assert_allclose(_np(got), ref, rtol=1e-6, atol=1e-3)
    gx, gy = jfilters.sobel_xy(jnp.asarray(gray))
    gx, gy = np.array(gx), np.array(gy)
    gx[0, :4], gy[0, :4] = [1.0, -1.0, 0.0, 2.0], [1.0, 1.0, 0.0, -5.0]
    np.testing.assert_array_equal(
        _np(tfilters.quantize_gradient_sector(torch.from_numpy(gx),
                                              torch.from_numpy(gy))),
        np.asarray(jfilters.quantize_gradient_sector(jnp.asarray(gx),
                                                     jnp.asarray(gy))))
