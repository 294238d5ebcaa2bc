"""The seven analysis filters of the PyTorch port, held against the JAX
package on a leaf-like 96² image with brown spots, each side given the same
image, mask and contour:

- Blur and the masked views: ≥ 99.9% of pixels within 1 LSB;
- ROI: the same rectangle, the canvas and overlay within 1 LSB;
- Analyze: `shape_metrics` within 1e-4 relative, the overlay ≥ 99.9% of
  pixels within 1 LSB;
- Landmarks: the same vein corners and disease components, the drawing
  ≥ 99.9% of pixels within 1 LSB;
- Hist: every statistic of `hist_dispatch` (the colour shares and the three
  60-bin densities within 1e-5, the hue counts and the masked pixel count
  exact) and the rendered figure equal JAX's, on the leaf and on an image
  of uniformly random colours, each with the pixels whose hue or
  saturation lies on a bin or gate edge left out (`_off_the_edges`);
- Brown: the same region count, the percentage within 1e-4, the overlay
  exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import _leafish_image  # noqa: E402
from leaffliction_tpu.ops import colorspace as jcs  # noqa: E402
from leaffliction_tpu.segment import analyze as jan  # noqa: E402
from leaffliction_tpu.segment import blur as jblur  # noqa: E402
from leaffliction_tpu.segment import brown as jbrown  # noqa: E402
from leaffliction_tpu.segment import hist as jhist  # noqa: E402
from leaffliction_tpu.segment import landmarks as jlm  # noqa: E402
from leaffliction_tpu.segment import mask as jmask  # noqa: E402
from leaffliction_tpu.segment import roi as jroi  # noqa: E402
from leaffliction_tpu.segment.config import (  # noqa: E402
    TransformConfig as JaxConfig,
)
from leaffliction_tpu_torch.segment import analyze as tan  # noqa: E402
from leaffliction_tpu_torch.segment import blur as tblur  # noqa: E402
from leaffliction_tpu_torch.segment import brown as tbrown  # noqa: E402
from leaffliction_tpu_torch.segment import hist as thist  # noqa: E402
from leaffliction_tpu_torch.segment import landmarks as tlm  # noqa: E402
from leaffliction_tpu_torch.segment import roi as troi  # noqa: E402
from leaffliction_tpu_torch.segment.config import TransformConfig  # noqa: E402

torch.set_num_threads(1)

FIELDS = dict(mask_upscale_factor=1.0, mask_upscale_long_side=0,
              grabcut_refine=False)
CFG, JCFG = TransformConfig(**FIELDS), JaxConfig(**FIELDS)


def _within_1lsb(a, b, share=0.999):
    a, b = np.asarray(a, np.int32), np.asarray(b, np.int32)
    assert a.shape == b.shape
    close = (np.abs(a - b) <= 1)
    if close.ndim == 3:
        close = close.all(-1)
    assert close.mean() >= share, close.mean()


@pytest.fixture(scope="module")
def leaf():
    """(masked uint8 image, mask u8, contour) from the JAX host mask."""
    rng = np.random.default_rng(17)
    img = _leafish_image(rng, 96)
    yy, xx = np.mgrid[0:96, 0:96]
    for cy, cx, r in ((40, 40, 6), (55, 58, 5), (47, 30, 3)):
        spot = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        img[spot] = (120, 70, 30)
    mask, contour = jmask.make_mask(img, JCFG)
    masked = np.where(mask[..., None] > 0, img, 255).astype(np.uint8)
    return masked, mask, contour


def test_blur_and_masked_views_match_jax(leaf):
    masked, mask, _ = leaf
    ours = tblur.blur_filter(torch.from_numpy(masked),
                             torch.from_numpy(mask > 0), CFG).numpy()
    ref = np.asarray(jblur.blur_filter(jnp.asarray(masked, jnp.float32),
                                       jnp.asarray(mask > 0), JCFG))
    _within_1lsb(ours, ref)


def test_roi_matches_jax(leaf):
    masked, _, contour = leaf
    canvas, vis, rect = troi.roi_filter(masked, contour, CFG, device="cpu")
    r_canvas, r_vis, r_rect = jroi.roi_filter(masked, contour, JCFG)
    assert rect == r_rect
    _within_1lsb(canvas, r_canvas)
    np.testing.assert_array_equal(vis, r_vis)


def test_analyze_matches_jax(leaf):
    masked, mask, contour = leaf
    ours = tan.shape_metrics(mask, contour)
    ref = jan.shape_metrics(mask, contour)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], rel=1e-4, abs=1e-9), k
    img = tan.analyze_filter(masked, mask, contour, CFG, device="cpu")
    r_img = jan.analyze_filter(masked, mask, contour, JCFG)
    _within_1lsb(img, r_img)


def test_landmarks_match_jax(leaf):
    masked, mask, contour = leaf
    reuse = (lambda _rgb: (mask, contour))
    handles = tlm.landmarks_dispatch(masked, contour, CFG, reuse, "cpu")
    r_handles = jlm.landmarks_dispatch(masked, contour, JCFG, reuse)
    np.testing.assert_array_equal(handles["mask"].numpy(),
                                  np.asarray(r_handles["mask"]))
    ys, xs, valid, _ = (t.numpy() for t in handles["veins"])
    rys, rxs, rvalid, _ = map(np.asarray, r_handles["veins"])
    ours = [(y, x) for y, x, ok in zip(ys, xs, valid) if ok]
    ref = [(y, x) for y, x, ok in zip(rys, rxs, rvalid) if ok]
    assert len(ours) > 0 and ours == ref
    labels, r_labels = handles["labels"].numpy(), np.asarray(
        r_handles["labels"])
    np.testing.assert_array_equal(labels > 0, r_labels > 0)
    assert len(np.unique(labels)) == len(np.unique(r_labels)) > 1
    _within_1lsb(tlm.landmarks_finish(masked, handles, CFG),
                 jlm.landmarks_finish(masked, r_handles, JCFG))


def _random_colours():
    """Every byte value in every channel, hue and saturation on many bin
    and gate edges: 96² pixels drawn uniformly."""
    return np.random.default_rng(19).integers(0, 256, (96, 96, 3),
                                              dtype=np.uint8)


# where `hist_dispatch` cuts H and S: its gates and its 60 bins' edges
_H_EDGES = np.union1d([10, 15, 20, 25, 35, 40, 85, 120, 160],
                      np.arange(61) * 3.0)
_S_EDGES = np.union1d([10, 20, 25, 30, 40, 50], np.arange(61) * 4.25)


def _off_the_edges(rgb):
    """(`rgb` with white, masked out on both sides, where JAX's hue or
    saturation lies within 4 ulps of an edge; how many masked pixels that
    left out). XLA on the CPU rewrites the HSV arithmetic inside its fused
    statistics program, so a colour whose exact hue is an edge (hue is
    30·k/c with c ≤ 255, so every other colour is 1/255 or more away) comes
    out an ulp to either side of it there, while the port's lands on it."""
    hsv = np.asarray(jax.jit(jcs.rgb_to_hsv)(jnp.asarray(rgb, jnp.float32)))
    s, v = hsv[..., 1], hsv[..., 2]
    near = np.zeros(rgb.shape[:2], bool)
    for ch, edges in ((0, _H_EDGES), (1, _S_EDGES)):
        e = edges.astype(np.float32)
        near |= (np.abs(hsv[..., ch, None] - e) <= 4 * np.spacing(e)).any(-1)
    out = rgb.copy()
    out[near] = 255
    return out, int((near & (s > 10) & (v > 15) & (v < 245)).sum())


@pytest.mark.parametrize("image", ["leaf", "random_colours"])
def test_hist_statistics_and_figure_match_jax(image, leaf):
    rgb, left_out = _off_the_edges(leaf[0] if image == "leaf"
                                   else _random_colours())
    ours = [t.numpy() for t in thist.hist_dispatch(torch.from_numpy(rgb))]
    ref = [np.asarray(t) for t in jhist.hist_dispatch(rgb)]
    assert int(ours[5]) == int(ref[5]) >= 4 * left_out
    np.testing.assert_array_equal(ours[4], ref[4])  # hue counts
    for a, b in zip(ours[:4], ref[:4]):  # colour shares, H, S, V densities
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    pytest.importorskip("matplotlib")
    np.testing.assert_array_equal(
        thist.histogram_filter(rgb, CFG, device="cpu"),
        jhist.histogram_filter(rgb, JCFG))


def test_hist_without_matplotlib_logs_and_skips(leaf, monkeypatch, caplog):
    import builtins

    real_import = builtins.__import__

    def no_mpl(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    thist._warn_no_matplotlib.cache_clear()
    with caplog.at_level("INFO"):
        assert thist.histogram_filter(leaf[0], CFG, device="cpu") is None
        assert thist.histogram_filter(leaf[0], CFG, device="cpu") is None
    warnings = [r for r in caplog.records if r.levelname == "WARNING"]
    assert len(warnings) == 1 and "matplotlib" in warnings[0].getMessage()
    assert sum("Hist statistics" in r.getMessage()
               for r in caplog.records) == 2


def test_brown_matches_jax(leaf):
    masked, mask, _ = leaf
    vis, pct, count = tbrown.brown_filter(masked, mask > 0, CFG,
                                          device="cpu")
    r_vis, r_pct, r_count = jbrown.brown_filter(masked, mask > 0, JCFG)
    assert count == r_count and count >= 2
    assert pct == pytest.approx(r_pct, rel=1e-4)
    np.testing.assert_array_equal(vis, r_vis)
