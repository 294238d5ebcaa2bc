"""Segmentation in the PyTorch port, held against the JAX package.

Colorspaces at atol 1e-3 (float32, cube root by pow in the port); morphology
and Otsu exact; the TransformConfig copy field by field; the full default mask
pipeline (`make_mask_single`, which runs K4 and K5's twins) on leaf-like 64²
images: ≥ 99.9% of pixels agree and the score within 1e-3; the other
strategies, k-means among them (JAX's initial centres injected), and shadow
suppression, at the same pixel bar and 2e-3.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import _leafish_image  # noqa: E402
from leaffliction_tpu.ops import colorspace as jcs  # noqa: E402
from leaffliction_tpu.ops import morphology as jmo  # noqa: E402
from leaffliction_tpu.ops import threshold as jth  # noqa: E402
from leaffliction_tpu.segment import mask as jmask  # noqa: E402
from leaffliction_tpu.segment.config import (  # noqa: E402
    TransformConfig as JaxConfig,
)
from leaffliction_tpu_torch.ops import colorspace as tcs  # noqa: E402
from leaffliction_tpu_torch.ops import morphology as tmo  # noqa: E402
from leaffliction_tpu_torch.ops import threshold as tth  # noqa: E402
from leaffliction_tpu_torch.segment import mask as tmask  # noqa: E402
from leaffliction_tpu_torch.segment.config import TransformConfig  # noqa: E402

torch.set_num_threads(1)


def _rgb(seed, h=40, w=56):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


@pytest.mark.parametrize("name", ["rgb_to_gray", "rgb_to_hsv", "rgb_to_lab"])
def test_colorspaces_match_jax(name):
    rgb = _rgb(0)
    ours = getattr(tcs, name)(torch.from_numpy(rgb)).numpy()
    ref = np.asarray(getattr(jcs, name)(jnp.asarray(rgb)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("shape", ["rect", "ellipse"])
@pytest.mark.parametrize("ksize", [3, 5, 9, 20])
def test_morphology_matches_jax(ksize, shape):
    m = np.random.default_rng(ksize).random((40, 56)) < 0.5
    tm, jm = torch.from_numpy(m), jnp.asarray(m)
    for op in ("dilate", "erode", "opening", "closing"):
        np.testing.assert_array_equal(
            getattr(tmo, op)(tm, ksize, shape).numpy(),
            np.asarray(getattr(jmo, op)(jm, ksize, shape)), err_msg=op)


def test_ellipse_kernel_matches_jax():
    for k in range(1, 41):
        np.testing.assert_array_equal(tmo._ellipse_kernel(k),
                                      jmo._ellipse_kernel(k))


@pytest.mark.parametrize("invert", [False, True])
def test_otsu_matches_jax(invert):
    img = _rgb(1)[..., 1].astype(np.float32) * 0.9 + 7.3
    ours = tth.otsu_binarize(torch.from_numpy(img), invert=invert)
    ref = jth.otsu_binarize(jnp.asarray(img), invert=invert)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert float(tth.otsu_threshold(torch.from_numpy(img))) == float(
        jth.otsu_threshold(jnp.asarray(img)))


def test_transform_config_matches_jax_field_by_field():
    ours = dataclasses.fields(TransformConfig)
    ref = dataclasses.fields(JaxConfig)
    assert [f.name for f in ours] == [f.name for f in ref]
    for a, b in zip(ours, ref):
        assert a.default == b.default, a.name
        assert str(a.type) == str(b.type), a.name


def test_geometry_helpers_match_jax():
    for seed in range(4):
        img = _leafish_image(np.random.default_rng(seed), 64)
        m = np.asarray(jmask.make_mask_single(jnp.asarray(img))[0])
        tm, jm = torch.from_numpy(m), jnp.asarray(m)
        assert abs(float(tmask.convex_hull_area_approx(tm))
                   - float(jmask.convex_hull_area_approx(jm))) <= 1e-3
        np.testing.assert_array_equal(tmask.bounding_rect(tm).numpy(),
                                      np.asarray(jmask.bounding_rect(jm)))


@pytest.mark.parametrize("seed", range(4))
def test_make_mask_single_matches_jax(seed):
    img = _leafish_image(np.random.default_rng(100 + seed), 64)
    mask, score = tmask.make_mask_single(torch.from_numpy(img))
    ref_mask, ref_score = jmask.make_mask_single(jnp.asarray(img))
    agree = (mask.numpy() == np.asarray(ref_mask)).mean()
    assert agree >= 0.999
    assert abs(float(score) - float(ref_score)) <= 1e-3
    white = tmask.apply_mask_white(torch.from_numpy(img), mask).numpy()
    ref_white = np.asarray(jmask.apply_mask_white(jnp.asarray(img),
                                                  ref_mask))
    assert (white == ref_white).all(axis=-1).mean() >= 0.999


@pytest.mark.parametrize("strategy", ["hsv_s", "hsv_v_dark", "hsv_h", "lab",
                                      "enhanced"])
def test_other_strategies_match_jax(strategy):
    img = _leafish_image(np.random.default_rng(7), 64)
    cfg = TransformConfig(mask_strategy=strategy, grabcut_refine=False)
    jcfg = JaxConfig(mask_strategy=strategy, grabcut_refine=False)
    mask, score = tmask.make_mask_core(torch.from_numpy(img), cfg)
    ref_mask, ref_score = jmask.make_mask_core(jnp.asarray(img), jcfg)
    assert (mask.numpy() == np.asarray(ref_mask)).mean() >= 0.999
    # 2e-3: for hsv_v_dark the jitted JAX pipeline differs from its own
    # eager run (which the port matches exactly) by one candidate pixel, and
    # that pixel moves the score by 1.1e-3
    assert abs(float(score) - float(ref_score)) <= 2e-3


def test_fallback_mask_matches_jax():
    img = _leafish_image(np.random.default_rng(8), 64)
    ours = tmask.fallback_mask(torch.from_numpy(img), TransformConfig())
    ref = jmask.fallback_mask(jnp.asarray(img, jnp.float32), JaxConfig())
    assert (ours.numpy() == np.asarray(ref)).mean() >= 0.999


@pytest.mark.parametrize("fields", [{"mask_strategy": "kmeans"},
                                    {"mask_strategy": "auto"},
                                    {"shadow_suppression": True}])
def test_kmeans_paths_match_jax(fields, monkeypatch):
    """The strategies that run k-means, with JAX's initial centres injected
    (`tests/jax_draws.jax_kmeans_init`): masks on ≥ 99.9% of pixels, the
    score within 2e-3 (the bar of the other strategies)."""
    from jax_draws import jax_kmeans_init
    from leaffliction_tpu_torch.ops import kmeans as tkm

    monkeypatch.setattr(tkm, "init_indices", jax_kmeans_init)
    img = _leafish_image(np.random.default_rng(9), 64)
    cfg = TransformConfig(grabcut_refine=False, **fields)
    jcfg = JaxConfig(grabcut_refine=False, **fields)
    mask, score = tmask.make_mask_core(torch.from_numpy(img), cfg)
    ref_mask, ref_score = jmask.make_mask_core(jnp.asarray(img), jcfg)
    assert (mask.numpy() == np.asarray(ref_mask)).mean() >= 0.999
    assert abs(float(score) - float(ref_score)) <= 2e-3
