"""The host mask entry and the batched mask pipeline of the PyTorch port,
held against the JAX package on leaf-like 64² and 96² images:

- `segment/grabcut.grabcut_refine` against JAX's on ≥ 99.9% of pixels;
- `segment/mask.make_mask` at the default config (1.3× cubic upscale, the
  inclusive strategy, GrabCut, the rescore, the nearest downscale) with
  GrabCut through cv2 (`LEAF_GRABCUT=cv2`, cv2's RNG reseeded before each
  side) and on the device (`LEAF_GRABCUT=device`): masks on ≥ 99.9% of
  pixels, the contour of the same length within 2%;
- `make_mask_batch` against `make_mask_core` per image (the JAX package's
  `test_mask_batch_matches_core` pattern): masks on ≥ 99.9% of pixels,
  scores within 2e-3; and both against JAX's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import _leafish_image  # noqa: E402
from leaffliction_tpu.segment import grabcut as jgc  # noqa: E402
from leaffliction_tpu.segment import mask as jmask  # noqa: E402
from leaffliction_tpu.segment.config import (  # noqa: E402
    TransformConfig as JaxConfig,
)
from leaffliction_tpu_torch.segment import grabcut as tgc  # noqa: E402
from leaffliction_tpu_torch.segment import mask as tmask  # noqa: E402
from leaffliction_tpu_torch.segment.config import TransformConfig  # noqa: E402

torch.set_num_threads(1)

NO_UPSCALE = dict(mask_upscale_factor=1.0, mask_upscale_long_side=0,
                  grabcut_refine=False)


def _leaf(seed, size):
    return _leafish_image(np.random.default_rng(seed), size)


@pytest.mark.parametrize("seed,size", [(0, 64), (1, 96)])
def test_grabcut_refine_matches_jax(seed, size):
    img = _leaf(seed, size)
    m = np.asarray(jmask.make_mask_single(jnp.asarray(img))[0])
    ours = tgc.grabcut_refine(torch.from_numpy(img).float(),
                              torch.from_numpy(m)).numpy()
    ref = np.asarray(jgc.grabcut_refine(jnp.asarray(img, jnp.float32),
                                        jnp.asarray(m)))
    assert (ours == ref).mean() >= 0.999
    assert ours.sum() > 0 and not (ours & ~m).any()


def test_grabcut_keeps_the_mask_when_the_cut_empties():
    img = np.zeros((32, 32, 3), np.uint8)
    m = np.zeros((32, 32), bool)
    m[8:24, 8:24] = True
    ours = tgc.grabcut_refine(torch.from_numpy(img).float(),
                              torch.from_numpy(m)).numpy()
    ref = np.asarray(jgc.grabcut_refine(jnp.asarray(img, jnp.float32),
                                        jnp.asarray(m)))
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("mode", ["cv2", "device", "off"])
def test_make_mask_matches_jax(mode, monkeypatch):
    cv2 = pytest.importorskip("cv2") if mode == "cv2" else None
    monkeypatch.setenv("LEAF_GRABCUT", mode)
    img = _leaf(21, 64)
    if cv2 is not None:
        cv2.setRNGSeed(7)
    mask, contour = tmask.make_mask(img, TransformConfig(), device="cpu")
    if cv2 is not None:
        cv2.setRNGSeed(7)
    ref_mask, ref_contour = jmask.make_mask(img, JaxConfig())
    assert mask.shape == (64, 64) and mask.dtype == np.uint8
    assert set(np.unique(mask)) <= {0, 255}
    assert (mask == ref_mask).mean() >= 0.999
    assert contour is not None and ref_contour is not None
    assert abs(len(contour) - len(ref_contour)) <= 0.02 * len(ref_contour)


def test_make_mask_batch_matches_core_and_jax():
    img = _leaf(5, 96)
    imgs = np.stack([img, img[::-1].copy()])
    cfg, jcfg = TransformConfig(**NO_UPSCALE), JaxConfig(**NO_UPSCALE)
    masks, scores = tmask.make_mask_batch(torch.from_numpy(imgs), cfg)
    ref_masks, ref_scores = jmask.make_mask_batch(
        jnp.asarray(imgs.astype(np.float32)), jcfg)
    for i in range(2):
        core, core_score = tmask.make_mask_core(torch.from_numpy(imgs[i]),
                                                cfg)
        assert (masks[i].numpy() == core.numpy()).mean() >= 0.999
        assert abs(float(scores[i]) - float(core_score)) <= 2e-3
        assert (masks[i].numpy() == np.asarray(ref_masks[i])).mean() >= 0.999
        assert abs(float(scores[i]) - float(ref_scores[i])) <= 2e-3


def test_finalize_runs_the_fallback_on_failed_scores():
    """A chunk whose score is ≤ 0 takes the extended Otsu fallback, as the
    JAX package's `finalize_mask_batch`."""
    img = _leaf(6, 64)
    imgs = torch.from_numpy(np.stack([img, img]))
    cfg = TransformConfig(**NO_UPSCALE)
    extended, scores = tmask.make_mask_batch_async(imgs, cfg)
    forced = torch.tensor([float(scores[0]), -1.0])
    out = tmask.finalize_mask_batch(imgs, extended, forced, cfg)
    x = imgs[1:].float()
    want = tmask.extend_with_brown(tmask.fallback_mask(x, cfg), x, cfg)[0]
    assert torch.equal(out[0], extended[0]) and torch.equal(out[1], want)
    ref = np.asarray(jmask._fallback_extend_core(
        jnp.asarray(img), JaxConfig(**NO_UPSCALE)))
    assert (out[1].numpy() == ref).mean() >= 0.999


def test_apply_mask_black_matches_jax():
    img = _leaf(8, 64)
    m = np.random.default_rng(8).random((64, 64)) < 0.5
    ours = tmask.apply_mask_black(torch.from_numpy(img),
                                  torch.from_numpy(m)).numpy()
    ref = np.asarray(jmask.apply_mask_black(jnp.asarray(img),
                                            jnp.asarray(m)))
    np.testing.assert_array_equal(ours, ref)
