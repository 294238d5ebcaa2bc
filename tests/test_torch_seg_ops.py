"""The segmentation ops of the PyTorch port, held against the JAX package on
the same numpy inputs:

- `ops/image.resize` against `jax.image.resize` on a table of (in, out,
  method) cases, up and down, on uniform noise (the worst case for the
  taps): `nearest` exact; `linear` and `cubic` within 5e-3 on [0, 255].
  XLA compiles the weight arithmetic with fused multiply-adds and
  reciprocals, so its float32 weights are not the plain ones, and at
  96 → 125 cubic JAX's own output is the one far from exact: against a
  float64 contraction of the plain weights (eager `compute_weight_mat`'s)
  the port is held at 1e-4 and JAX at 5e-3;
- `ops/kmeans.kmeans_pixels` with JAX's initial centres injected: labels
  exact, centres within 1e-4;
- `ops/clahe.clahe` within 1e-3;
- `ops/filters.good_features_to_track`: the same valid corners, in order;
- `ops/filters.canny` over a batch: each image's edges as its own call.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import _leafish_image  # noqa: E402
from jax_draws import jax_kmeans_init  # noqa: E402
from leaffliction_tpu.ops import clahe as jclahe  # noqa: E402
from leaffliction_tpu.ops import filters as jf  # noqa: E402
from leaffliction_tpu.ops import kmeans as jkm  # noqa: E402
from leaffliction_tpu_torch.ops import clahe as tclahe  # noqa: E402
from leaffliction_tpu_torch.ops import filters as tf  # noqa: E402
from leaffliction_tpu_torch.ops import kmeans as tkm  # noqa: E402
from leaffliction_tpu_torch.ops.image import resize  # noqa: E402

torch.set_num_threads(1)

RESIZE_CASES = [
    ((64, 64, 3), (83, 83, 3), "cubic"),      # the 1.3x mask upscale
    ((96, 96, 3), (125, 125, 3), "cubic"),
    ((83, 83, 3), (64, 64, 3), "cubic"),
    ((125, 125, 3), (62, 62, 3), "linear"),   # the GrabCut half size
    ((62, 62, 3), (125, 125, 3), "linear"),
    ((333, 333, 3), (160, 160, 3), "linear"),  # the GrabCut fit size
    ((96, 64, 3), (40, 50, 3), "linear"),
    ((2, 64, 64, 3), (2, 83, 83, 3), "cubic"),  # a batch axis passes
    ((83, 83), (64, 64), "nearest"),          # the mask back down
    ((256, 256), (333, 333), "nearest"),
    ((333, 333), (256, 256), "nearest"),
    ((64, 83), (71, 134), "nearest"),
]


@pytest.mark.parametrize("shape_in,shape_out,method", RESIZE_CASES)
def test_resize_matches_jax(shape_in, shape_out, method):
    x = np.random.default_rng(len(shape_in) + shape_out[0]).integers(
        0, 256, shape_in).astype(np.float32)
    ours = resize(torch.from_numpy(x), shape_out, method).numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(x), shape_out, method))
    assert ours.shape == ref.shape
    if method == "nearest":
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=5e-3)


@pytest.mark.parametrize("shape_in,shape_out,method",
                         [c for c in RESIZE_CASES if c[2] != "nearest"])
def test_resize_matches_a_float64_contraction(shape_in, shape_out, method):
    from leaffliction_tpu_torch.ops.image import _resize_weights

    x = np.random.default_rng(len(shape_in) + shape_out[0]).integers(
        0, 256, shape_in).astype(np.float32)
    exact = torch.from_numpy(x).double()
    for d, (m, n) in enumerate(zip(shape_in, shape_out)):
        if m != n:
            w = _resize_weights(m, n, method).double()
            exact = torch.movedim(torch.tensordot(exact, w, dims=([d], [0])),
                                  -1, d)
    ours = resize(torch.from_numpy(x), shape_out, method).double()
    ref = np.asarray(jax.image.resize(jnp.asarray(x), shape_out, method))
    assert float((ours - exact).abs().max()) <= 1e-4
    assert float(np.abs(ref - exact.numpy()).max()) <= 5e-3


@pytest.mark.parametrize("k,seed", [(3, 12345), (5, 7)])
def test_kmeans_pixels_matches_jax(k, seed, monkeypatch):
    monkeypatch.setattr(tkm, "init_indices", jax_kmeans_init)
    img = _leafish_image(np.random.default_rng(k), 64).astype(np.float32)
    labels, centers = tkm.kmeans_pixels(torch.from_numpy(img), k=k,
                                        iters=10, seed=seed)
    ref_labels, ref_centers = jkm.kmeans_pixels(jnp.asarray(img), k=k,
                                                iters=10, seed=seed)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_labels))
    np.testing.assert_allclose(centers.numpy(), np.asarray(ref_centers),
                               rtol=0, atol=1e-4)
    # a batch gives each image its own clustering
    both = torch.from_numpy(np.stack([img, img[::-1].copy()]))
    b_labels, b_centers = tkm.kmeans_pixels(both, k=k, iters=10, seed=seed)
    np.testing.assert_array_equal(b_labels[0].numpy(), labels.numpy())


def test_kmeans_segment_greenest_matches_jax(monkeypatch):
    monkeypatch.setattr(tkm, "init_indices", jax_kmeans_init)
    img = _leafish_image(np.random.default_rng(11), 64).astype(np.float32)
    ours = tkm.kmeans_segment_greenest(torch.from_numpy(img)).numpy()
    ref = np.asarray(jkm.kmeans_segment_greenest(jnp.asarray(img)))
    np.testing.assert_array_equal(ours, ref)


def test_kmeans_init_is_seeded_on_the_cpu():
    a, b = tkm.init_indices(4096, 5, 7), tkm.init_indices(4096, 5, 7)
    assert torch.equal(a, b) and a.device.type == "cpu"
    assert len(set(a.tolist())) == 5


@pytest.mark.parametrize("size", [64, 96, 61])
def test_clahe_matches_jax(size):
    rng = np.random.default_rng(size)
    gray = (_leafish_image(rng, 96)[:size, :size].mean(-1)
            + rng.normal(0, 6, (size, size))).clip(0, 255).astype(np.float32)
    ours = tclahe.clahe(torch.from_numpy(gray)).numpy()
    ref = np.asarray(jclahe.clahe(jnp.asarray(gray)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("quality,min_distance,max_corners",
                         [(0.002, 2, 208), (0.005, 3, 16)])
def test_good_features_to_track_matches_jax(quality, min_distance,
                                            max_corners):
    rng = np.random.default_rng(min_distance)
    img = _leafish_image(rng, 96).astype(np.float32)
    gray = img.mean(-1) + rng.normal(0, 8, (96, 96)).astype(np.float32)
    mask = np.zeros((96, 96), bool)
    mask[10:86, 12:80] = True
    ys, xs, valid = tf.good_features_to_track(
        torch.from_numpy(gray), torch.from_numpy(mask),
        max_corners=max_corners, quality_level=quality,
        min_distance=min_distance)
    rys, rxs, rvalid = jf.good_features_to_track(
        jnp.asarray(gray), jnp.asarray(mask), max_corners=max_corners,
        quality_level=quality, min_distance=min_distance)
    ours = [(int(y), int(x)) for y, x, ok in zip(ys, xs, valid) if ok]
    ref = [(int(y), int(x)) for y, x, ok in zip(np.asarray(rys),
                                                np.asarray(rxs),
                                                np.asarray(rvalid)) if ok]
    assert len(ours) > 3
    assert ours == ref


@pytest.mark.parametrize("l2,hysteresis", [(False, False), (True, True)])
def test_canny_batch_equals_each_image(l2, hysteresis):
    rng = np.random.default_rng(3)
    grays = np.stack([_leafish_image(rng, 64).mean(-1) for _ in range(3)]
                     ).astype(np.float32)
    batch = tf.canny(torch.from_numpy(grays), 30, 90, l2=l2,
                     hysteresis=hysteresis)
    for i in range(3):
        one = tf.canny(torch.from_numpy(grays[i]), 30, 90, l2=l2,
                       hysteresis=hysteresis)
        assert torch.equal(batch[i], one)
        ref = jf.canny(jnp.asarray(grays[i]), 30, 90, l2=l2,
                       hysteresis=hysteresis)
        np.testing.assert_array_equal(one.numpy(), np.asarray(ref))
