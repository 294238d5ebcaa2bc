"""Canny front end in the PyTorch port, held against the JAX package.

K5's plain twin against `ops/filters._edge_nms_jnp` (the CPU answer, cv2
borders) over the whole image at atol 1e-3, and against the Pallas kernel in
interpret mode on the interior (it pads with zeros; margin 4, 1e-3, as
`tests/test_pallas_edge.py`). Canny with and without hysteresis: exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from leaffliction_tpu.ops import filters as jf  # noqa: E402
from leaffliction_tpu.ops.pallas.edge import edge_nms_batch  # noqa: E402
from leaffliction_tpu_torch.ops import filters as tf  # noqa: E402
from leaffliction_tpu_torch.ops.kernels.edge import (  # noqa: E402
    edge_nms,
    edge_nms_plain,
)

torch.set_num_threads(1)


def _gray(seed, h=64, w=64):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return ((xx * 3 + yy * 2) % 200 + rng.normal(0, 5, (h, w))
            ).astype(np.float32)


@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_twin_matches_jnp_and_pallas(seed, l2):
    gray = _gray(seed, 48, 64)
    ours = edge_nms_plain(torch.from_numpy(gray)[None], l2)[0].numpy()
    ref = np.asarray(jf._edge_nms_jnp(jnp.asarray(gray), l2))
    assert np.abs(ours - ref).max() <= 1e-3  # whole image, cv2 borders
    pallas = np.asarray(edge_nms_batch(jnp.asarray(gray)[None], l2=l2,
                                       interpret=True)[0])
    m = 4  # the Pallas kernel zero-pads; its interior is the same
    assert np.abs(ours[m:-m, m:-m] - pallas[m:-m, m:-m]).max() <= 1e-3


@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("h,w", [(3, 3), (5, 7), (225, 223)])
def test_twin_matches_jnp_at_border_heavy_shapes(h, w, l2):
    """The shapes where the card's tiles are mostly border: the smallest
    legal image, an odd one, and 225×223 (partial 32-pixel tiles). Each
    pins reflect-101 taps at the reflected position and NMS neighbours that
    wrap, which the kernel's border tiles reproduce (atol 1e-3: JAX sums in
    its own order; the twin differs from it by at most 2.7e-4 here)."""
    gray = _gray(5, h, w)
    ours = edge_nms_plain(torch.from_numpy(gray)[None], l2)[0].numpy()
    ref = np.asarray(jf._edge_nms_jnp(jnp.asarray(gray), l2))
    assert np.abs(ours - ref).max() <= 1e-3


def test_wrapper_takes_twin_on_cpu():
    gray = torch.from_numpy(np.stack([_gray(2), _gray(3)]))
    before = edge_nms.launches
    out = edge_nms(gray)
    assert edge_nms.launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(out, edge_nms_plain(gray), rtol=0, atol=0)


@pytest.mark.parametrize("hysteresis", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_canny_matches_jax(seed, hysteresis):
    gray = _gray(seed)
    for low, high in ((30, 100), (50, 150)):
        ours = tf.canny(torch.from_numpy(gray), low, high,
                        hysteresis=hysteresis).numpy()
        ref = np.asarray(jf.canny(jnp.asarray(gray), low, high,
                                  hysteresis=hysteresis))
        np.testing.assert_array_equal(ours, ref)


def test_hysteresis_serpentine_and_cap_match_jax():
    h = w = 24
    weak = np.zeros((h, w), bool)
    for y in range(0, h, 2):  # boustrophedon chain far longer than h + w
        weak[y, :] = True
        if y + 2 < h:
            weak[y + 1, w - 1 if (y // 2) % 2 == 0 else 0] = True
    strong = np.zeros_like(weak)
    strong[0, 0] = True
    for iters in (0, 5):
        ours = tf.hysteresis_flood(torch.from_numpy(strong),
                                   torch.from_numpy(weak), iters).numpy()
        ref = np.asarray(jf.hysteresis_flood(jnp.asarray(strong),
                                             jnp.asarray(weak), iters))
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("ksize,sigma", [(5, 1.4), (15, 0.0)])
def test_blur_sobel_normalize_match_jax(ksize, sigma):
    gray = _gray(4, 40, 56)
    t, j = torch.from_numpy(gray), jnp.asarray(gray)
    np.testing.assert_allclose(tf.gaussian_blur(t, ksize, sigma).numpy(),
                               np.asarray(jf.gaussian_blur(j, ksize, sigma)),
                               rtol=0, atol=1e-3)
    for ours, ref in zip(tf.sobel_xy(t), jf.sobel_xy(j)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   rtol=0, atol=1e-3)
    np.testing.assert_allclose(tf.normalize_minmax(t, 0.0, 1.0).numpy(),
                               np.asarray(jf.normalize_minmax(j, 0.0, 1.0)),
                               rtol=0, atol=1e-6)

