"""The port's balancing warps against the JAX package on the CPU.

K2's twin (`ops/kernels/warp.rotate_expand_plain`) against the Pallas
kernels `rotate_batch_pallas_nhwc` and `rotate_batch_pallas` (interpret
mode): the same three white-fill shear passes and sign-exact bounds, so
max |Δ| ≤ 1 is the bar (equal in practice); against the einsum `rotate_warp`,
the JAX suite's own bar for its Pallas kernels (max ≤ 2, > 1 on under 0.2%).
K3's twin against `shear_batch_pallas` (interpret): exact is the aim, ≤ 1
LSB the limit; against `shear_warp(..., "bicubic", half_px=True)`: ≤ 1 LSB
(`tests/test_bicubic_parity.py`). The port's `ops/resample.py` against the
JAX functions: f32 at 5e-3 of a grey level (same weights, another
summation order). The wrappers take CPU tensors to the twins and refuse
other devices.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from leaffliction_tpu.ops import resample as jr  # noqa: E402
from leaffliction_tpu.ops.augment import rotate_canvas_hw  # noqa: E402
from leaffliction_tpu.ops.pallas.rotate import (  # noqa: E402
    rotate_batch_pallas,
    rotate_batch_pallas_nhwc,
    shear_batch_pallas,
)
from leaffliction_tpu_torch.ops import resample as tr  # noqa: E402
from leaffliction_tpu_torch.ops.kernels.warp import (  # noqa: E402
    rotate_expand,
    rotate_expand_plain,
    shear_cubic,
    shear_cubic_plain,
)

torch.set_num_threads(1)

ANGLES = np.array([-29.5, 0.0, 17.3, 30.0], np.float32)


def _diff(a, b):
    return np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(
        np.int64))


@pytest.fixture(scope="module")
def gradient96():
    """The bicubic parity fixture: a noisy 96² gradient."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:96, 0:96].astype(np.float32)
    base = np.stack([xx * 4 % 255, yy * 3 % 251, (xx + yy) * 2 % 253], -1)
    return (base + rng.normal(0, 6, base.shape)).clip(0, 255).astype(
        np.uint8)


@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
def test_rotate_expand_twin_matches_pallas_and_einsum(hw):
    h, w = hw
    imgs = np.random.default_rng(4).integers(0, 256, (4, h, w, 3), np.uint8)
    canvas = rotate_canvas_hw(h, w)
    got = rotate_expand_plain(torch.from_numpy(imgs),
                              torch.from_numpy(ANGLES), canvas).numpy()
    assert got.shape == (4, *canvas, 3) and got.dtype == np.uint8
    for fn in (rotate_batch_pallas_nhwc, rotate_batch_pallas):
        ref = np.asarray(fn(jnp.asarray(imgs), jnp.asarray(ANGLES), canvas,
                            fill=255.0, max_angle_deg=30.0, interpret=True))
        assert _diff(got, ref).max() <= 1, fn.__name__
    ein = np.stack([np.clip(np.round(np.asarray(jr.rotate_warp(
        jnp.asarray(im, jnp.float32), a, canvas, fill=255.0))), 0, 255)
        for im, a in zip(imgs, ANGLES)])
    d = _diff(got, ein)
    assert d.max() <= 2 and (d > 1).mean() < 0.002


def test_rotate_expand_zero_angle_is_identity_on_white():
    h = w = 32
    imgs = np.random.default_rng(1).integers(0, 256, (2, h, w, 3), np.uint8)
    canvas = rotate_canvas_hw(h, w)
    out = rotate_expand(torch.from_numpy(imgs), torch.zeros(2),
                        canvas).numpy()
    oh, ow = canvas
    y0, x0 = (oh - h) // 2, (ow - w) // 2
    np.testing.assert_array_equal(out[:, y0:y0 + h, x0:x0 + w], imgs)
    border = np.ones((oh, ow), bool)
    border[y0:y0 + h, x0:x0 + w] = False
    assert (out[:, border] == 255).all()


@pytest.mark.parametrize("s", [0.18, -0.12])
@pytest.mark.parametrize("horizontal", [True, False])
def test_shear_cubic_twin_matches_pallas_and_matmul(gradient96, s,
                                                    horizontal):
    img = gradient96
    got = shear_cubic_plain(torch.from_numpy(img)[None], torch.tensor([s]),
                            torch.tensor([horizontal]))[0].numpy()
    ref = np.asarray(shear_batch_pallas(
        jnp.asarray(img)[None], jnp.array([s], jnp.float32),
        jnp.array([horizontal]), fill=0.0, interpret=True))[0]
    d = _diff(got, ref)
    assert d.max() <= 1 and (d > 0).mean() < 1e-3
    matmul = np.clip(np.round(np.asarray(jr.shear_warp(
        jnp.asarray(img), s, horizontal, (96, 96), fill=0.0,
        kernel="bicubic", half_px=True))), 0, 255)
    assert _diff(got, matmul).max() <= 1


def test_shear_cubic_band_is_closed_at_size_minus_half(gradient96):
    """With s = 1 a horizontal shear puts row y's pixel x = w − 1 − y
    exactly on x_src = w − 0.5. The port keeps it, as the Pallas kernel
    does (its band test is `<= size`); the matmul `shear_warp` fills it
    (`resample._in_bounds` is half-open there)."""
    img = gradient96
    h, w = img.shape[:2]
    got = shear_cubic_plain(torch.from_numpy(img)[None], torch.tensor([1.0]),
                            torch.tensor([True]))[0].numpy()
    ref = np.asarray(shear_batch_pallas(
        jnp.asarray(img)[None], jnp.array([1.0], jnp.float32),
        jnp.array([True]), fill=0.0, interpret=True))[0]
    matmul = np.clip(np.round(np.asarray(jr.shear_warp(
        jnp.asarray(img), 1.0, True, (h, w), fill=0.0, kernel="bicubic",
        half_px=True))), 0, 255)
    ys = np.arange(h)
    edge = (ys, w - 1 - ys)
    assert (got[edge] == ref[edge]).all()
    assert got[edge].max() > 0            # kept: a renormalised sample
    assert (matmul[edge] == 0).all()      # the half-open band fills it
    past = (ys[1:], w - ys[1:])           # x_src = w + 0.5: outside both
    assert (got[past] == 0).all()
    assert _diff(got, ref).max() <= 1


def test_wrappers_refuse_other_devices():
    meta = torch.empty((1, 8, 8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        rotate_expand(meta, torch.zeros(1), (12, 12))
    with pytest.raises(ValueError, match="no kernel"):
        shear_cubic(meta, torch.zeros(1), torch.ones(1, dtype=torch.bool))


def test_cpu_calls_are_not_counted_as_launches():
    imgs = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    before = (rotate_expand.launches, shear_cubic.launches)
    rotate_expand(imgs, torch.zeros(1), (12, 12))
    shear_cubic(imgs, torch.zeros(1), torch.ones(1, dtype=torch.bool))
    assert (rotate_expand.launches, shear_cubic.launches) == before


def _imgs(n, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                np.uint8)


@pytest.mark.parametrize("kernel", ["bilinear", "bicubic", "lanczos3"])
@pytest.mark.parametrize("fill", [0.0, None])
def test_scale_translate_warp_matches_jax(kernel, fill):
    imgs = _imgs(3, 40, 56, 7)
    scale = np.array([[1.1, 1.07], [0.85, 0.9], [1.3, 0.7]], np.float32)
    offset = np.array([[-3.2, -1.5], [4.4, 2.25], [-9.0, 6.5]], np.float32)
    got = tr.scale_translate_warp(torch.from_numpy(imgs),
                                  torch.from_numpy(scale),
                                  torch.from_numpy(offset), (36, 60),
                                  fill=fill, kernel=kernel).numpy()
    ref = np.stack([np.asarray(jr.scale_translate_warp(
        jnp.asarray(im), jnp.asarray(s), jnp.asarray(o), (36, 60),
        fill=fill, kernel=kernel)) for im, s, o in zip(imgs, scale, offset)])
    np.testing.assert_allclose(got, ref, atol=5e-3)


@pytest.mark.parametrize("kernel", ["bilinear", "bicubic"])
def test_shear_warp_matches_jax(kernel):
    imgs = _imgs(2, 32, 40, 8)
    shears = np.array([0.17, -0.13], np.float32)
    horiz = np.array([True, False])
    got = tr.shear_warp(torch.from_numpy(imgs), torch.from_numpy(shears),
                        torch.from_numpy(horiz), (32, 40), fill=0.0,
                        kernel=kernel, half_px=True).numpy()
    ref = np.stack([np.asarray(jr.shear_warp(
        jnp.asarray(im), s, bool(hz), (32, 40), fill=0.0, kernel=kernel,
        half_px=True)) for im, s, hz in zip(imgs, shears, horiz)])
    np.testing.assert_allclose(got, ref, atol=5e-3)


@pytest.mark.parametrize("fill", [255.0, None])
def test_rotate_warp_matches_jax(fill):
    imgs = _imgs(2, 32, 40, 9)
    angles = np.array([-21.5, 13.0], np.float32)
    canvas = rotate_canvas_hw(32, 40)
    got = tr.rotate_warp(torch.from_numpy(imgs), torch.from_numpy(angles),
                         canvas, fill=fill).numpy()
    ref = np.stack([np.asarray(jr.rotate_warp(
        jnp.asarray(im, jnp.float32), a, canvas, fill=fill))
        for im, a in zip(imgs, angles)])
    np.testing.assert_allclose(got, ref, atol=5e-3)
