"""Training augmentation K1 in the PyTorch port, held against the JAX package.

The port's plain twin (`ops/kernels/rotate.train_aug_plain`, what a CPU
tensor runs) against the Pallas kernels in interpret mode and against the
`rotate_warp` composition, with the flips, angles and factors injected (JAX's
threefry and torch's Philox never draw the same values). Tolerances are the
JAX suite's own for its Pallas-vs-XLA pairs: f32 out at atol 1e-4 and bf16
out at 1e-2 (`tests/test_pallas_rotate.py:129`, `:158`), the f32-in rotation
at 2e-5 (`:80`), the identity at 1e-6. The port's own draws are held by their
distributions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from leaffliction_tpu.ops.pallas.rotate import (  # noqa: E402
    rotate_batch_pallas_clamp_f32,
    train_aug_rotate_contrast_nhwc_pallas,
)
from leaffliction_tpu.ops.resample import rotate_warp  # noqa: E402
from leaffliction_tpu_torch.ops.kernels.rotate import train_aug  # noqa: E402
from leaffliction_tpu_torch.ops.train_augment import (  # noqa: E402
    apply_f32,
    apply_u8,
    draw_params,
    train_augment,
    train_augment_u8,
)

torch.set_num_threads(1)

ANGLES = np.array([-17.9, 0.0, 9.3, 17.5], np.float32)
FACTORS = np.array([0.92, 1.0, 1.07, 1.1], np.float32)
NO_FLIP = np.zeros(4, bool)


def _u8(h, w, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (4, h, w, 3),
                                                np.uint8)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
@pytest.mark.parametrize("out_dtype,atol", [("float32", 1e-4),
                                            ("bfloat16", 1e-2)])
def test_twin_matches_pallas_nhwc_kernel(hw, out_dtype, atol):
    imgs = _u8(*hw)
    ref = np.asarray(train_aug_rotate_contrast_nhwc_pallas(
        jnp.asarray(imgs), jnp.asarray(ANGLES), jnp.asarray(FACTORS),
        max_angle_deg=18.0, out_dtype=jnp.dtype(out_dtype), interpret=True),
        np.float32)
    got = apply_u8(_t(imgs), _t(NO_FLIP), _t(ANGLES), _t(FACTORS),
                   getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    assert got.shape == imgs.shape
    np.testing.assert_allclose(got.float().numpy(), ref, atol=atol)


@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
def test_u8_path_matches_rotate_warp_composition(hw):
    """flip on uint8 → /255 → clamp rotation → per-channel contrast, as the
    JAX package composes it off the TPU (`train_augment`)."""
    h, w = hw
    imgs = _u8(h, w, seed=4)
    flips = np.array([True, False, True, False])
    flipped = np.where(flips[:, None, None, None], imgs[:, :, ::-1], imgs)
    x = jnp.asarray(flipped).astype(jnp.float32) / 255.0
    rot = jax.vmap(lambda im, a: rotate_warp(im, a, (h, w), fill=None))(
        x, jnp.asarray(ANGLES))
    mean = jnp.mean(rot, axis=(1, 2), keepdims=True)
    ref = np.asarray(jnp.clip(
        mean + (rot - mean) * FACTORS[:, None, None, None], 0.0, 1.0))
    got = apply_u8(_t(imgs), _t(flips), _t(ANGLES), _t(FACTORS)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    # the f32-in entry composes the same function
    got32 = apply_f32(_t(imgs).float() / 255.0, _t(flips), _t(ANGLES),
                      _t(FACTORS)).numpy()
    np.testing.assert_allclose(got32, ref, atol=1e-4)


@pytest.mark.parametrize("hw", [(48, 64), (64, 64)])
def test_f32_rotation_matches_pallas_clamp_kernel(hw):
    imgs = np.random.default_rng(2).random((3,) + hw + (3,)).astype(
        np.float32)
    angles = np.array([-17.0, 0.0, 9.5], np.float32)
    ref = np.asarray(rotate_batch_pallas_clamp_f32(
        jnp.asarray(imgs), jnp.asarray(angles), interpret=True))
    got = train_aug(_t(imgs), _t(angles))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
    np.testing.assert_allclose(got[1].numpy(), imgs[1], atol=1e-6)


def test_zero_angle_unit_factor_is_dequant_identity():
    imgs = _u8(40, 56, seed=9)
    n = len(imgs)
    got = apply_u8(_t(imgs), _t(np.zeros(n, bool)), torch.zeros(n),
                   torch.ones(n)).numpy()
    np.testing.assert_allclose(got, imgs / np.float32(255.0), atol=1e-6)


def test_draws_follow_their_distributions():
    g = torch.Generator().manual_seed(0)
    flip, angles, factors = draw_params(20000, g, "cpu")
    assert angles.dtype == torch.float32 and factors.dtype == torch.float32
    assert float(angles.abs().max()) <= 18.0
    assert float(angles.min()) < -17.5 and float(angles.max()) > 17.5
    assert abs(float(angles.mean())) < 0.5          # U(±18°): sd 10.4/√n
    assert 0.9 <= float(factors.min()) and float(factors.max()) <= 1.1
    assert abs(float(factors.mean()) - 1.0) < 2e-3  # sd 0.058/√n
    assert abs(float(flip.float().mean()) - 0.5) < 0.02
    again = draw_params(20000, torch.Generator().manual_seed(0), "cpu")
    for a, b in zip((flip, angles, factors), again):
        assert torch.equal(a, b)


def test_drawing_entries_are_seeded_and_bounded():
    imgs = _t(_u8(32, 32, seed=5))
    a = train_augment_u8(torch.Generator().manual_seed(3), imgs)
    b = train_augment_u8(torch.Generator().manual_seed(3), imgs)
    c = train_augment_u8(torch.Generator().manual_seed(4), imgs)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.float32 and a.shape == imgs.shape
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    bf = train_augment_u8(torch.Generator().manual_seed(3), imgs,
                          out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    f = train_augment(torch.Generator().manual_seed(3), imgs.float() / 255.0)
    np.testing.assert_allclose(f.numpy(), a.numpy(), atol=1e-6)


def test_wrapper_refuses_devices_without_a_kernel():
    x = torch.zeros((1, 8, 8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        train_aug(x, torch.zeros(1, device="meta"),
                  torch.ones(1, device="meta"))
