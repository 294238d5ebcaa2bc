"""The port's six balancing ops and autocontrast against the JAX package on
the CPU, with JAX's drawn values handed to the port (threefry is not
reproduced, so seeds are never compared).

Bars, per op, on uint8 outputs: flip exact; rotate (the K2 twin against the
einsum `rotate_warp` that JAX runs on the CPU) max ≤ 2 with > 1 on under
0.2% (`tests/test_pallas_rotate.py`); skew, shear (the K3 twin against the
matmul `shear_warp`) and crop ≤ 1 LSB (the same weights summed in another
order; `tests/test_bicubic_parity.py` holds the Pallas shear to the same);
distortion ≤ 1 LSB on under 0.1% of pixels (the remap `x·scale + offset`
may round once more or once less under XLA); the strict wrap mode exact.
`rotate_canvas_hw`, `pil_expanded_size`, the parameter bounds and the
strict noise table equal JAX's; the port's own draws stay in bounds and
follow their generators.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jax_draws import jax_params  # noqa: E402
from leaffliction_tpu.ops import augment as ja  # noqa: E402
from leaffliction_tpu.ops import photometric as jp  # noqa: E402
from leaffliction_tpu_torch.ops import augment as ta  # noqa: E402
from leaffliction_tpu_torch.ops import photometric as tp  # noqa: E402

torch.set_num_threads(1)

H = W = 48


@pytest.fixture(scope="module")
def imgs():
    from conftest import _leafish_image

    rng = np.random.default_rng(21)
    return np.stack([_leafish_image(rng, H) for _ in range(4)])


@pytest.fixture(scope="module")
def keys():
    return jax.random.split(jax.random.key(5), 4)


def _diff(a, b):
    return np.abs(np.asarray(a).astype(np.int64)
                  - np.asarray(b).astype(np.int64))


def _run_both(transform, imgs, keys, **extra):
    params = jax_params(transform, keys, (H, W), **extra)
    got = ta.BATCH_KERNELS[transform](torch.from_numpy(imgs), **params)
    return got.numpy(), params


def test_flip_exact(imgs, keys):
    got, _ = _run_both("flip", imgs, keys)
    np.testing.assert_array_equal(
        got, np.asarray(ja.flip_batch(keys, jnp.asarray(imgs))))


def test_rotate_canvas_within_bar(imgs, keys):
    got, params = _run_both("rotate", imgs, keys)
    ref, angles = ja.rotate_batch(keys, jnp.asarray(imgs))
    np.testing.assert_array_equal(params["angles"].numpy(),
                                  np.asarray(angles))
    assert got.shape == ref.shape == (4, *ta.rotate_canvas_hw(H, W), 3)
    d = _diff(got, ref)
    assert d.max() <= 2 and (d > 1).mean() < 0.002


@pytest.mark.parametrize("transform", ["skew", "shear", "crop"])
def test_resampling_ops_within_one_lsb(imgs, keys, transform):
    got, _ = _run_both(transform, imgs, keys)
    ref = np.asarray(ja.BATCH_KERNELS[transform](keys, jnp.asarray(imgs)))
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert _diff(got, ref).max() <= 1


def test_shear_draws_cover_both_directions(keys):
    horiz = jax_params("shear", jax.random.split(jax.random.key(1), 16),
                       (H, W))["horizontal"]
    assert 0 < int(horiz.sum()) < 16


def test_distortion_within_one_lsb(imgs, keys):
    got, _ = _run_both("distortion", imgs, keys)
    ref = np.asarray(ja.distortion_batch(keys, jnp.asarray(imgs)))
    d = _diff(got, ref)
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


def test_strict_distortion_exact(imgs, keys):
    got, params = _run_both("distortion", imgs, keys, strict=True)
    ref = np.asarray(ja.distortion_batch_wrap(keys, jnp.asarray(imgs)))
    np.testing.assert_array_equal(got, ref)


def test_wrap_noise_u8_exact():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (2, 16, 16, 3), np.uint8)
    noise = rng.normal(0, 40, img.shape).astype(np.float32)
    np.testing.assert_array_equal(
        ta.wrap_noise_u8(torch.from_numpy(img), torch.from_numpy(noise)),
        np.asarray(ja.wrap_noise_u8(jnp.asarray(img), jnp.asarray(noise))))


@pytest.mark.parametrize("cutoff", [0.0, 0.7, 2.0])
def test_autocontrast_matches_jax(cutoff):
    rng = np.random.default_rng(4)
    x = np.clip(rng.normal(120, 25, (3, 24, 20, 3)), 0, 255).astype(
        np.float32)
    x[1, ..., 2] = 77.0                       # a flat channel stays as is
    cut = np.array([cutoff, cutoff / 2, 1.3], np.float32)
    got = tp.autocontrast(torch.from_numpy(x), torch.from_numpy(cut))
    ref = np.stack([np.asarray(jp.autocontrast(jnp.asarray(a), c))
                    for a, c in zip(x, cut)])
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    got_u8 = tp.autocontrast_u8_exact(
        torch.from_numpy(x.astype(np.uint8)), torch.from_numpy(cut))
    ref_u8 = np.stack([np.asarray(jp.autocontrast_u8_exact(
        jnp.asarray(a.astype(np.uint8)), c)) for a, c in zip(x, cut)])
    np.testing.assert_array_equal(got_u8.numpy(), ref_u8)


def _planes(kind):
    """uint8 [1, 20, 20, 3] planes built for one edge of the cutoff count,
    and a cutoff percentage (400 pixels, so cut = 4·cutoff)."""
    rng = np.random.default_rng(6)
    img = rng.integers(10, 246, (1, 20, 20, 3)).astype(np.uint8)
    flat = img.reshape(400, 3)
    if kind == "tie_low_high":      # cut = 4 = count(q <= 0) = count(q >= 255)
        flat[:4] = 0
        flat[-4:] = 255
        return img, 1.0
    if kind == "tie_inner":         # cut = 10 = count(q <= 3)
        flat[:4] = 0
        flat[4:10] = 3
        return img, 2.5
    if kind == "cutoff_zero":
        return img, 0.0
    if kind == "constant":
        img[:] = 77
        return img, 1.0
    if kind == "constant_zero_cutoff":
        img[:] = 200
        return img, 0.0
    if kind == "two_valued":
        flat[:] = 50
        flat[200:] = 200
        return img, 1.0
    if kind == "two_valued_near_half":   # cut = 196 of 200 at each value
        flat[:] = 50
        flat[200:] = 200
        return img, 49.0
    if kind == "two_valued_at_half":     # cut = 200 = count(q <= 50)
        flat[:] = 50
        flat[200:] = 200
        return img, 50.0
    raise ValueError(kind)


@pytest.mark.parametrize("kind", [
    "tie_low_high", "tie_inner", "cutoff_zero", "constant",
    "constant_zero_cutoff", "two_valued", "two_valued_near_half",
    "two_valued_at_half"])
def test_cutoff_count_equals_jax_search(kind):
    """The cutoff bins as a count (`cutoff_bins`, which kernel K6 computes
    with a warp per channel) against JAX's 8-step binary search, where a
    cut meets a cumulative count exactly and on degenerate planes: the
    integer remap exact, the float one within 1e-4."""
    img, cutoff = _planes(kind)
    cut = np.array([cutoff], np.float32)
    got_u8 = tp.autocontrast_u8_exact(torch.from_numpy(img),
                                      torch.from_numpy(cut))
    ref_u8 = np.asarray(jp.autocontrast_u8_exact(jnp.asarray(img[0]),
                                                 cut[0]))
    np.testing.assert_array_equal(got_u8.numpy()[0], ref_u8)
    x = img.astype(np.float32) + np.float32(0.25)   # rounds to the same bins
    got = tp.autocontrast(torch.from_numpy(x), torch.from_numpy(cut))
    ref = np.asarray(jp.autocontrast(jnp.asarray(x[0]), cut[0]))
    np.testing.assert_allclose(got.numpy()[0], ref, atol=1e-4)


def test_canvas_and_expanded_size_equal_jax():
    for h in (16, 48, 97, 224, 256):
        for w in (16, 40, 224, 400):
            assert ta.rotate_canvas_hw(h, w) == ja.rotate_canvas_hw(h, w)
            for a in (-30.0, -17.25, -0.4, 0.0, 3.3, 29.99, 30.0, 181.0):
                assert ta.pil_expanded_size(a, w, h) == \
                    ja.pil_expanded_size(a, w, h)


def test_bounds_and_strict_table_equal_jax():
    for name in ("MAX_ROTATE_DEG", "SKEW_RANGE", "SHEAR_MAX",
                 "CROP_RATIO_RANGE", "CUTOFF_MAX", "NOISE_STD"):
        assert getattr(ta, name) == getattr(ja, name), name
    assert 1 << ta.STRICT_NOISE_BITS == 1 << ja._STRICT_NOISE_BITS
    np.testing.assert_array_equal(ta.strict_noise_table(),
                                  np.asarray(ja._get_strict_noise_table()))
    p = np.linspace(1e-6, 1 - 1e-6, 1001)
    np.testing.assert_array_equal(ta._acklam_ndtri(p), ja._acklam_ndtri(p))
    assert set(ta.BATCH_KERNELS) == set(ta.DRAWS) == set(ja.BATCH_KERNELS)


def _rngs(n, seed=0):
    return [np.random.default_rng([seed, i]) for i in range(n)]


def test_own_draws_in_bounds_and_reproducible(monkeypatch):
    monkeypatch.delenv("LEAF_STRICT_DISTORTION", raising=False)
    monkeypatch.delenv("LEAF_PALLAS_DISTORT", raising=False)
    n = 64
    a = ta.draw_rotate(_rngs(n), (H, W), "cpu")["angles"]
    assert a.abs().max() <= 30.0 and a.std() > 5.0
    s = ta.draw_skew(_rngs(n), (H, W), "cpu")["s"]
    assert s.min() >= 0.05 and s.max() <= 0.15
    sh = ta.draw_shear(_rngs(n), (H, W), "cpu")
    assert sh["s"].abs().max() <= 0.2 and 0 < sh["horizontal"].sum() < n
    crop = ta.draw_crop(_rngs(n), (H, W), "cpu")
    assert crop["ratio"].min() >= 0.8 and crop["ratio"].max() <= 0.95
    new = torch.floor(W * crop["ratio"])
    assert (crop["left"] >= 0).all() and (crop["left"] <= W - new).all()
    dist = ta.draw_distortion(_rngs(n), (H, W), "cpu")
    assert set(dist) == {"cutoffs", "noise"}
    assert dist["cutoffs"].min() >= 0 and dist["cutoffs"].max() <= 2.0
    assert abs(float(dist["noise"].mean())) < 0.02
    assert abs(float(dist["noise"].std()) - 1.0) < 0.02
    again = ta.draw_distortion(_rngs(n), (H, W), "cpu")
    assert torch.equal(again["noise"], dist["noise"])
    other = ta.draw_distortion(_rngs(n, seed=1), (H, W), "cpu")
    assert not torch.equal(other["noise"], dist["noise"])


@pytest.mark.parametrize("env,keys_", [
    ("LEAF_STRICT_DISTORTION", {"cutoffs", "noise", "strict"}),
    ("LEAF_PALLAS_DISTORT", {"cutoffs", "seeds"}),
])
def test_distortion_modes_follow_their_switch(monkeypatch, imgs, env, keys_):
    monkeypatch.delenv("LEAF_STRICT_DISTORTION", raising=False)
    monkeypatch.delenv("LEAF_PALLAS_DISTORT", raising=False)
    monkeypatch.setenv(env, "1")
    params = ta.draw_distortion(_rngs(4), (H, W), "cpu")
    assert set(params) == keys_
    out = ta.distortion_batch(torch.from_numpy(imgs), **params)
    assert out.shape == imgs.shape and out.dtype == torch.uint8
    if env == "LEAF_STRICT_DISTORTION":
        table = set(ta.strict_noise_table().tolist())
        assert set(params["noise"].unique().tolist()) <= table
    else:
        assert ((params["seeds"] >= 0) & (params["seeds"] < 2 ** 32)).all()


def test_strict_noise_keeps_its_cpu_bytes(monkeypatch):
    """The strict indices are drawn as int16 on CPU generators: the noise is
    the table at the values an int64 `torch.randint` on the same generators
    gives, as it was when the indices were drawn on the target device."""
    monkeypatch.setenv("LEAF_STRICT_DISTORTION", "1")
    got = ta.draw_distortion(_rngs(3), (H, W + 8), "cpu")
    table = torch.from_numpy(ta.strict_noise_table())
    idx = []
    for r in _rngs(3):
        r.uniform(0.0, ta.CUTOFF_MAX)
        g = torch.Generator()
        g.manual_seed(int(r.integers(0, 2 ** 63 - 1)))
        idx.append(torch.randint(0, 2048, (H, W + 8, 3), generator=g))
    assert torch.equal(got["noise"], table[torch.stack(idx)])
    assert ta.strict_noise_indices(_rngs(3), (H, W)).dtype == torch.int16
