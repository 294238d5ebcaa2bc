"""K6's plain twin (`ops/kernels/distortion.py`) on the CPU.

The Pallas kernel draws from the TPU's per-core PRNG, which has no CPU
interpret lowering (`tests/test_pallas_distortion.py`), and the port draws
from Philox4x32-10 instead. So the noise is held by its construction and
its moments (Random123's known-answer vectors; mean 0, variance 1, support
within ±6), and the rest exactly: given the twin's own noise, its output
equals the JAX `autocontrast(clip(x + 5·noise))` rounded to uint8 (≤ 1 LSB
on under 0.1% of pixels is the limit, for an XLA rounding of the remap).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from leaffliction_tpu.ops.photometric import autocontrast  # noqa: E402
from leaffliction_tpu_torch.ops.kernels.distortion import (  # noqa: E402
    _mulhilo,
    distortion,
    distortion_plain,
    irwin_hall_noise,
    philox4x32_10,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("ctr,key,expect", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, expect):
    t = [torch.tensor([v], dtype=torch.int64) for v in (*ctr, *key)]
    assert tuple(int(o) for o in philox4x32_10(*t)) == expect


def test_mulhilo_limbs_match_python_ints():
    b = torch.from_numpy(np.random.default_rng(0).integers(
        0, 2 ** 32, 2000, dtype=np.int64))
    b[:2] = torch.tensor([0, 2 ** 32 - 1])
    for a in (0xD2511F53, 0xCD9E8D57):
        hi, lo = _mulhilo(a, b)
        full = [a * int(v) for v in b]
        assert hi.tolist() == [p >> 32 for p in full]
        assert lo.tolist() == [p & 0xFFFFFFFF for p in full]


def test_noise_moments():
    seeds = torch.from_numpy(np.random.default_rng(1).integers(
        0, 2 ** 32, (6, 3), dtype=np.int64))
    noise = irwin_hall_noise(seeds, 64, 64)
    assert noise.shape == (6, 64, 64, 3) and noise.dtype == torch.float32
    assert abs(float(noise.mean())) < 0.01
    assert abs(float(noise.var()) - 1.0) < 0.02
    assert float(noise.abs().max()) <= 6.0
    # planes are independent streams
    flat = noise.permute(0, 3, 1, 2).reshape(18, -1)
    corr = torch.corrcoef(flat)
    assert float((corr - torch.eye(18)).abs().max()) < 0.06


def test_twin_equals_jax_autocontrast_given_its_noise():
    from conftest import _leafish_image

    rng = np.random.default_rng(2)
    imgs = np.stack([_leafish_image(rng, 56) for _ in range(3)])
    seeds = torch.from_numpy(rng.integers(0, 2 ** 32, (3, 3),
                                          dtype=np.int64))
    cutoffs = np.array([0.0, 0.9, 2.0], np.float32)
    got = distortion_plain(torch.from_numpy(imgs), seeds,
                           torch.from_numpy(cutoffs)).numpy()
    noise = irwin_hall_noise(seeds, 56, 56).numpy()
    ref = []
    for img, n, c in zip(imgs, noise, cutoffs):
        x = jnp.clip(jnp.asarray(img, jnp.float32) + 5.0 * jnp.asarray(n),
                     0.0, 255.0)
        ref.append(np.clip(np.round(np.asarray(autocontrast(x, c))), 0, 255))
    d = np.abs(got.astype(np.int64) - np.stack(ref).astype(np.int64))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3
    # the op: noise present, structure kept, stretched to the full range
    src = imgs.astype(np.float32)
    assert np.abs(got - src).mean() > 1.0
    assert np.corrcoef(got.ravel(), src.ravel())[0, 1] > 0.8
    assert got.max() >= 250 and got.min() <= 5


def test_twin_is_deterministic_per_seed():
    imgs = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 16, 16, 3), dtype=np.uint8))
    seeds = torch.tensor([[1, 2, 3], [4, 5, 6]])
    cut = torch.tensor([0.5, 1.5])
    a = distortion(imgs, seeds, cut)
    assert torch.equal(a, distortion(imgs, seeds, cut))
    assert not torch.equal(a, distortion(imgs, seeds + 7, cut))


def test_wrapper_refuses_other_devices_and_counts_no_cpu_call():
    before = distortion.launches
    distortion(torch.zeros((1, 8, 8, 3), dtype=torch.uint8),
               torch.zeros((1, 3), dtype=torch.int64), torch.zeros(1))
    assert distortion.launches == before
    meta = torch.empty((1, 8, 8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        distortion(meta, torch.zeros((1, 3), dtype=torch.int64),
                   torch.zeros(1))
