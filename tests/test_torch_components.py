"""Connected components in the PyTorch port, held against the JAX package.

K4 (propagation to the fixpoint) is integer-only, so every comparison is
exact: its round against the Pallas kernel in interpret mode and against the
XLA round, round by round; its plain twin (the host loop over that round)
against the JAX convergence loop, labels and round counts, with and without
a binding round cap; and the component functions built on it against their
JAX counterparts.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from leaffliction_tpu.ops import components as jcc  # noqa: E402
from leaffliction_tpu.ops.morphology import fill_holes as j_fill_holes  # noqa: E402
from leaffliction_tpu.ops.pallas.components import (  # noqa: E402
    propagate_round_pallas,
)
from leaffliction_tpu_torch.ops import components as tcc  # noqa: E402
from leaffliction_tpu_torch.ops.kernels.components import (  # noqa: E402
    cc_propagate,
    cc_propagate_plain,
    cc_round_plain,
)
from leaffliction_tpu_torch.ops.morphology import fill_holes  # noqa: E402

torch.set_num_threads(1)

DENSITIES = [(0, 0.5), (1, 0.2), (2, 0.8)]


def _xla_round(lab, mask, segs, label_bits):
    """The XLA round in the Pallas kernel's phase order (rows, then columns),
    as `tests/test_pallas_cc.py` states it."""
    low = (1 << label_bits) - 1
    grown = jax.lax.reduce_window(
        lab, jnp.int32(0), jax.lax.max, (3, 3), (1, 1), [(1, 1), (1, 1)])
    lab = jnp.where(mask, grown, 0)
    fwd = jax.lax.cummax(segs[2] | lab, axis=1) & low
    bwd = jax.lax.cummax(segs[3] | lab, axis=1, reverse=True) & low
    lab = jnp.where(mask, jnp.maximum(fwd, bwd), 0)
    fwd = jax.lax.cummax(segs[0] | lab, axis=0) & low
    bwd = jax.lax.cummax(segs[1] | lab, axis=0, reverse=True) & low
    return jnp.where(mask, jnp.maximum(fwd, bwd), 0)


def _jax_inputs(mask_np):
    h, w = mask_np.shape
    mask = jnp.asarray(mask_np)
    label_bits = (h * w + 1).bit_length()
    flat = jnp.arange(1, h * w + 1, dtype=jnp.int32).reshape(h, w)
    lab = jnp.where(mask, flat, 0)
    bar = (~mask).astype(jnp.int32)
    segs = [
        jnp.cumsum(bar, axis=0) << label_bits,
        jnp.cumsum(bar[::-1, :], axis=0)[::-1, :] << label_bits,
        jnp.cumsum(bar, axis=1) << label_bits,
        jnp.cumsum(bar[:, ::-1], axis=1)[:, ::-1] << label_bits,
    ]
    return lab, mask, segs, label_bits


@pytest.mark.parametrize("seed,density", DENSITIES)
def test_round_twin_matches_pallas_and_xla(seed, density):
    """Exact, round by round, for 3 rounds at 48x64."""
    rng = np.random.default_rng(seed)
    mask_np = rng.random((48, 64)) < density
    lab, mask, segs, label_bits = _jax_inputs(mask_np)
    t_mask = torch.from_numpy(mask_np)
    t_segs = [torch.from_numpy(np.array(s)) for s in segs]
    ref_xla = ref_pallas = lab
    got = torch.from_numpy(np.array(lab))
    for _ in range(3):
        ref_xla = _xla_round(ref_xla, mask, segs, label_bits)
        ref_pallas = propagate_round_pallas(
            ref_pallas, mask, segs[0], segs[1], segs[2], segs[3], label_bits,
            interpret=True)
        got = cc_round_plain(got, t_mask, *t_segs, label_bits)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref_xla))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref_pallas))


def _serpentine(h, w):
    """Full rows joined at alternating ends: one long winding component."""
    m = np.zeros((h, w), bool)
    m[::2] = True
    for r in range(1, h, 2):
        m[r, w - 1 if (r // 2) % 2 == 0 else 0] = True
    return m


def _jax_loop(mask_np, limit):
    """JAX's convergence loop (`_propagate`'s while_loop) stepped on the host
    over the Pallas round in interpret mode → (labels, rounds run)."""
    lab, mask, segs, label_bits = _jax_inputs(mask_np)

    def step(x):
        return propagate_round_pallas(x, mask, segs[0], segs[1], segs[2],
                                      segs[3], label_bits, interpret=True)

    prev, cur, i = lab, step(lab), 0
    while i < limit and bool(jnp.any(prev != cur)):
        prev, cur, i = cur, step(cur), i + 1
    return np.asarray(cur), 1 + i


PROPAGATE_CASES = [("random", seed, density, None)
                   for seed, density in DENSITIES] + [
    ("serpentine", 0, None, None), ("serpentine", 0, None, 2)]


@pytest.mark.parametrize("kind,seed,density,cap", PROPAGATE_CASES)
def test_propagate_twin_matches_jax_loop(kind, seed, density, cap,
                                         monkeypatch):
    """Labels and round count exact against the JAX loop, and the labels
    against `_propagate` itself (Pallas rounds, as on the TPU); `cap` makes
    the round limit bind (3 rounds where the fixpoint needs more)."""
    if kind == "random":
        mask_np = np.random.default_rng(20 + seed).random((48, 64)) < density
    else:
        mask_np = _serpentine(24, 32)
    h, w = mask_np.shape
    limit = h + w if cap is None else cap
    ref, ref_rounds = _jax_loop(mask_np, limit)
    monkeypatch.setenv("LEAF_PALLAS_CC", "1")
    lab, mask, _, _ = _jax_inputs(mask_np)
    np.testing.assert_array_equal(ref, np.asarray(jcc._propagate(
        lab, mask, limit)))
    got, rounds = cc_propagate_plain(
        torch.from_numpy(np.array(lab))[None], torch.from_numpy(mask_np)[None],
        limit)
    np.testing.assert_array_equal(got[0].numpy(), ref)
    assert rounds.tolist() == [ref_rounds]
    if cap is not None:
        assert ref_rounds == cap + 1
        full, _ = _jax_loop(mask_np, h + w)
        assert not np.array_equal(full, ref)  # the cap did bind


def test_propagate_twin_batch_gives_each_image_its_own_rounds():
    masks = np.stack([np.random.default_rng(20 + seed).random((48, 64))
                      < density for seed, density in DENSITIES])
    lab = torch.where(torch.from_numpy(masks),
                      torch.arange(1, 48 * 64 + 1, dtype=torch.int32
                                   ).reshape(48, 64), 0)
    got, rounds = cc_propagate_plain(lab, torch.from_numpy(masks), 112)
    for i, m in enumerate(masks):
        ref, ref_rounds = _jax_loop(m, 112)
        np.testing.assert_array_equal(got[i].numpy(), ref)
        assert int(rounds[i]) == ref_rounds


def test_round_wrapper_takes_twin_on_cpu():
    """The wrapper of K4's rounds (`cc_propagate`) takes its twin on a CPU
    tensor and launches nothing."""
    rng = np.random.default_rng(4)
    mask = torch.from_numpy(rng.random((2, 16, 24)) < 0.5)
    lab = torch.where(mask, torch.arange(1, 16 * 24 + 1, dtype=torch.int32
                                         ).reshape(16, 24), 0)
    before = cc_propagate.launches
    out, rounds = cc_propagate(lab, mask, 40)
    assert cc_propagate.launches == before  # no kernel launch on the CPU
    ref, ref_rounds = cc_propagate_plain(lab, mask, 40)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(rounds, ref_rounds, rtol=0, atol=0)
    assert out.dtype == rounds.dtype == torch.int32


def _masks():
    out = []
    for seed, density in DENSITIES:
        rng = np.random.default_rng(10 + seed)
        out.append(rng.random((48, 64)) < density)
    return out


@pytest.mark.parametrize("idx", range(3))
def test_label_and_component_functions_match_jax(idx):
    """label_components, largest_component, remove_small_components,
    component_count and fill_holes: exact against JAX."""
    m = _masks()[idx]
    jm, tm = jnp.asarray(m), torch.from_numpy(m)
    np.testing.assert_array_equal(tcc.label_components(tm).numpy(),
                                  np.asarray(jcc.label_components(jm)))
    np.testing.assert_array_equal(tcc.largest_component(tm).numpy(),
                                  np.asarray(jcc.largest_component(jm)))
    for min_size in (1, 3, 10):
        np.testing.assert_array_equal(
            tcc.remove_small_components(tm, min_size).numpy(),
            np.asarray(jcc.remove_small_components(jm, min_size)))
    assert int(tcc.component_count(tm, 2)) == int(jcc.component_count(jm, 2))
    np.testing.assert_array_equal(fill_holes(tm).numpy(),
                                  np.asarray(j_fill_holes(jm)))


def test_wide_round_matches_jax_tuple_round():
    """The int64 round for images too large for the int32 packing, at a
    small size, against the JAX (value, flag) tuple-scan round: exact,
    round by round, until the labels converge."""
    rng = np.random.default_rng(7)
    m = rng.random((40, 56)) < 0.6
    jm, tm = jnp.asarray(m), torch.from_numpy(m)
    h, w = m.shape
    label_bits = (h * w + 1).bit_length()
    segs = tcc._segment_planes(tm, label_bits, torch.int64)
    lab = jnp.where(jm, jnp.arange(1, h * w + 1, dtype=jnp.int32
                                   ).reshape(h, w), 0)
    got = torch.from_numpy(np.array(lab))
    for _ in range(h + w):
        prev = got
        grown = jax.lax.reduce_window(lab, jnp.int32(0), jax.lax.max,
                                      (3, 3), (1, 1), [(1, 1), (1, 1)])
        lab = jnp.where(jm, grown, 0)
        lab = jcc._axis_pass_tuple(lab, jm, 0)
        lab = jcc._axis_pass_tuple(lab, jm, 1)
        got = tcc._round_wide(got, tm, segs, label_bits)
        np.testing.assert_array_equal(got.numpy(), np.asarray(lab))
        if torch.equal(prev, got):
            break
    np.testing.assert_array_equal(got.numpy(),
                                  tcc.label_components(tm).numpy())

