"""LeafCNN in the PyTorch port, held against the flax model.

Same seeded variables on both sides (flax init, then BN statistics, BN
affine parameters and norm_stats redrawn with numpy so that none of them is
the identity), converted by `convert.py`. Eval logits at f32: rtol and atol
1e-4 (TF32 off; only the summation order differs). bf16 compute:
probabilities at atol 2e-2 with the same top-1 (bf16 keeps 8 bits of
mantissa, and the two frameworks round at the same places but convolve in
different orders). Batch 4 at 32 px, so the JAX side does not lane-fold.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from leaffliction_tpu.models.leafcnn import build_leafcnn as jax_build  # noqa: E402
from leaffliction_tpu.models.leafcnn import init_model  # noqa: E402
from leaffliction_tpu_torch.convert import to_flax, to_state_dict  # noqa: E402
from leaffliction_tpu_torch.models.leafcnn import build_leafcnn  # noqa: E402

torch.set_num_threads(1)

NUM_CLASSES = 5
CASES = [("tiny", "conv", False), ("tiny", "conv", True),
         ("tiny", "s2d", False), ("tiny", "s2d", True),
         ("base", "conv", False)]


def _redraw(tree, rng):
    """Random non-identity BN/norm statistics and affine parameters."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _redraw(v, rng)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("mean", "bias"):
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k == "scale":
            out[k] = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


def _variables(scale, stem, separable, seed=0):
    model = jax_build(NUM_CLASSES, scale, separable=separable, stem=stem)
    params, stats, norm = init_model(model, 32, seed=seed)
    rng = np.random.default_rng(seed)
    variables = {"params": _redraw(jax.device_get(params), rng),
                 "batch_stats": _redraw(jax.device_get(stats), rng),
                 "norm_stats": {"mean": rng.uniform(0.3, 0.6, 3).astype(
                     np.float32),
                     "var": rng.uniform(0.05, 0.1, 3).astype(np.float32)}}
    return variables


def _images(seed=1, n=4):
    return np.random.default_rng(seed).random((n, 32, 32, 3)).astype(
        np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("scale,stem,separable", CASES)
def test_convert_round_trip(scale, stem, separable):
    variables = _variables(scale, stem, separable)
    model = build_leafcnn(NUM_CLASSES, scale, separable=separable, stem=stem)
    sd = to_state_dict(variables)
    model.load_state_dict(sd)  # strict: every key and shape accounted for
    back = _flat(to_flax(model.state_dict()))
    ref = _flat(variables)
    assert set(back) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)


@pytest.mark.parametrize("scale,stem,separable", CASES)
def test_eval_logits_match_flax_f32(scale, stem, separable):
    variables = _variables(scale, stem, separable)
    x = _images()
    jmodel = jax_build(NUM_CLASSES, scale, separable=separable, stem=stem)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    model = build_leafcnn(NUM_CLASSES, scale, separable=separable, stem=stem)
    model.load_state_dict(to_state_dict(variables))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("scale,stem", [("tiny", "conv"), ("tiny", "s2d"),
                                        ("base", "conv")])
def test_bf16_probabilities_match_flax(scale, stem):
    variables = _variables(scale, stem, False, seed=3)
    x = _images(seed=4, n=8)
    jmodel = jax_build(NUM_CLASSES, scale, stem=stem, dtype=jnp.bfloat16)
    ref = np.asarray(jax.nn.softmax(
        jmodel.apply(variables, jnp.asarray(x), train=False), axis=-1))
    model = build_leafcnn(NUM_CLASSES, scale, stem=stem, dtype=torch.bfloat16)
    model.load_state_dict(to_state_dict(variables))
    with torch.no_grad():
        got = torch.softmax(model.eval()(torch.from_numpy(x)), -1).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
