"""Training BatchNorm in the PyTorch port, held against the JAX package.

`ops/fused_bn.bn_train` (NCHW, `torch.autograd.Function`) against JAX's
`bn_train` (NHWC, custom VJP) on the same numpy inputs, at the tolerances
`tests/test_fused_bn.py` pins for the JAX op against flax: y at 1e-6 in f32
and 2e-2 in bf16 (8 mantissa bits), mean and var at 1e-5, and the VJP (dx,
dγ, dβ) at rtol 2e-4 / atol 2e-3. The module's running update is
`0.99·ra + 0.01·batch` with the *biased* batch variance: held against the
JAX module and against float64 numpy at rtol 1e-6, tight enough that the
unbiased variance (a factor M/(M−1) = 18/17 here) fails.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from leaffliction_tpu.ops.fused_bn import BatchNorm as JaxBN  # noqa: E402
from leaffliction_tpu.ops.fused_bn import bn_train as jax_bn_train  # noqa: E402
from leaffliction_tpu_torch.ops.fused_bn import BatchNorm, bn_train  # noqa: E402

torch.set_num_threads(1)

SHAPES = [(4, 8, 8, 32), (2, 8, 8, 64), (2, 4, 4, 128), (2, 5, 7, 32)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    c = shape[-1]
    scale = np.linspace(0.5, 1.5, c, dtype=np.float32)
    bias = np.linspace(-0.3, 0.3, c, dtype=np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, scale, bias, dy


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_stats_match_jax(shape, dtype):
    x, scale, bias, _ = _inputs(shape)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    xj = jnp.asarray(x).astype(jdt)
    yj, mj, vj = jax_bn_train(xj, jnp.asarray(scale), jnp.asarray(bias),
                              1e-3)
    # identical bf16 inputs on both sides
    xt = _nchw(np.asarray(xj.astype(jnp.float32))).to(tdt)
    yt, mt, vt = bn_train(xt, torch.from_numpy(scale),
                          torch.from_numpy(bias), 1e-3)
    assert yt.dtype == tdt and mt.dtype == torch.float32
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_nhwc(yt), np.asarray(yj, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape", [(4, 8, 8, 32), (2, 5, 7, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vjp_matches_jax(shape, dtype):
    x, scale, bias, dy = _inputs(shape, seed=3)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    xj = jnp.asarray(x).astype(jdt)
    dyj = jnp.asarray(dy).astype(jdt)
    _, vjp = jax.vjp(lambda a, s, b: jax_bn_train(a, s, b, 1e-3)[0], xj,
                     jnp.asarray(scale), jnp.asarray(bias))
    dxj, dgj, dbj = vjp(dyj)

    xt = _nchw(np.asarray(xj.astype(jnp.float32))).to(tdt).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    yt, _, _ = bn_train(xt, st, bt, 1e-3)
    yt.backward(_nchw(np.asarray(dyj.astype(jnp.float32))).to(tdt))
    assert xt.grad.dtype == tdt and st.grad.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(dxj, np.float32),
                               rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(dgj),
                               rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(dbj),
                               rtol=2e-4, atol=2e-3)


def test_running_update_matches_jax_module_and_is_biased():
    shape = (2, 3, 3, 4)  # M = 18: the unbiased variance is 18/17 larger
    x, scale, bias, _ = _inputs(shape, seed=7)
    mean0 = np.array([0.1, -0.2, 0.3, 0.0], np.float32)
    var0 = np.array([0.5, 1.0, 2.0, 1.5], np.float32)

    mod = JaxBN(use_running_average=False, momentum=0.99, epsilon=1e-3)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0),
                                 "var": jnp.asarray(var0)}}
    yj, mutated = mod.apply(variables, jnp.asarray(x),
                            mutable=["batch_stats"])

    bn = BatchNorm(4)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.mean.copy_(torch.from_numpy(mean0))
        bn.var.copy_(torch.from_numpy(var0))
    yt = bn(_nchw(x), train=True)
    np.testing.assert_allclose(_nhwc(yt), np.asarray(yj), rtol=1e-6,
                               atol=1e-6)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(mutated["batch_stats"][k]),
                                   rtol=1e-6, atol=1e-7)

    xf = x.astype(np.float64)
    bm = xf.mean(axis=(0, 1, 2))
    bv = xf.var(axis=(0, 1, 2))           # biased
    np.testing.assert_allclose(bn.mean.numpy(), 0.99 * mean0 + 0.01 * bm,
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.var.numpy(), 0.99 * var0 + 0.01 * bv,
                               rtol=1e-6)
    unbiased = 0.99 * var0 + 0.01 * xf.var(axis=(0, 1, 2), ddof=1)
    assert not np.allclose(bn.var.numpy(), unbiased, rtol=1e-6, atol=0)


def test_eval_mode_leaves_running_stats_alone():
    bn = BatchNorm(8)
    x = torch.randn(2, 8, 4, 4, generator=torch.Generator().manual_seed(1))
    y = bn(x)
    assert torch.equal(bn.mean, torch.zeros(8))
    assert torch.equal(bn.var, torch.ones(8))
    torch.testing.assert_close(y, x / torch.sqrt(torch.tensor(1.0 + 1e-3)))
