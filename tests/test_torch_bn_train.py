"""Training BatchNorm in the PyTorch port, held against the JAX package.

`ops/fused_bn.bn_train` (NCHW, `torch.autograd.Function`) against JAX's
`bn_train` (NHWC, custom VJP) on the same numpy inputs, at the tolerances
`tests/test_fused_bn.py` pins for the JAX op against flax: y at 1e-6 in f32
and 2e-2 in bf16 (8 mantissa bits), mean and var at 1e-5, and the VJP (dx,
dγ, dβ) at rtol 2e-4 / atol 2e-3. The module's running update is
`0.99·ra + 0.01·batch` with the *biased* batch variance: held against the
JAX module and against float64 numpy at rtol 1e-6, tight enough that the
unbiased variance (a factor M/(M−1) = 18/17 here) fails.

The fused ReLU (`relu=True`) of the plain twin is held against JAX's
`relu(bn_train(...))` at the same tolerances, forward and VJP. The models
pass it where they applied `torch.relu` to a BatchNorm's output, and on the
CPU their forward and backward equal that explicit composition bit for
bit; their state_dict keys are the JAX init tree's. What surrounds the card's
kernels is checked here too: the layout and vector rule of
`ops/kernels/batch_norm.geometry`, the counted copies into and out of
channels-last of the autograd function and eval on stand-in kernels that
refuse any other layout (`ops/layout.py` alone is held in
`tests/test_torch_layout.py`), and
the launch bookkeeping of `train/graph.py` over the counters registered
with `kernels/build.py`, with a stand-in counter (the kernels themselves
are held against the twin in `tests/test_torch_gpu.py`).
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from leaffliction_tpu.models.leafcnn import build_leafcnn as jax_leafcnn  # noqa: E402
from leaffliction_tpu.models.leafcnn import init_model as jax_init  # noqa: E402
from leaffliction_tpu.models.resnet import build_resnet as jax_resnet  # noqa: E402
from leaffliction_tpu.ops.fused_bn import BatchNorm as JaxBN  # noqa: E402
from leaffliction_tpu.ops.fused_bn import bn_train as jax_bn_train  # noqa: E402
from leaffliction_tpu_torch.convert import to_state_dict  # noqa: E402
from leaffliction_tpu_torch.kernels import build  # noqa: E402
from leaffliction_tpu_torch.models.leafcnn import (  # noqa: E402
    LeafCNN,
    build_leafcnn,
    init_model,
)
from leaffliction_tpu_torch.models.resnet import (  # noqa: E402
    LeafResNet,
    build_resnet,
)
from leaffliction_tpu_torch.ops import fused_bn  # noqa: E402
from leaffliction_tpu_torch.ops.fused_bn import BatchNorm, bn_train  # noqa: E402
from leaffliction_tpu_torch.ops.kernels import batch_norm  # noqa: E402
from leaffliction_tpu_torch.train import graph  # noqa: E402

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


@pytest.mark.parametrize("shape", [(4, 8, 8, 32), (2, 5, 7, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_relu_forward_matches_jax(shape, dtype):
    x, scale, bias, _ = _inputs(shape, seed=5)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    xj = jnp.asarray(x).astype(jdt)
    yj = jax.nn.relu(jax_bn_train(xj, jnp.asarray(scale), jnp.asarray(bias),
                                  1e-3)[0])
    xt = _nchw(np.asarray(xj.astype(jnp.float32))).to(tdt)
    yt, _, _ = bn_train(xt, torch.from_numpy(scale), torch.from_numpy(bias),
                        1e-3, relu=True)
    assert yt.dtype == tdt and bool((yt >= 0).all())
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_nhwc(yt), np.asarray(yj, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [(4, 8, 8, 32), (2, 5, 7, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_relu_vjp_matches_jax(shape, dtype):
    x, scale, bias, dy = _inputs(shape, seed=9)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    xj = jnp.asarray(x).astype(jdt)
    dyj = jnp.asarray(dy).astype(jdt)
    _, vjp = jax.vjp(
        lambda a, s, b: jax.nn.relu(jax_bn_train(a, s, b, 1e-3)[0]), xj,
        jnp.asarray(scale), jnp.asarray(bias))
    dxj, dgj, dbj = vjp(dyj)

    xt = _nchw(np.asarray(xj.astype(jnp.float32))).to(tdt).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    yt, _, _ = bn_train(xt, st, bt, 1e-3, relu=True)
    yt.backward(_nchw(np.asarray(dyj.astype(jnp.float32))).to(tdt))
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(dxj, np.float32),
                               rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(dgj),
                               rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(dbj),
                               rtol=2e-4, atol=2e-3)


def _jax_keys(arch):
    if arch == "leafcnn":
        params, stats, norm = jax_init(jax_leafcnn(5, "base"), 32)
        tree = {"params": params, "batch_stats": stats, "norm_stats": norm}
    else:
        tree = jax_resnet(5, "resnet18", lane_fold=False).init(
            jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False)
    return set(to_state_dict(jax.device_get(tree)))


@pytest.mark.parametrize("arch", ["leafcnn", "resnet18"])
def test_model_state_dict_keys_are_the_jax_trees(arch):
    """The fused ReLU is an argument of the call, not a module: every
    BatchNorm keeps scale, bias, mean and var, and the keys are the flax
    tree's."""
    model = build_leafcnn(5) if arch == "leafcnn" else build_resnet(5)
    assert set(model.state_dict()) == _jax_keys(arch)
    for module in model.modules():
        if isinstance(module, BatchNorm):
            assert list(module.state_dict()) == ["scale", "bias", "mean",
                                                 "var"]


# the BatchNorms the models follow with a ReLU
RELU_AFTER = {
    "leafcnn": lambda name: ".ConvBlock_" in f".{name}",
    "resnet10": lambda name: name == "BatchNorm_0"
    or name.endswith(".BatchNorm_0") and name.startswith("BasicBlock_"),
}


def _small_model(arch, dtype):
    if arch == "leafcnn":
        model = LeafCNN(5, (16, 32), dtype=dtype, drop_block=0.15,
                        drop_top=0.3)
    else:
        model = build_resnet(5, "resnet10", dtype=dtype)
    init_model(model, 0)
    with torch.no_grad():  # non-identity statistics and affine
        g = torch.Generator().manual_seed(2)
        for name, t in model.state_dict().items():
            if name.endswith((".mean", ".bias")):
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
            elif name.endswith((".var", ".scale")):
                t.copy_(torch.rand(t.shape, generator=g) * 0.5 + 0.75)
    return model


def _run(model, train):
    x = torch.rand((3, 32, 32, 3), generator=torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(6)
    out = model(x, train=train, generator=gen)
    grads = torch.autograd.grad(out.float().square().sum(),
                                list(model.parameters()), allow_unused=True)
    return out, grads, [b.clone() for b in model.buffers()]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("arch,dtype", [("leafcnn", torch.float32),
                                        ("leafcnn", torch.bfloat16),
                                        ("resnet10", torch.float32)])
def test_models_fused_relu_is_the_explicit_composition(monkeypatch, arch,
                                                       dtype, train):
    """LeafCNN and LeafResNet on the CPU, forward and backward, against the
    same models with every BatchNorm's ReLU applied outside it
    (`torch.relu(BN(x))`, the models' old code): bit for bit, and the ReLU
    passed exactly where the models had one."""
    fused = _small_model(arch, dtype)
    composed = _small_model(arch, dtype)
    names = {m: n for n, m in composed.named_modules()}
    relu_at = set()
    plain = BatchNorm.forward

    def forward(self, x, train=False, group=None, relu=False):
        if relu:
            relu_at.add(names[self])
            return torch.relu(plain(self, x, train, group))
        return plain(self, x, train, group)

    want = _run(fused, train)
    monkeypatch.setattr(BatchNorm, "forward", forward)
    got = _run(composed, train)
    bns = {n for n, m in composed.named_modules() if isinstance(m, BatchNorm)}
    assert relu_at == {n for n in bns if RELU_AFTER[arch](n)}
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert (a is None and b is None) or torch.equal(a, b)
    for a, b in zip(got[2], want[2]):
        assert torch.equal(a, b)


def test_batch_norm_refuses_other_devices():
    bn = BatchNorm(4)
    with pytest.raises(ValueError, match="no path for device meta"):
        bn(torch.empty((2, 4, 3, 3), device="meta"))


def _aligned(shape, dtype=torch.bfloat16, channels_last=False):
    t = torch.zeros(shape, dtype=dtype)
    return t.to(memory_format=torch.channels_last) if channels_last else t


def _nhwc_of(shape, dtype=torch.bfloat16, offset=0):
    """A channels-last [N, C, ...] view of a flat buffer, `offset`
    elements in."""
    n, c, *rest = shape
    flat = torch.zeros(offset + n * c * int(np.prod(rest, dtype=int)),
                       dtype=dtype)[offset:]
    return flat.view(n, *rest, c).movedim(-1, 1)


@pytest.mark.parametrize("make,want", [
    (lambda: _aligned((2, 16, 4, 4), channels_last=True), (32, 16, 8)),
    (lambda: _aligned((2, 16, 3, 3), channels_last=True), (18, 16, 8)),
    (lambda: _aligned((2, 12, 4, 4), torch.float32, True), (32, 12, 1)),
    (lambda: _aligned((2, 16, 1, 1)), (2, 16, 8)),
    (lambda: _aligned((6, 24)), (6, 24, 8)),
    (lambda: _nhwc_of((2, 8, 5)), (10, 8, 8)),
    # an offset of one element: the same kernels, one element a thread
    (lambda: _nhwc_of((2, 16, 4, 4), offset=1), (32, 16, 1)),
])
def test_geometry_follows_the_strides(make, want):
    assert batch_norm.geometry(make()) == want


@pytest.mark.parametrize("make,match", [
    (lambda: _aligned((2, 4, 4, 16)).permute(0, 3, 1, 2)[:, :, :, :3],
     "not channels-last"),
    (lambda: _aligned((2, 16, 4, 4)), "not channels-last"),
    (lambda: _aligned((2, 16, 4, 4), torch.float16), "no kernel"),
    (lambda: _aligned((16,)), "want"),
])
def test_geometry_refuses_other_layouts(make, match):
    with pytest.raises(ValueError, match=match):
        batch_norm.geometry(make())


def _channels_last_only(*ts):
    for t in ts:
        assert t.movedim(1, -1).is_contiguous(), t.stride()


def _stand_in_kernels():
    """`ops/kernels/batch_norm.py` with its four kernels' wrappers in the
    twin's arithmetic on the CPU, each refusing a tensor that is not
    channels-last, and its own copies and counters."""
    dims = (0, 2, 3)

    def c4(v):
        return v.view(1, -1, 1, 1)

    def moments(x, group=None, running=None, momentum=0.0):
        _channels_last_only(x)
        xf, m = x.float(), x.numel() // x.shape[1]
        mean = xf.sum(dim=dims) / m
        var = torch.clamp_min((xf * xf).sum(dim=dims) / m - mean * mean, 0)
        return mean, var

    def normalize(x, mean, var, scale, bias, eps, relu=False):
        _channels_last_only(x)
        return fused_bn.bn_eval_plain(x, mean, var, scale, bias, eps,
                                      x.dtype, relu)

    def kept(x, dy, mean, var, scale, bias, eps, relu):
        y = normalize(x, mean, var, scale, bias, eps, relu)
        d = torch.where(y > 0, dy, 0) if relu else dy
        return d.float(), (x.float() - c4(mean)) * c4(torch.rsqrt(var + eps))

    def grad_sums(x, dy, mean, var, scale, bias, eps, relu=False):
        _channels_last_only(x, dy)
        d, xhat = kept(x, dy, mean, var, scale, bias, eps, relu)
        return torch.stack([d.sum(dim=dims), (d * xhat).sum(dim=dims)])

    def grad_input(x, dy, mean, var, scale, bias, sums, eps, count,
                   relu=False):
        _channels_last_only(x, dy)
        d, xhat = kept(x, dy, mean, var, scale, bias, eps, relu)
        gain = c4(scale * torch.rsqrt(var + eps))
        return (gain * ((d - c4(sums[0] / count))
                        - xhat * c4(sums[1] / count))).to(x.dtype)

    return SimpleNamespace(
        launches=batch_norm.launches, moments=moments, normalize=normalize,
        grad_sums=grad_sums, grad_input=grad_input)


@pytest.mark.parametrize("train", [True, False])
def test_kernel_path_copies_a_channels_first_input_in_and_out(monkeypatch,
                                                              train):
    """The autograd function and the eval of the card's path, on stand-in
    kernels: a channels-last x reaches them as it is, a channels-first one
    as a copy whose outputs come back in its layout (x and y, and training
    dy and dx: each copy counted), with the same values."""
    monkeypatch.setattr(fused_bn, "_kernels", _stand_in_kernels)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 8, 5, 5), generator=gen)
    dy = torch.randn((2, 8, 5, 5), generator=gen)
    bn = BatchNorm(8, 1e-3)
    with torch.no_grad():
        bn.scale.uniform_(0.5, 1.5, generator=gen)
        bn.bias.uniform_(-0.2, 0.2, generator=gen)
    got = []
    for fmt in (torch.channels_last, torch.contiguous_format):
        monkeypatch.setitem(batch_norm.launches, "copy", 0)
        xi = x.clone(memory_format=fmt).requires_grad_(train)
        if train:
            y = fused_bn._BNTrainKernel.apply(xi, bn.scale, bn.bias, 1e-3,
                                              None, True, None, 0.0)[0]
            y.backward(dy.clone(memory_format=fmt))
            assert xi.grad.stride() == xi.stride()
        else:
            with torch.no_grad():
                y = bn._on_card(xi, False, None, True)
        assert y.stride() == xi.stride()
        got.append((y, xi.grad, batch_norm.launches["copy"]))
    (y_cl, dx_cl, n_cl), (y_cf, dx_cf, n_cf) = got
    assert (n_cl, n_cf) == (0, 4 if train else 2)
    assert torch.equal(y_cl, y_cf)
    assert not train or torch.equal(dx_cl, dx_cf)


def test_graph_launch_bookkeeping_takes_back_a_capture(monkeypatch):
    """`graph.recorded` around a capture hands back what each registered
    counter counted inside it (a counter registered inside it too) and
    leaves the counters as they were, also when the capture raises; a
    replay adds the recorded launches."""
    monkeypatch.setattr(build, "_launch_counters",
                        dict(build._launch_counters))
    stand_in = {"n": 5}
    build.register_launches("stand_in", stand_in, "n")
    monkeypatch.setitem(batch_norm.launches, "apply", 7)
    late = {"launches": 0}
    before = build.launch_counts()
    with graph.recorded() as launches:
        stand_in["n"] += 3
        batch_norm.launches["apply"] += 2
        build.register_launches("late", late)
        late["launches"] += 1
    assert build.launch_counts() == {**before, "late": 0}
    assert launches == {"stand_in": 3, "batch_norm.apply": 2, "late": 1}
    build.add_launches(launches)
    build.add_launches(launches)
    assert stand_in["n"] == 11 and batch_norm.launches["apply"] == 11
    assert late["launches"] == 2
    with pytest.raises(RuntimeError):
        with graph.recorded():
            stand_in["n"] += 1
            raise RuntimeError("capture failed")
    assert stand_in["n"] == 11


def test_card_paths_are_taken_only_on_the_card(monkeypatch):
    """A CPU tensor never reaches the kernels' wrappers."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper ran on the CPU")

    for name in ("moments", "normalize", "grad_sums", "grad_input"):
        monkeypatch.setattr(batch_norm, name, refuse)
    for name in ("channels_last", "channels_first"):
        monkeypatch.setattr(fused_bn, name, refuse)
    model = _small_model("resnet10", torch.float32)
    _run(model, True)
    _run(model, False)
