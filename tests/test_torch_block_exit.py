"""The residual blocks' exit (`ops/block_exit.py`) on the CPU, where it is
the plain twin of `csrc/block_exit.cu`.

`block_exit` on a CPU tensor must compute bit for bit what the models'
eager expressions computed before the exit became one op: LeafCNN's
`relu(shortcut + y * se)` (without SE `relu(shortcut + y)`), then the
stage's spatial dropout `where(mask, x / keep, 0)` and `max_pool2d(x, 2)`
(none at stage 0 of the s2d stem), the ResNet block's `relu(shortcut + y *
se)` and its conv stem's 3×3/2 max-pool with flax SAME −inf padding. The
expressions are written out here as they stood in the models; forward and
gradients (y, se, shortcut) are held with `torch.equal`, in f32 and bf16,
at even and odd sizes (a 2×2 pool cuts the odd row and column off, which
then get only zero gradient from the exit). The dropout masks come from
the same `torch.rand` draws in the same order: a training forward leaves
the generator where the former draws left it, and each exit's mask is the
draw the former code made for it. Whole models on the CPU are held to the
former expressions too, by patching the former exit into `block_exit`'s
place. No JAX here: the JAX-parity tests of the models stand unchanged.
"""

import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from leaffliction_tpu_torch.models.leafcnn import (  # noqa: E402
    LeafCNN,
    init_model,
)
from leaffliction_tpu_torch.models.resnet import (  # noqa: E402
    RESNET_PRESETS,
    LeafResNet,
)
from leaffliction_tpu_torch.ops import block_exit as exits  # noqa: E402
from leaffliction_tpu_torch.ops.layout import pad_same  # noqa: E402


def former_exit(y, se=None, shortcut=None, relu=True, drop=None, pool=None):
    """The models' expressions before `block_exit`, as they stood."""
    if se is not None:
        y = y * se                                   # SEBlock
    x = torch.relu(shortcut + y) if relu else y      # ResBlock, BasicBlock
    if drop is not None:                             # leafcnn.dropout
        x = torch.where(drop.mask, x / drop.keep,
                        torch.zeros((), dtype=x.dtype, device=x.device))
    if pool is None:
        return x
    if pool.same:                                    # the ResNet stem
        x, pad = pad_same(x, 3, 2, value=float("-inf"))
        return F.max_pool2d(x, 3, 2, padding=pad)
    return F.max_pool2d(x, 2)                        # LeafCNN's stages


def _inputs(shape, dtype, se, shortcut, drop, seed=0):
    g = torch.Generator().manual_seed(seed)
    n, c = shape[:2]

    def t(*size):
        return torch.randn(size, generator=g).to(dtype).contiguous(
            memory_format=torch.channels_last).requires_grad_()

    y = t(*shape)
    gate = torch.sigmoid(torch.randn((n, c, 1, 1), generator=g)).to(
        dtype).requires_grad_() if se else None
    sc = t(*shape) if shortcut else None
    mask = exits.Drop(torch.rand((n, c, 1, 1), generator=g) < 0.85,
                      1.0 - 0.15) if drop else None
    return y, gate, sc, mask


# (shape, se, shortcut, relu, drop, pool)
CASES = {
    "leafcnn": ((2, 16, 8, 8), True, True, True, True, exits.Pool(2, 2)),
    "leafcnn_no_se": ((2, 16, 8, 8), False, True, True, True,
                      exits.Pool(2, 2)),
    "leafcnn_eval": ((2, 16, 8, 8), True, True, True, False,
                     exits.Pool(2, 2)),
    "leafcnn_s2d_stage0": ((2, 16, 8, 8), True, True, True, True, None),
    "leafcnn_odd": ((3, 12, 7, 9), True, True, True, True, exits.Pool(2, 2)),
    "resnet_block": ((2, 16, 6, 6), True, True, True, False, None),
    "resnet_stem_even": ((2, 8, 8, 8), False, False, False, False,
                         exits.Pool(3, 2, same=True)),
    "resnet_stem_odd": ((2, 8, 9, 7), False, False, False, False,
                        exits.Pool(3, 2, same=True)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_exit_equals_the_former_expressions(case, dtype):
    shape, se, shortcut, relu, drop, pool = CASES[case]
    got, want = [], []
    for fn, out in ((exits.block_exit, got), (former_exit, want)):
        y, gate, sc, mask = _inputs(shape, dtype, se, shortcut, drop)
        x = fn(y, gate, sc, relu=relu, drop=mask, pool=pool)
        leaves = [t for t in (y, gate, sc) if t is not None]
        dx = torch.randn(x.shape, generator=torch.Generator().manual_seed(
            1)).to(dtype)
        out.extend([x.detach(), *torch.autograd.grad(x, leaves, dx)])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_odd_rows_and_columns_get_no_gradient_from_the_pool():
    y, gate, sc, drop = _inputs((2, 8, 5, 7), torch.float32, True, True,
                                False)
    x = exits.block_exit(y, gate, sc, pool=exits.Pool(2, 2))
    assert x.shape == (2, 8, 2, 3)
    dy, dsc = torch.autograd.grad(x, (y, sc), torch.ones_like(x))
    for d in (dy, dsc):
        assert not d[:, :, 4].any() and not d[:, :, :, 6].any()


def test_the_stem_pool_pads_with_minus_infinity():
    """All-negative inputs: a zero padding would win the edge windows."""
    x = -1.0 - torch.rand((1, 2, 8, 8), generator=torch.Generator()
                          .manual_seed(2))
    out = exits.block_exit(x, relu=False, pool=exits.Pool(3, 2, same=True))
    assert out.shape == (1, 2, 4, 4) and bool((out < 0).all())
    assert torch.equal(out, former_exit(x, relu=False,
                                        pool=exits.Pool(3, 2, same=True)))


def _rand_shapes(model, n):
    """The former code's `torch.rand` calls of a LeafCNN training forward:
    one [n, width, 1, 1] a stage (spatial dropout), then [n, widths[-1]]
    (the top dropout)."""
    return [(n, w, 1, 1) for w in model.widths] + [(n, model.widths[-1])]


@pytest.mark.parametrize("stem", ["conv", "s2d"])
def test_dropout_draws_are_the_former_ones(stem):
    model = init_model(LeafCNN(5, (8, 16, 32), stem=stem, drop_block=0.15,
                               drop_top=0.3), 0)
    x = torch.rand((3, 32, 32, 3), generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(9)
    masks = []

    def spy(y, se=None, shortcut=None, relu=True, drop=None, pool=None):
        masks.append(drop.mask)
        return exits.block_exit_plain(y, se, shortcut, relu, drop, pool)

    from unittest import mock

    with mock.patch.object(exits, "block_exit", spy):
        model(x, train=True, generator=g)
    former = torch.Generator().manual_seed(9)
    draws = [torch.rand(s, generator=former)
             for s in _rand_shapes(model, 3)]
    assert torch.equal(g.get_state(), former.get_state())
    assert len(masks) == len(model.widths)
    for mask, draw in zip(masks, draws):
        assert torch.equal(mask, draw < 1.0 - 0.15)


@pytest.mark.parametrize("arch", ["leafcnn", "leafcnn_no_se", "resnet10"])
def test_models_compute_what_the_former_expressions_did(arch):
    """A training forward and backward (bf16 compute, odd size) and an eval
    forward, through `block_exit` and through the former expressions in
    its place: outputs, every gradient and the generator state equal."""
    from unittest import mock

    def build():
        if arch == "resnet10":
            return LeafResNet(5, **RESNET_PRESETS["resnet10"],
                              dtype=torch.bfloat16)
        return LeafCNN(5, (8, 16, 32), use_se=arch == "leafcnn",
                       drop_block=0.15, drop_top=0.3, dtype=torch.bfloat16)

    x = torch.rand((2, 45, 45, 3), generator=torch.Generator().manual_seed(4))
    runs = []
    for fn in (None, former_exit):
        model = init_model(build(), 0)
        g = torch.Generator().manual_seed(7)
        with mock.patch.object(exits, "block_exit", fn or exits.block_exit):
            logits = model(x, train=True, generator=g)
            grads = torch.autograd.grad(logits.float().square().sum(),
                                        list(model.parameters()))
            with torch.no_grad():
                served = model(x)
        runs.append((logits, grads, g.get_state(), served))
    (a, ga, sa, ea), (b, gb, sb, eb) = runs
    assert torch.equal(a, b) and torch.equal(sa, sb) and torch.equal(ea, eb)
    assert all(torch.equal(p, q) for p, q in zip(ga, gb))


def test_other_devices_are_refused():
    y = torch.zeros((1, 8, 2, 2), device="meta")
    with pytest.raises(ValueError, match="no path"):
        exits.block_exit(y, shortcut=y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 64, 7, 7), (3, 13, 5, 9)])
def test_global_mean_is_the_former_mean_with_a_channels_last_gradient(
        shape, dtype):
    """The models' GAP over the channels-last view: the same bits as
    `x.float().mean(dim=(2, 3))`, forward and gradient, and the gradient
    channels-last, as the last exit's kernel reads it."""
    from leaffliction_tpu_torch.models.leafcnn import global_mean

    x = torch.randn(shape, generator=torch.Generator().manual_seed(5)).to(
        dtype).contiguous(memory_format=torch.channels_last).requires_grad_()
    dx = torch.randn(shape[:2], generator=torch.Generator().manual_seed(6))
    got, want = global_mean(x), x.float().mean(dim=(2, 3))
    assert torch.equal(got, want)
    g_got, = torch.autograd.grad(got, x, dx)
    g_want, = torch.autograd.grad(want, x, dx)
    assert torch.equal(g_got, g_want)
    assert g_got.is_contiguous(memory_format=torch.channels_last)
