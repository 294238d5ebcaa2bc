"""The channels-last contract of the train step's hand kernels
(`ops/layout.py`) on the CPU, for each op that reads it.

`channels_last` hands a kernel a channels-last tensor: the tensor itself
when it is one, else a copy with the same values, counted in the calling
op's own `copy` counter (`batch_norm.copy`, `block_exit.copy`, which the
train step's launch bookkeeping reads); `channels_first` copies a result
back, counted the same way. An input of another layout, or of a dtype no
kernel takes, raises with the op's name. The kernels themselves, and the
layouts at the models' shapes, are held on the card in
`tests/test_torch_gpu.py`.
"""

import pytest

torch = pytest.importorskip("torch")

from leaffliction_tpu_torch.ops import layout  # noqa: E402
from leaffliction_tpu_torch.ops.kernels import batch_norm  # noqa: E402
from leaffliction_tpu_torch.ops.kernels import block_exit  # noqa: E402

OPS = pytest.mark.parametrize("op,counter", [
    ("batch_norm", batch_norm.launches),
    ("block_exit", block_exit.launches),
], ids=["batch_norm", "block_exit"])


def _aligned(shape, dtype=torch.bfloat16, channels_last=False):
    t = torch.zeros(shape, dtype=dtype)
    return t.to(memory_format=torch.channels_last) if channels_last else t


@OPS
@pytest.mark.parametrize("make,gradient,copied", [
    (lambda: _aligned((2, 16, 4, 4), channels_last=True), False, False),
    (lambda: _aligned((6, 24)), False, False),
    (lambda: torch.randn((2, 16, 4, 4)).to(torch.bfloat16), False, True),
    (lambda: torch.randn((2, 16, 5)), False, True),
    # a gradient of a sum: every stride 0
    (lambda: torch.ones(()).expand(2, 16, 4, 4), True, True),
    (lambda: torch.randn((2, 4, 16, 4)).permute(0, 2, 1, 3), True, True),
])
def test_channels_last_copies_what_the_kernels_cannot_read(
        monkeypatch, op, counter, make, gradient, copied):
    """`channels_last` hands the kernels a channels-last tensor: the
    tensor itself when it is one, else a counted copy with the same
    values; `channels_first` copies an output back, counted."""
    monkeypatch.setitem(counter, "copy", 0)
    t = make()
    got = layout.channels_last(t, counter, op, gradient=gradient)
    assert (got is not t) == copied
    assert got.movedim(1, -1).is_contiguous() and torch.equal(got, t)
    assert layout.is_channels_last(got)
    assert counter["copy"] == int(copied)
    back = layout.channels_first(got, counter)
    assert back.is_contiguous() and torch.equal(back, t)
    assert counter["copy"] == int(copied) + 1


@OPS
def test_channels_last_refuses_an_input_of_another_layout(op, counter):
    x = torch.randn((2, 4, 16, 4)).permute(0, 2, 1, 3)
    with pytest.raises(ValueError, match=f"{op}: .*neither"):
        layout.channels_last(x, counter, op)
    with pytest.raises(ValueError, match=f"{op}: no kernel"):
        layout.channels_last(x.half(), counter, op, gradient=True)
