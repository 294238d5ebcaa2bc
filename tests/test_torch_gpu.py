"""CUDA kernels of the PyTorch port against their plain twins, on the card.

Marked `gpu`; each test skips when no CUDA device is present. On a GPU
machine: `python -m pytest tests/test_torch_gpu.py -m gpu -q`. K4 is integer
only and must be exact; K5 repeats the twin's arithmetic without fused
multiply-adds, so it is held to 1e-3 (as `chip_smoke.py`) though it is
expected to be bit-equal. No JAX here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from leaffliction_tpu_torch.ops.components import _segment_planes  # noqa: E402
from leaffliction_tpu_torch.ops.kernels.components import (  # noqa: E402
    cc_round,
    cc_round_plain,
)
from leaffliction_tpu_torch.ops.kernels.edge import (  # noqa: E402
    edge_nms,
    edge_nms_plain,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("density", [0.2, 0.5, 0.8])
@pytest.mark.parametrize("h,w", [(224, 224), (37, 70)])
def test_cc_round_matches_twin(cuda, h, w, density):
    rng = np.random.default_rng(5)
    label_bits = (h * w + 1).bit_length()
    mask = torch.from_numpy(rng.random((3, h, w)) < density).to(cuda)
    flat = torch.arange(1, h * w + 1, dtype=torch.int32,
                        device=cuda).reshape(h, w)
    segs = _segment_planes(mask, label_bits, torch.int32)
    got = ref = torch.where(mask, flat, 0)
    for _ in range(3):
        got = cc_round(got, mask, *segs, label_bits)
        ref = cc_round_plain(ref, mask, *segs, label_bits)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)


@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("h,w", [(224, 224), (37, 70)])
def test_edge_nms_matches_twin(cuda, h, w, l2):
    rng = np.random.default_rng(6)
    gray = torch.from_numpy(rng.uniform(0, 255, (3, h, w)).astype(
        np.float32)).to(cuda)
    got = edge_nms(gray, l2)
    ref = edge_nms_plain(gray, l2)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-3


def test_wrappers_count_launches(cuda):
    gray = torch.rand(1, 16, 16, device=cuda)
    before = edge_nms.launches
    edge_nms(gray)
    assert edge_nms.launches == before + 1
