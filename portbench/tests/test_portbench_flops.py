"""The reference's FLOP counts at 224 px: the figures the port's own count
(`train/flops.py`) gives for its models, counted over the plain reference
instead of the port."""

from __future__ import annotations

import pytest

from portbench import flops, harness

# GFLOP an image, forward and backward / forward (exact integers)
EXPECTED = {"train-leafcnn_base-b32": (18_670_431_744, 6_252_378_624),
            "train-resnet18-b128": (10_646_409_216, 3_627_479_040)}


@pytest.mark.parametrize("cell", sorted(EXPECTED))
def test_counts(cell):
    cfg = harness.find_cell(cell).config
    assert flops.train_flops_per_image(cfg) == EXPECTED[cell][0]
    assert flops.forward_flops_per_image(cfg) == EXPECTED[cell][1]


def test_peak_table_refuses_an_unknown_card(monkeypatch):
    monkeypatch.setattr(flops.torch.cuda, "get_device_name",
                        lambda device=None: "Some Other Card")
    with pytest.raises(RuntimeError):
        flops.peak_flops("cuda")
