"""The reference's FLOP counts at 224 px: the figures the port's own count
(`train/flops.py`) gives for its models, counted over the plain reference
instead of the port, and frozen in each configuration's file
(`portbench/frozen/<config>.json`, written by `tools/freeze.py`)."""

from __future__ import annotations

import pytest

from conftest import bench, check_frozen
from portbench import flops


@pytest.mark.parametrize("config", bench()["configs"],
                         ids=[c["name"] for c in bench()["configs"]])
def test_counts(config):
    check_frozen(config, ["train_flops_per_image", "forward_flops_per_image"])


def test_peak_table_refuses_an_unknown_card(monkeypatch):
    monkeypatch.setattr(flops.torch.cuda, "get_device_name",
                        lambda device=None: "Some Other Card")
    with pytest.raises(RuntimeError):
        flops.peak_flops("cuda")
