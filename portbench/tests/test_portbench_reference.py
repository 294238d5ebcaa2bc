"""The plain reference agrees with the port on the CPU at a small size:
models, the augmentation, and a whole run's training steps and
evaluation in float32."""

from __future__ import annotations

import pytest
import torch

from conftest import tiny_cell, tiny_run, train_cells
from portbench import images, program, weights
from portbench.drivers import train
from portbench.reference import augment, models


def _pixels(n: int, size: int, seed: int = 3) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    labels = torch.randint(0, 8, (n,), generator=g)
    return images.leaf_images(labels, size, images.class_shifts(8, g, "cpu"),
                              g)


@pytest.mark.parametrize("cell", train_cells())
def test_eval_forward_matches_port(cell):
    cfg = tiny_cell(cell).config
    x8 = _pixels(6, cfg["img_size"])
    w = weights.draw(cfg, x8, torch.Generator().manual_seed(1))
    port = program.model(cfg, w, torch.device("cpu")).eval()
    x = x8.float() / 255.0
    with torch.no_grad():
        torch.testing.assert_close(port(x), models.forward(
            cfg, w, x, models.Context(False)), rtol=1e-5, atol=1e-5)
    assert [n for n, _, _ in models.layout(cfg)] == list(port.state_dict())


def test_augment_matches_port_twin():
    from leaffliction_tpu_torch.ops.train_augment import apply_u8, draw_params

    x8 = _pixels(5, 48)
    flip, angles, factors = draw_params(5, torch.Generator().manual_seed(4),
                                        "cpu")
    got = augment.augment(x8, flip, angles, factors)
    assert torch.equal(got, apply_u8(x8, flip, angles, factors))


@pytest.mark.parametrize("cell", train_cells())
def test_run_matches_port_in_float32(cell):
    """Every number of a whole tiny run with the port in float32: the
    first K steps, the window's first K steps and the closing
    evaluation. The first steps' change alone is looser: Adam's first
    update is ±lr wherever a gradient is near zero, so a rounding
    difference there flips an element's whole step."""
    got = train.readings(tiny_run(cell, 11))
    for name, value in got["program"].items():
        assert value < (1e-2 if name.startswith("start_") else 1e-4), \
            (name, value)
