"""The comparison that decides `correct`: a sound tiny run passes, and a
run with the timed path broken underneath comes out not correct; on the
card, at the cell's own size, so does the control (the reference in the
precision below the configuration's) in the program's place."""

from __future__ import annotations

import pytest
import torch

from conftest import bench, cpu_run, train_cells
from portbench import harness
from portbench.drivers import train

TRAIN = train_cells()


@pytest.mark.parametrize("cell", TRAIN)
def test_sound_run_is_correct(cell):
    result = cpu_run(cell)
    assert result["correct"], result["compared"]
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("cell", TRAIN)
def test_state_left_unchanged(cell, monkeypatch):
    from leaffliction_tpu_torch.train import steps

    monkeypatch.setattr(steps, "apply_updates", lambda *a, **k: None)
    assert not cpu_run(cell)["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_ema_left_unchanged(cell, monkeypatch):
    from leaffliction_tpu_torch.train import steps

    monkeypatch.setattr(steps, "update_ema", lambda *a, **k: None)
    assert not cpu_run(cell)["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_left_out(cell, monkeypatch):
    from leaffliction_tpu_torch.train import steps

    real = steps.loss_fn

    def half(logits, labels, mask, *a, **k):
        keep = torch.arange(len(mask), device=mask.device) < len(mask) // 2
        return real(logits, labels, mask * keep, *a, **k)

    monkeypatch.setattr(steps, "loss_fn", half)
    assert not cpu_run(cell)["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_eval_answer_altered(cell, monkeypatch):
    from leaffliction_tpu_torch.train.steps import StepFns

    real = StepFns.eval_chain_gather

    def altered(self, *a, **k):
        m, preds = real(self, *a, **k)
        return {**m, "loss_sum": m["loss_sum"] * 1.05}, preds

    monkeypatch.setattr(StepFns, "eval_chain_gather", altered)
    assert not cpu_run(cell)["correct"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", TRAIN)
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control at the cell's own size")
    from leaffliction_tpu_torch.core.device import resolve_device

    c = harness.find_cell(cell, bench())
    for seed in [61, 62, 63]:
        run = harness.Run(c, seed, 0.0, False, resolve_device("cuda"), 0.0)
        got = train.readings(run)["control"]
        assert any(got[k] > lim for k, lim in c.limits.items()), (seed, got)
