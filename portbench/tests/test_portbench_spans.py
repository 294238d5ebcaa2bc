"""The readers of the port's own spans and counters (`portbench/spans.py`):
None for an untraced run, for a run that recorded no such span and for a
port without `core/trace.py` (the parent of the change that added it);
the share of the traced window, or the counter, for a synthetic record."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from conftest import ROOT, tiny_run
from portbench import harness

from leaffliction_tpu_torch.core import trace

READERS = {name: harness.load_module(ROOT / "portbench" / "metrics"
                                     / f"{name}.py")
           for name in ("eval_share.train", "graph_launch.train",
                        "graph_setup_s.train")}
MS = 1_000_000


def _record(monkeypatch, spans, counters):
    monkeypatch.setattr(trace, "spans", lambda: list(spans))
    monkeypatch.setattr(trace, "counters", lambda: dict(counters))


def _traced(window_s=2.0):
    return SimpleNamespace(traced=SimpleNamespace(window_s=window_s))


SYNTHETIC = [
    trace.Span("trainer.epoch", -1, 0, 1900 * MS),
    trace.Span("trainer.dispatch", 0, 10 * MS, 40 * MS),
    trace.Span("graphs.launch", 1, 12 * MS, 15 * MS),
    trace.Span("trainer.dispatch", 0, 40 * MS, 80 * MS),
    trace.Span("graphs.launch", 3, 42 * MS, 47 * MS),
    trace.Span("trainer.evaluate", 0, 1600 * MS, 1850 * MS),
    trace.Span("trainer.callback", 0, 1850 * MS, None),   # still open
]


@pytest.mark.parametrize("name", READERS)
def test_untraced_run_reads_none(name, monkeypatch):
    _record(monkeypatch, SYNTHETIC, {"graphs.capture_s": 1.5})
    run = tiny_run("train-leafcnn_base-b32")
    assert run.traced is None
    assert READERS[name].read(run) is None


@pytest.mark.parametrize("name,want", [("eval_share.train", 12.5),
                                       ("graph_launch.train", 0.4),
                                       ("graph_setup_s.train", 1.5)])
def test_synthetic_record(name, want, monkeypatch):
    _record(monkeypatch, SYNTHETIC, {"graphs.capture_s": 1.5,
                                     "graphs.replays": 2})
    assert READERS[name].read(_traced()) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_nothing_recorded_reads_none(name, monkeypatch):
    _record(monkeypatch, [trace.Span("trainer.epoch", -1, 0, MS)], {})
    assert READERS[name].read(_traced()) is None


@pytest.mark.parametrize("name", READERS)
def test_port_without_the_module_reads_none(name, monkeypatch):
    import leaffliction_tpu_torch.core as core

    _record(monkeypatch, SYNTHETIC, {"graphs.capture_s": 1.5})
    monkeypatch.delattr(core, "trace")
    monkeypatch.setitem(sys.modules, "leaffliction_tpu_torch.core.trace",
                        None)
    assert READERS[name].read(_traced()) is None
