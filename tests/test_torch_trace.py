"""The port's spans and counters (`leaffliction_tpu_torch/core/trace.py`),
on the CPU:

- with no profiler running a span records nothing and returns one shared
  no-op; counters count regardless;
- under `torch.profiler` a tiny `fit` (chain_steps 1 and 3) records the
  trainer's tree: each epoch over its dispatches (one a chunk, one a
  remainder batch), callbacks, epoch-end read and evaluation, then the
  final base and EMA evaluations at the top; `trainer.steps` counts the
  steps run;
- each recorded span is its `user_annotation` event of the exported
  Chrome trace on the trace's clock (`ts` × 1000 +
  `baseTimeNanoseconds`): the event lies inside the span, to the trace's
  1 µs rounding, and the median gap of the starts and of the durations is
  under 1 ms (a single span's gap grows with the host's load);
- a span closes on an exception; a span open when the profiler stops
  keeps its true end; each thread has its own stack.

The graph spans and counters run on the card only (`tests/test_torch_gpu.py`).
"""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from leaffliction_tpu_torch.core import trace  # noqa: E402
from leaffliction_tpu_torch.data.loader import (  # noqa: E402
    BatchIterator,
    DeviceImageStore,
)
from leaffliction_tpu_torch.models.leafcnn import (  # noqa: E402
    LeafCNN,
    init_model,
)
from leaffliction_tpu_torch.train import steps  # noqa: E402
from leaffliction_tpu_torch.train.config import TrainConfig  # noqa: E402
from leaffliction_tpu_torch.train.trainer import fit  # noqa: E402

K_CLASSES, S, B, N_TRAIN, EPOCHS = 5, 32, 4, 18, 2
TRAINER = ("trainer.epoch", "trainer.dispatch", "trainer.epoch_end",
           "trainer.evaluate", "trainer.callback")


@pytest.fixture(autouse=True)
def fresh():
    trace.clear()
    yield
    trace.clear()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _tiny_fit(chain_steps):
    """A tiny LeafCNN through `fit` for 2 epochs of 5 steps (streamed
    batches of 4, the last padded), with a step and an epoch callback;
    REGULARIZED, so the run ends with the base and the EMA evaluations."""
    rng = np.random.default_rng(4)
    stores = []
    for n in (N_TRAIN, 6):
        store = DeviceImageStore(rng.integers(0, K_CLASSES, n), S)
        store.images = rng.integers(0, 256, (n, S, S, 3), np.uint8)
        store.host_pixels = True
        stores.append(store)
    cfg = dataclasses.replace(TrainConfig.regularized(), plateau_patience=9,
                              early_stop_patience=9)
    state = steps.train_state_for(init_model(LeafCNN(K_CLASSES, (8, 16)), 2))
    return fit(steps.build_step_fns(cfg, K_CLASSES, 10), state,
               BatchIterator(stores[0], B, shuffle=True, seed=1),
               BatchIterator(stores[1], B, shuffle=False), cfg,
               epochs=EPOCHS, seed=6, log_every=0, chain_steps=chain_steps,
               step_callback=lambda *a: None,
               epoch_callback=lambda *a: None)


def test_no_profiler_records_nothing_and_counts():
    assert trace.span("a") is trace.span("b")
    with trace.span("trainer.epoch"):
        trace.count("x")
        trace.count("x", 2)
        trace.count("s", 0.25)
    assert trace.spans() == []
    assert trace.counters() == {"x": 3, "s": 0.25}
    trace.clear()
    assert trace.counters() == {}


@pytest.mark.parametrize("k", [1, 3])
def test_fit_records_the_trainer_tree(k, tmp_path):
    with _profiled() as prof:
        result = _tiny_fit(k)
    steps_an_epoch = -(-N_TRAIN // B)
    dispatches = (steps_an_epoch if k == 1
                  else steps_an_epoch // k + steps_an_epoch % k)
    got = trace.spans()
    assert {s.name for s in got} == set(TRAINER)
    assert all(s.end_ns >= s.start_ns for s in got)
    epochs = [i for i, s in enumerate(got) if s.name == "trainer.epoch"]
    assert len(epochs) == EPOCHS
    assert all(got[i].parent == -1 for i in epochs)
    for i in epochs:
        kids = [s.name for s in got if s.parent == i]
        assert kids.count("trainer.dispatch") == dispatches
        assert kids.count("trainer.callback") == dispatches + 1
        assert kids.count("trainer.epoch_end") == 1
        assert kids.count("trainer.evaluate") == 1
        assert len(kids) == 2 * dispatches + 3
    # the final base and EMA evaluations, after the epochs
    assert [s.name for s in got if s.parent == -1] == \
        ["trainer.epoch"] * EPOCHS + ["trainer.evaluate"] * 2
    assert all(s.parent < i for i, s in enumerate(got))
    counted = trace.counters()
    assert counted["trainer.steps"] == result.steps_ran == \
        EPOCHS * steps_an_epoch
    assert counted["trainer.dispatches"] == EPOCHS * dispatches
    # each epoch's metrics read and each of 4 evaluations' sums
    assert counted["trainer.host_reads"] == EPOCHS + EPOCHS + 2
    assert not any(n.startswith("graphs.") for n in counted)

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    exported = json.loads(path.read_text())
    base = exported["baseTimeNanoseconds"]
    events = sorted((e for e in exported["traceEvents"]
                     if e.get("cat") == "user_annotation"
                     and e.get("name") in TRAINER), key=lambda e: e["ts"])
    assert len(events) == len(got)
    start_gaps, dur_gaps = [], []
    for s, e in zip(sorted(got, key=lambda s: s.start_ns), events):
        assert e["name"] == s.name
        start, dur = e["ts"] * 1e3 + base, e["dur"] * 1e3
        # the span is timed around record_function's enter and exit: its
        # event lies inside it, to the trace's 1 µs rounding
        assert s.start_ns - 1e3 <= start and start + dur <= s.end_ns + 1e3
        start_gaps.append(start - s.start_ns)
        dur_gaps.append(s.end_ns - s.start_ns - dur)
    assert np.median(start_gaps) < 1e6 and np.median(dur_gaps) < 1e6


def test_exception_closes_the_span():
    with _profiled():
        with pytest.raises(ValueError):
            with trace.span("outer"):
                with trace.span("inner"):
                    raise ValueError("from inside")
        with trace.span("after"):
            pass
    got = trace.spans()
    assert [(s.name, s.parent) for s in got] == \
        [("outer", -1), ("inner", 0), ("after", -1)]
    assert all(s.end_ns is not None for s in got)


def test_span_keeps_its_true_end_after_the_profiler_stops():
    prof = _profiled()
    prof.__enter__()
    try:
        opened = trace.span("open")
        opened.__enter__()
    finally:
        prof.__exit__(None, None, None)
    time.sleep(0.02)
    with trace.span("after the profiler"):
        pass
    opened.__exit__(None, None, None)
    [s] = trace.spans()
    assert s.name == "open" and s.end_ns - s.start_ns >= 20_000_000


def test_each_thread_has_its_own_stack(monkeypatch):
    """A span opened on another thread while one is open here is a root
    (the profiler's own switch is per thread, so it is held on here)."""
    monkeypatch.setattr(trace, "_profiling", lambda: True)

    def worker():
        with trace.span("worker"):
            pass

    with trace.span("main"):
        thread = threading.Thread(target=worker)
        thread.start()
        thread.join(timeout=60)
        assert not thread.is_alive()
        with trace.span("child"):
            pass
    got = trace.spans()
    assert [(s.name, s.parent) for s in got] == \
        [("main", -1), ("worker", -1), ("child", 0)]
