"""Spans and counters of the port's trainer and CUDA-graph dispatch.

The port has no JAX counterpart here: XLA's profiler names its own
programs. A span is on exactly when a `torch.profiler` profile is running
(the train CLI's `--profile-dir`, or a caller's own profile); there is no
flag and no environment variable.

- `span(name)`: with no profiler running it costs one call to
  `torch._C._autograd._profiler_enabled()` and returns a shared no-op.
  With one running it enters `torch.profiler.record_function(name)`, so the
  span is a `user_annotation` event of the profiler's Chrome trace, and
  records `Span(name, parent, start_ns, end_ns)` in memory. The times are
  `time.time_ns()`, the clock of the exported trace (an event's `ts` in µs
  × 1000 + the trace's `baseTimeNanoseconds`), so the spans lie on the
  kernels' timeline. `parent` is the index in `spans()` of the span open
  around it on the same thread (-1 for none; each thread has its own
  stack, and the step checkpointer runs on one of its own). A span opened while the profiler ran keeps its true end
  even if the profiler stops before it closes, and a span closes on an
  exception.
- `count(name, n=1)`: always-on counters (an increment costs nothing
  against a dispatch).

The names are the interface (`PERF.md` lists them and what reads each):
`trainer.epoch`, `trainer.dispatch`, `trainer.epoch_end`,
`trainer.evaluate`, `trainer.callback`, `graphs.stage`, `graphs.launch`,
`graphs.capture`; counters `trainer.dispatches`, `trainer.steps`,
`trainer.host_reads`, `graphs.replays`, `graphs.captures` and
`graphs.capture_s` (host seconds of the graphs' warm-ups and captures).

No span goes inside code that a CUDA graph captures: a replay runs the
device work, not the host code around it.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

_profiling = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    parent: int              # index in `spans()`, -1 at the top
    start_ns: int            # time.time_ns()
    end_ns: Optional[int]    # None while the span is open


_lock = threading.Lock()
_records: List[list] = []
_counters: Dict[str, float] = {}
_local = threading.local()


class _Off:
    """The span returned while no profiler runs."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _On:
    __slots__ = ("record", "stack", "function")

    def __init__(self, name: str) -> None:
        self.function = torch.profiler.record_function(name)
        self.record = [name, -1, 0, None]

    def __enter__(self) -> None:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.stack = stack
        with _lock:
            index = len(_records)
            _records.append(self.record)
        self.record[1] = stack[-1] if stack else -1
        stack.append(index)
        # timed around record_function's enter and exit, as its event in
        # the trace is: a first enter runs ≈ 1 ms past the event's start
        self.record[2] = time.time_ns()
        self.function.__enter__()

    def __exit__(self, *exc) -> bool:
        try:
            self.function.__exit__(*exc)
        finally:
            self.record[3] = time.time_ns()
            self.stack.pop()
        return False


def span(name: str):
    """A context manager timing `name` while a profiler runs (module
    docstring); a shared no-op otherwise."""
    if not _profiling():
        return _OFF
    return _On(name)


def count(name: str, n: float = 1) -> None:
    _counters[name] = _counters.get(name, 0) + n


def spans() -> List[Span]:
    """Every span recorded since the last `clear`, in the order they
    opened."""
    with _lock:
        return [Span(*r) for r in _records]


def counters() -> Dict[str, float]:
    return dict(_counters)


def clear() -> None:
    """Forget the spans and counters (a span still open is not recorded
    when it closes)."""
    with _lock:
        _records.clear()
        _counters.clear()
