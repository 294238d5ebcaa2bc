"""The port's own spans and counters (`leaffliction_tpu_torch/core/trace.py`),
read after a run for the per-layer metrics.

The port records a span only while a profiler runs, so in a traced run its
spans cover the traced window (`devtrace.Tracer`) and nothing else; its
counters count from the process's start. A port without the module gives
nothing: every function here returns None, and the metric is left out of
the result line.
"""

from __future__ import annotations

from typing import Optional


def _trace():
    try:
        from leaffliction_tpu_torch.core import trace
    except ImportError:
        return None
    return trace


def seconds(name: str) -> Optional[float]:
    """The summed length of the closed spans named `name`, or None when
    none was recorded."""
    trace = _trace()
    if trace is None:
        return None
    got = [s.end_ns - s.start_ns for s in trace.spans()
           if s.name == name and s.end_ns is not None]
    return sum(got) * 1e-9 if got else None


def counter(name: str) -> Optional[float]:
    trace = _trace()
    return None if trace is None else trace.counters().get(name)


def window_share(run, name: str) -> Optional[float]:
    """The spans named `name` as a share (%) of the traced window; None for
    an untraced run or one that recorded no such span."""
    t = run.traced
    if t is None or t.window_s <= 0:
        return None
    s = seconds(name)
    return None if s is None else 100.0 * s / t.window_s
