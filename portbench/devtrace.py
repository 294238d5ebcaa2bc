"""A profiler trace of part of a run's window, reduced to what the
per-layer metrics read.

`Tracer` starts `torch.profiler` (host and device activity) after a
synchronise and stops it after another, around a host span named
`portbench.traced`; the span's length is the traced window. The Chrome
trace is written under the temporary directory, read, and deleted.

- device intervals: every kernel, memcpy and memset; `busy_s` is the
  length of their union inside the window (overlapping kernels count
  once), `window_s` the window's;
- kernels by name, for the roofline readers;
- the idle gaps: the stretches of the window with nothing on the device,
  each named by the innermost host event over its midpoint, summed by
  name.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from typing import Dict, List, Tuple

import torch

SPAN = "portbench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10
NEAR, LONG_US = 512, 1000.0


class Tracer:
    def __init__(self, device: torch.device) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.device = device
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.span = None

    def start(self) -> None:
        torch.cuda.synchronize(self.device)
        self.prof.__enter__()
        self.span = torch.profiler.record_function(SPAN)
        self.span.__enter__()

    def stop(self) -> None:
        torch.cuda.synchronize(self.device)
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def read(self) -> "Trace":
        """The stopped trace, reduced (after the window: it takes
        seconds)."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        return Trace(events)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _innermost(host, starts, long, t: float) -> str:
    """The name of the latest-starting host event that spans `t`: among
    the few hundred events begun last before it, else among the long
    ones."""
    k = bisect.bisect_right(starts, t)
    for s, e, n in reversed(host[max(0, k - NEAR):k]):
        if e >= t:
            return n
    for s, e, n in reversed(long):
        if s <= t <= e:
            return n
    return "host: no traced event"


class Trace:
    """The reduced trace; times in seconds."""

    def __init__(self, events: List[dict]) -> None:
        spans = [e for e in events if e.get("name") == SPAN
                 and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
        if not spans:
            raise RuntimeError("the trace holds no traced-window span")
        a = float(spans[0]["ts"])
        b = a + float(spans[0]["dur"])
        self.window_s = (b - a) * 1e-6
        self.kernels: Dict[str, List[float]] = collections.defaultdict(list)
        device, host = [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            s, d = float(e["ts"]), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                lo, hi = max(s, a), min(s + d, b)
                if hi > lo:
                    device.append((lo, hi))
                    if cat == "kernel":
                        self.kernels[e["name"]].append(d * 1e-6)
            elif cat in HOST_CATS and e.get("name") != SPAN:
                host.append((s, s + d, e["name"]))
        busy = _union(device)
        self.busy_s = sum(hi - lo for lo, hi in busy) * 1e-6
        edges = [a] + [x for iv in busy for x in iv] + [b]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        self.idle: Dict[str, float] = collections.defaultdict(float)
        host.sort()
        starts = [h[0] for h in host]
        long = [h for h in host if h[1] - h[0] > LONG_US]
        for lo, hi in gaps:
            self.idle[_innermost(host, starts, long, (lo + hi) / 2)] += \
                (hi - lo) * 1e-6

    def kernel_times(self, *fragments: str) -> List[float]:
        """Durations of the kernels whose name holds any fragment."""
        return [d for name, ds in self.kernels.items()
                if any(f in name for f in fragments) for d in ds]

    def breakdown(self) -> dict:
        ops = sorted(((n[:160], sum(ds)) for n, ds in self.kernels.items()),
                     key=lambda x: -x[1])[:TOP]
        gaps = sorted(((n[:160], s) for n, s in self.idle.items()),
                      key=lambda x: -x[1])[:TOP]
        return {"device_ops": [list(x) for x in ops],
                "idle_gaps": [list(x) for x in gaps]}
