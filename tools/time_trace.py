#!/usr/bin/env python3
"""What a span of the port's tracing (`leaffliction_tpu_torch/core/trace.py`)
costs the host, with no profiler running and with one running.

    python tools/time_trace.py [--spans 100000] [--device cuda]

Times `--spans` empty `with trace.span(...)` blocks three ways, each the
best of 5 rounds on the host clock: an empty loop (the baseline), spans
with no profiler (one flag check each), and spans under `torch.profiler`
(CPU activity, and CUDA activity when `--device` is a card), recorded in
memory and in the profiler. Prints one JSON line: ns a span for each, net
of the baseline, with the card's name and power limit from `nvidia-smi`
where there is one. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "no nvidia-smi"


ROUNDS = 5


def best_ns(fn, n: int) -> float:
    """The fastest of `ROUNDS` runs of `fn(n)`, in ns an iteration."""
    best = float("inf")
    for _ in range(ROUNDS):
        t0 = time.perf_counter_ns()
        fn(n)
        best = min(best, time.perf_counter_ns() - t0)
    return best / n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--spans", type=int, default=100_000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from leaffliction_tpu_torch.core import trace

    def empty(n):
        for _ in range(n):
            pass

    def spans(n):
        span = trace.span
        for _ in range(n):
            with span("trace.cost"):
                pass

    activities = [ProfilerActivity.CPU]
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise SystemExit("time_trace: --device cuda needs a CUDA device")
        activities.append(ProfilerActivity.CUDA)
    base = best_ns(empty, args.spans)
    off = best_ns(spans, args.spans)
    with profile(activities=activities):
        on = best_ns(spans, args.spans)
    recorded = len(trace.spans())
    trace.clear()
    print(json.dumps({
        "spans": args.spans, "rounds": ROUNDS,
        "empty_loop_ns": round(base, 1),
        "off_ns_a_span": round(off - base, 1),
        "on_ns_a_span": round(on - base, 1),
        "recorded_in_the_profiled_rounds": recorded,
        "torch": torch.__version__, "card": card()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
