"""Shared pieces of the benchmark's CPU tests: cells cut to a size the CPU
runs in seconds, and whole runs of them with the look for a card skipped.

The tiny copies run the port in float32, where it agrees with the float32
reference to round-off: a sound run reads far under each of the cell's
limits and a planted fault reads its own size. In bfloat16 a tiny model's
gaps say nothing of the cell's (a tiny ResNet's last BatchNorm sees 8
values a channel); the control at the cell's own size is a `gpu` test.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def bench() -> dict:
    return harness.load_json(ROOT / "BENCHMARK.json")


TINY = {
    "leafcnn": {"widths": [8, 16], "img_size": 32, "batch_size": 8,
                "compute_dtype": "float32"},
    "resnet": {"widths": [8, 16, 16, 16], "blocks": [1, 1, 1, 1],
               "img_size": 32, "batch_size": 8, "compute_dtype": "float32"},
}
TINY_TRAFFIC = {"images": 120}


def tiny_cell(workload: str) -> harness.Cell:
    cell = harness.find_cell(workload, bench())
    config = {**cell.config, **TINY[cell.config["arch"]]}
    traffic = {**cell.traffic, **TINY_TRAFFIC}
    return dataclasses.replace(cell, config=config, traffic=traffic)


def tiny_run(workload: str, seed: int = 2 ** 31 + 7, seconds: float = 0.2,
             **config) -> harness.Run:
    """A run of a tiny copy of the cell on the CPU (`config` changes its
    configuration)."""
    cell = tiny_cell(workload)
    cell = dataclasses.replace(cell, config={**cell.config, **config})
    return harness.Run(cell, seed, seconds, False, torch.device("cpu"),
                       time.perf_counter())


def cpu_run(workload: str, seed: int = 2 ** 31 + 7,
            seconds: float = 0.2) -> dict:
    """A whole run of a tiny copy of the cell on the CPU: the result line
    (the look for a card skipped)."""
    return harness.execute(tiny_run(workload, seed, seconds))

