"""The benchmark's core: find a cell's files by name, run its traffic's
driver, read its metrics, judge its outputs and print the result line.

Everything a cell is made of is found by name from `BENCHMARK.json`:

- the configuration, `file` of its `configs` entry (`configs/<name>.json`);
- the traffic mix, `traffic/<traffic>.json`, whose `kind` names the driver
  (`drivers/<kind>.py`) that sets it up, runs the window and compares its
  outputs with the reference;
- the limits of the numbers compared, `limits/<workload>.json`;
- every metric, `metrics/<name>.py`, a `read(run)` that returns the value
  or None when the run has nothing to read for it.

How a configuration enters, as new files only (an arch already there
needs neither of its two files again):

- `configs/<name>.json`, its sizes as run, whose `arch` names the
  model's two files (`arch.py`), and its entry appended to `configs`;
- `frozen/<name>.json`, the digests of its layout and weights and its
  FLOPs an image, which the CPU tests hold it to (written by
  `tools/freeze.py --config <name>`);
- `archs/<arch>.py`, whose `build(cfg, dtype)` returns the port's model;
- `reference/archs/<arch>.py`, the plain reference's `layout(cfg)` (each
  tensor's name, shape and kind, in the port's state-dict order;
  `weights.py` has a rule for every kind), `forward(cfg, ctx, w, images)`
  (the whole forward, head included), `TINY` (the configuration's
  overrides at which the CPU tests run the arch) and, where the model has
  running statistics, their `BN_MOMENTUM`. A model without running
  statistics gives every number `drivers/train.py` compares but
  `stats_gap` and `stats_median_gap`, and its cells' limits list neither;
- for each cell, an entry of `workloads` and `limits/<cell>.json`, and
  the cell's name appended to the `workloads` list of each metric it
  reports.

The CPU tests take every configuration and every cell of a kind from
BENCHMARK.json, so a new one gets their checks with no edit to them.

No code here names a cell, a configuration, an arch, a mix or a metric.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# modules that no process of the benchmark may hold: JAX and the JAX
# package, compared by the whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "leaffliction_tpu")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    """One entry of `workloads` with its configuration, traffic and
    limits, each read from its own file."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def find_cell(workload: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(entries)}")
    entry = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[entry["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = [m["name"] for m in e2e]
    layer = [m for m in bench["per_layer"] if _reports(m, workload, names)]
    return Cell(workload, entry, config, traffic, limits, e2e, layer)


def load_module(path: Path) -> ModuleType:
    """A module loaded from its file (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(kind: str) -> ModuleType:
    return importlib.import_module(f"portbench.drivers.{kind}")


@dataclasses.dataclass
class Run:
    """One run of a cell: its inputs, and what the driver measured and
    compared. The metric readers read from it."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float                       # process start, host clock
    setup_s: Optional[float] = None
    window_s: Optional[float] = None
    attempted: int = 0
    failed: int = 0
    images: float = 0.0             # images completed in the window
    traced: object = None           # trace.Trace of the traced sub-window
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    compared: Dict[str, Tuple[float, float]] = dataclasses.field(
        default_factory=dict)
    memory_peak_bytes: int = 0

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def compare(self, name: str, value: float) -> None:
        """Record a number judged against the cell's limit of that name."""
        self.compared[name] = (float(value), float(self.cell.limits[name]))

    @property
    def correct(self) -> bool:
        return bool(self.compared) and all(
            v <= lim for v, lim in self.compared.values())


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def read_metrics(run: Run) -> Dict[str, dict]:
    """The cell's end-to-end metrics (untraced run) or per-layer ones
    (traced run), each from its reader; a reader's None leaves it out."""
    wanted = run.cell.per_layer if run.trace else run.cell.end_to_end
    out = {}
    for m in wanted:
        reader = load_module(HERE / "metrics" / f"{m['name']}.py")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(run: Run) -> dict:
    """Run the cell's driver and build the result line."""
    drv = driver(run.traffic["kind"])
    drv.run(run)
    metrics = read_metrics(run)
    result = {
        "correct": run.correct,
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": metrics,
        "device": device_info(run),
    }
    if run.trace and run.traced is not None:
        result["device"]["busy_s"] = run.traced.busy_s
        result["device"]["window_s"] = run.traced.window_s
        result["breakdown"] = run.traced.breakdown()
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in run.compared.items()}
    return result


def device_info(run: Run) -> dict:
    import torch

    info = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(run.device)
                     if run.device.type == "cuda" else "cpu"),
            "count": int(run.cell.entry["chips"]),
            "memory_peak_bytes": int(run.memory_peak_bytes)}
    limit = power_limit_w()
    if limit is not None:
        info["power_limit_w"] = limit
    return info


def power_limit_w() -> Optional[float]:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def sub_seeds(seed: int, n: int) -> List[int]:
    """`n` independent 32-bit seeds from a run's `--seed` (any size)."""
    import numpy as np

    return [int(x) for x in
            np.random.SeedSequence(seed).generate_state(n, np.uint32)]


def now() -> float:
    return time.perf_counter()


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)
