"""Shared pieces of the benchmark's CPU tests: the cells they run over,
the checks of BENCHMARK.json's names and files and of each
configuration's frozen values, a copy of the benchmark to change and a
configuration entered into it as new files, cells cut to a size the CPU
runs in seconds (each arch's `TINY`), and whole runs of them with the
look for a card skipped. Each reads the checkout that the harness reads
(`harness.ROOT`), which a test may point at a copy.

The tiny copies run the port in float32, where it agrees with the float32
reference to round-off: a sound run reads far under each of the cell's
limits and a planted fault reads its own size. In bfloat16 a tiny model's
gaps say nothing of the cell's (a tiny ResNet's last BatchNorm sees 8
values a channel); the control at the cell's own size is a `gpu` test.
"""

from __future__ import annotations

import dataclasses
import json
import re
import shutil
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import arch, harness  # noqa: E402
from portbench.tools import freeze  # noqa: E402


def bench() -> dict:
    """BENCHMARK.json of the checkout the harness reads
    (`harness.ROOT`)."""
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


def train_cells() -> list:
    """The names of every cell of BENCHMARK.json whose traffic is of kind
    `train`: the cells the CPU checks of a whole run take."""
    b = bench()
    return [w["name"] for w in b["workloads"]
            if harness.find_cell(w["name"], b).traffic["kind"] == "train"]


def frozen(config: str) -> dict:
    """The frozen values of configuration `config`,
    `frozen/<config>.json` (`tools/freeze.py`)."""
    path = harness.HERE / "frozen" / f"{config}.json"
    if not path.is_file():
        pytest.fail(f"configuration {config!r} has no frozen values: {path} "
                    f"is missing; write it with `python3 {freeze.TOOL} "
                    f"--config {config} > portbench/frozen/{config}.json`",
                    pytrace=False)
    return harness.load_json(path)


def check_frozen(config: dict, keys=None) -> None:
    """The configuration's values, computed now by `tools/freeze.py`, are
    its frozen file's (all of them, or those named in `keys`)."""
    want = frozen(config["name"])
    got = freeze.frozen(harness.load_json(harness.ROOT / config["file"]))
    keys = keys or list(want)
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}


@pytest.fixture
def bench_copy(tmp_path, monkeypatch):
    """A copy of the benchmark (BENCHMARK.json and `portbench/`), which
    the harness and the arch finder read."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setattr(harness, "HERE", tmp_path / "portbench")
    for side, folder in (("program", "archs"),
                         ("reference", "reference/archs")):
        monkeypatch.setitem(arch.FOLDERS, side,
                            tmp_path / "portbench" / folder)
    return tmp_path



def enter(root: Path, config: dict, cell: str, limits: dict, program: str,
          reference: str) -> None:
    """Configuration `config` (its arch named after it, with the two arch
    files' sources `program` and `reference`) and its train cell `cell`,
    on the resident train set, entered into the benchmark copy at `root`
    as new files and appended entries only: its frozen file is written by
    `tools/freeze.py`'s function, and the cell joins every metric that
    lists its cells."""
    here, name = root / "portbench", config["name"]
    assert config["arch"] == name
    (here / "archs" / f"{name}.py").write_text(textwrap.dedent(program))
    (here / "reference" / "archs" / f"{name}.py").write_text(
        textwrap.dedent(reference))
    (here / "configs" / f"{name}.json").write_text(json.dumps(config))
    (here / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    (here / "frozen" / f"{name}.json").write_text(freeze.text(config))
    b = bench()
    b["configs"].append({"name": name, "source": "a CPU test's toy",
                         "file": f"portbench/configs/{name}.json",
                         "reduced": config["reduced"],
                         "why": "a CPU test's toy"})
    b["workloads"].append({"name": cell, "config": name,
                           "traffic": "train_resident", "chips": 1,
                           "why": "the toy on the resident train set"})
    for metric in b["end_to_end"] + b["per_layer"]:
        if "workloads" in metric:
            metric["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(b, indent=1))

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_top_level(bench: dict) -> None:
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def check_cell_files(bench: dict, cell: str) -> None:
    c = harness.find_cell(cell, bench)
    assert NAME.match(cell) and set(c.entry) == {
        "name", "config", "traffic", "chips", "why"}
    assert c.entry["chips"] == 1 and 1 <= len(c.entry["why"]) <= 200
    assert harness.driver(c.traffic["kind"]).run
    assert c.limits, "every cell judges at least one number"
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


def check_config_files(bench: dict, config: dict) -> None:
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    data = json.loads((harness.ROOT / config["file"]).read_text())
    assert data["reduced"] == config["reduced"]
    assert config["file"].startswith("portbench/")
    assert any(w["config"] == config["name"] for w in bench["workloads"])


def check_metric_files(bench: dict, metric: dict) -> None:
    cells = [w["name"] for w in bench["workloads"]]
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    reader = harness.load_module(
        harness.HERE / "metrics" / f"{metric['name']}.py")
    assert callable(reader.read)
    for cell in metric.get("workloads", []):
        assert cell in cells
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        e2e = {m["name"]: m for m in bench["end_to_end"]}
        assert metric["moves"] in e2e
        for cell in metric["workloads"]:
            moved = e2e[metric["moves"]]
            assert cell in moved.get("workloads", cells)


def check_names(bench: dict) -> None:
    """Every check of names and files over one BENCHMARK.json."""
    check_top_level(bench)
    for cell in bench["workloads"]:
        check_cell_files(bench, cell["name"])
    for config in bench["configs"]:
        check_config_files(bench, config)
    for metric in bench["end_to_end"] + bench["per_layer"]:
        check_metric_files(bench, metric)


TINY_TRAFFIC = {"images": 120}


def tiny_size(name: str) -> dict:
    """The configuration's overrides at which the CPU tests run arch
    `name`: `TINY` of its reference file."""
    module = arch.load(name, "reference")
    if not hasattr(module, "TINY"):
        raise ValueError(f"arch {name!r} gives no TINY, the overrides at "
                         f"which the CPU tests run it: add it to "
                         f"{module.__file__}")
    return module.TINY


def tiny_cell(workload: str) -> harness.Cell:
    cell = harness.find_cell(workload, bench())
    config = {**cell.config, **tiny_size(cell.config["arch"])}
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

