"""Every name in BENCHMARK.json resolves to its file, and keeps to the
limits on names, keys, units and bounds that `BENCHMARK.json` is held
to."""

from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT, bench
from portbench import harness

BENCH = bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    c = harness.find_cell(cell, BENCH)
    assert NAME.match(cell) and set(c.entry) == {
        "name", "config", "traffic", "chips", "why"}
    assert c.entry["chips"] == 1 and 1 <= len(c.entry["why"]) <= 200
    assert harness.driver(c.traffic["kind"]).run
    assert c.limits, "every cell judges at least one number"
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_files(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["reduced"] == config["reduced"]
    assert config["file"].startswith("portbench/")
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_files(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    reader = harness.load_module(
        ROOT / "portbench" / "metrics" / f"{metric['name']}.py")
    assert callable(reader.read)
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        e2e = {m["name"]: m for m in BENCH["end_to_end"]}
        assert metric["moves"] in e2e
        for cell in metric["workloads"]:
            moved = e2e[metric["moves"]]
            assert cell in moved.get("workloads", CELLS)
