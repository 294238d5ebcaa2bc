"""Every name in BENCHMARK.json resolves to its file, and keeps to the
limits on names, keys, units and bounds that `BENCHMARK.json` is held
to. The checks (in conftest.py) take the BENCHMARK.json they judge, so
that a test can run them over a copy with a configuration added."""

from __future__ import annotations

import pytest

from conftest import (bench, check_cell_files, check_config_files,
                      check_metric_files, check_top_level)

BENCH = bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    check_top_level(BENCH)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    check_cell_files(BENCH, cell)


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_files(config):
    check_config_files(BENCH, config)


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_files(metric):
    check_metric_files(BENCH, metric)
