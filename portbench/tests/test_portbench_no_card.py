"""Without a card, or without the port beside it, a run fails and prints
no result rather than fall back."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT


def _run(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "train-leafcnn_base-b32", "--seed", str(2 ** 31 + 5), "--seconds",
         "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_no_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert "{" not in out.stdout
