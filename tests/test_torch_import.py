"""The PyTorch port imports no JAX: every module of `leaffliction_tpu_torch`
is imported in a fresh interpreter (this process already holds jax, through
conftest), and neither `jax` nor `flax` may appear in `sys.modules`."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, json, pkgutil, sys
import leaffliction_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"modules": names,
                  "leaked": sorted(m for m in sys.modules
                                   if m.split(".")[0] in ("jax", "flax"))}))
"""


def test_port_modules_import_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert "leaffliction_tpu_torch.cli.predict" in result["modules"]
    for name in ("ops.kernels.components", "ops.kernels.rotate",
                 "ops.train_augment", "ops.image", "train.steps",
                 "train.trainer", "train.artifacts", "cli.train",
                 "core.sysinfo", "train.config", "data.manifest",
                 "ops.resample", "ops.photometric", "ops.augment",
                 "ops.kernels.warp", "ops.kernels.distortion",
                 "data.fused_balance"):
        assert f"leaffliction_tpu_torch.{name}" in result["modules"]
    assert result["leaked"] == []


# the JAX package's host modules the port reuses as they are
REUSED = ["leaffliction_tpu.train.config", "leaffliction_tpu.data.loader",
          "leaffliction_tpu.data.manifest", "leaffliction_tpu.data.split",
          "leaffliction_tpu.data.scan", "leaffliction_tpu.core.sysinfo",
          "leaffliction_tpu.core.logging", "leaffliction_tpu.utils.confusion",
          "leaffliction_tpu.utils.metrics",
          # the fused balance slice
          "leaffliction_tpu.data.fused_balance",
          "leaffliction_tpu.data.balancer", "leaffliction_tpu.data.native",
          "leaffliction_tpu.cli.split", "leaffliction_tpu.utils.image_io"]


@pytest.mark.parametrize("module", REUSED)
def test_reused_host_modules_import_no_jax(module):
    probe = (f"import importlib, sys; importlib.import_module({module!r}); "
             "print(sorted(m for m in sys.modules "
             "if m.split('.')[0] in ('jax', 'flax')))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_port_sources_name_no_jax():
    """No `import jax` / `flax` in the port's sources (lazy imports too)."""
    for path in (ROOT / "leaffliction_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.strip().split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "flax"), f"{path}: {line}"
