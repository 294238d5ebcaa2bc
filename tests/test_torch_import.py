"""The PyTorch port stands alone: every module of `leaffliction_tpu_torch` is
imported in a fresh interpreter (this process already holds jax, through
conftest), and neither `jax`, `flax` nor the JAX package `leaffliction_tpu`
may appear in `sys.modules`. No source of the port, nor `chip_smoke.py`,
the port's timing tools or the data-parallel test worker (a process of its
own), names one of them in an import."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "leaffliction_tpu")

_LEAKED = (f"sorted(m for m in sys.modules "
           f"if m.split('.')[0] in {FORBIDDEN!r})")

_PROBE = f"""
import importlib, json, pkgutil, sys
import leaffliction_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(json.dumps({{"modules": names, "leaked": {_LEAKED}}}))
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
                 "data.fused_balance", "models.resnet", "data.balancer",
                 "data.host_augment", "cli.augment", "cli.balance_dataset",
                 "cli.distribution", "cli.split", "cli.transform",
                 "ops.kmeans", "ops.clahe", "segment.config",
                 "segment.contours", "segment.grabcut", "segment.blur",
                 "segment.brown", "segment.roi", "segment.analyze",
                 "segment.landmarks", "segment.hist", "utils.draw",
                 "ops.geometry", "utils.mask_utils", "utils.signature",
                 "train.checkpoint", "parallel.distributed",
                 "parallel.mesh", "parallel.tensor", "train.flops",
                 "train.keras_export"):
        assert f"leaffliction_tpu_torch.{name}" in result["modules"]
    assert result["leaked"] == []


# each host module of the JAX package that the port keeps a copy of, and
# the copy
REUSED = {"leaffliction_tpu.train.config": "train.config",
          "leaffliction_tpu.data.loader": "data.loader",
          "leaffliction_tpu.data.manifest": "data.manifest",
          "leaffliction_tpu.data.split": "data.split",
          "leaffliction_tpu.data.scan": "data.scan",
          "leaffliction_tpu.core.sysinfo": "core.sysinfo",
          "leaffliction_tpu.core.logging": "core.logging",
          "leaffliction_tpu.utils.confusion": "utils.confusion",
          "leaffliction_tpu.utils.metrics": "utils.metrics",
          "leaffliction_tpu.data.fused_balance": "data.fused_balance",
          "leaffliction_tpu.data.balancer": "data.balancer",
          "leaffliction_tpu.data.native": "data.native",
          "leaffliction_tpu.cli.split": "cli.split",
          "leaffliction_tpu.cli.distribution": "cli.distribution",
          "leaffliction_tpu.data.host_augment": "data.host_augment",
          "leaffliction_tpu.utils.image_io": "utils.image_io",
          "leaffliction_tpu.utils.viz": "utils.viz",
          "leaffliction_tpu.predict.visualizer": "predict.visualizer",
          "leaffliction_tpu.cli.predict": "cli.predict",
          "leaffliction_tpu.segment.config": "segment.config",
          "leaffliction_tpu.segment.contours": "segment.contours",
          "leaffliction_tpu.utils.draw": "utils.draw",
          "leaffliction_tpu.utils.signature": "utils.signature",
          "leaffliction_tpu.utils.mask_utils": "utils.mask_utils",
          "leaffliction_tpu.ops.geometry": "ops.geometry"}


@pytest.mark.parametrize("module", REUSED)
def test_reused_host_modules_import_no_jax(module):
    """The port's copy of `module` loads neither jax, flax nor the JAX
    package."""
    probe = (f"import importlib, sys; importlib.import_module("
             f"'leaffliction_tpu_torch.{REUSED[module]}'); print({_LEAKED})")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imported_tops(path: Path):
    """(line, top-level package) of every import statement, lazy ones too."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


SOURCES = sorted((ROOT / "leaffliction_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + [
    ROOT / "tools" / name for name in (
        "profile_torch_serving.py", "profile_torch_transform.py",
        "time_distortion.py", "time_strict_balance.py",
        "smoke_resume.py", "smoke_dp.py", "smoke_chain.py",
        "time_chain.py", "smoke_streamed.py", "time_streamed.py",
        "time_trace.py", "smoke_batch_norm.py")] + [
    ROOT / "tests" / "torch_dp_worker.py"]


def test_port_sources_name_no_jax():
    """No `import`/`from` of jax, flax or leaffliction_tpu in the port's
    sources, the smoke or the port's timing tools (lazy imports too)."""
    assert len(SOURCES) > 40
    bad = [f"{p.relative_to(ROOT)}:{line}: {top}" for p in SOURCES
           for line, top in _imported_tops(p) if top in FORBIDDEN]
    assert bad == []


def test_import_check_catches_the_jax_package(tmp_path):
    src = tmp_path / "probe.py"
    src.write_text("import leaffliction_tpu_torch.ops\n"
                   "def f():\n    from leaffliction_tpu.data import scan\n"
                   "    import jax.numpy as jnp\n")
    assert [top for _, top in _imported_tops(src)] == [
        "leaffliction_tpu_torch", "leaffliction_tpu", "jax"]


def _reexports(init: Path):
    """{module: names} of an `__init__.py`'s `from ... import` lines, read
    from its source (nothing imported)."""
    return {node.module.rsplit(".", 1)[-1]: sorted(a.name for a in node.names)
            for node in ast.parse(init.read_text()).body
            if isinstance(node, ast.ImportFrom)}


@pytest.mark.parametrize("package", ["ops", "data", "models"])
def test_package_surface_matches_the_jax_package(package):
    """`leaffliction_tpu_torch.<package>` re-exports the names the JAX
    package's `<package>/__init__.py` does, each the port module's own
    object, and importing the package builds or loads no kernel."""
    want = _reexports(ROOT / "leaffliction_tpu" / package / "__init__.py")
    assert want and want == _reexports(
        ROOT / "leaffliction_tpu_torch" / package / "__init__.py")
    probe = f"""
import importlib, json, sys
pkg = importlib.import_module("leaffliction_tpu_torch.{package}")
same = {{f"{{m}}.{{n}}": getattr(pkg, n) is getattr(importlib.import_module(
    f"leaffliction_tpu_torch.{package}.{{m}}"), n)
    for m, names in {want!r}.items() for n in names}}
print(json.dumps({{"same": same, "kernels": sorted(
    m for m in sys.modules if m.startswith("leaffliction_tpu_torch.kernels")
    or m.startswith("leaffliction_tpu_torch.ops.kernels"))}}))
"""
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["same"] and all(result["same"].values()), result["same"]
    assert result["kernels"] == []
