"""Nothing the benchmark runs imports JAX, flax or the JAX package, by the
whole top-level name; the reference imports nothing of the port either."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from conftest import ROOT, train_cells

FORBIDDEN = {"jax", "jaxlib", "flax", "leaffliction_tpu"}
SOURCES = sorted(p for p in (ROOT / "portbench").rglob("*.py")
                 if "tests" not in p.parts)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_sources(path):
    names = set(_imports(path))
    assert not names & FORBIDDEN
    if "reference" in path.parts:
        assert "leaffliction_tpu_torch" not in names


@pytest.mark.parametrize("cell", train_cells())
def test_a_run_loads_none(cell):
    """A whole tiny run in a fresh interpreter leaves no such module in
    `sys.modules` (a scan of sources cannot see what the port loads)."""
    code = ("import sys; sys.path.insert(0, 'portbench/tests'); "
            "import conftest; "
            f"r = conftest.cpu_run({cell!r}); "
            "from portbench import harness; "
            "print('LOADED', harness.forbidden_modules(), r['correct'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED [] True" in out.stdout
