"""The port's ctypes bindings against its CUDA sources, on the CPU.

`kernels/build.py` declares every C entry point's argument types by hand;
a count that differs from the source's parameters would pass garbage on the
card. Each launching entry point takes the tensors' device index and the
stream last, and the wrappers use that convention alone (no
`torch.cuda.device` context, no Stream object per call).
"""

import ast
import ctypes
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from leaffliction_tpu_torch.kernels import build  # noqa: E402

KERNELS = Path(build.__file__).resolve().parent.parent / "ops" / "kernels"
ENTRY = re.compile(r'extern "C" int (leaf_\w+)\(([^)]*)\)', re.S)


def _entry_points():
    found = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        for name, params in ENTRY.findall(src.read_text()):
            found[name] = [p.split()[-1].lstrip("*")
                           for p in params.split(",") if p.strip()]
    return found


def test_signatures_match_the_sources():
    found = _entry_points()
    assert set(found) == set(build.SIGNATURES)
    for name, params in found.items():
        assert len(params) == len(build.SIGNATURES[name]), name


@pytest.mark.parametrize("name", sorted(
    n for n, params in _entry_points().items() if "stream" in params))
def test_launching_entry_points_take_device_then_stream(name):
    params = _entry_points()[name]
    assert params[-2:] == ["device", "stream"], params
    assert build.SIGNATURES[name][-2:] == [ctypes.c_int, ctypes.c_void_p]


@pytest.mark.parametrize("module", sorted(
    p.name for p in KERNELS.glob("*.py") if p.name != "__init__.py"))
def test_wrappers_take_the_raw_stream_and_no_device_context(module):
    tree = ast.parse((KERNELS / module).read_text())
    calls = {ast.unparse(node.func) for node in ast.walk(tree)
             if isinstance(node, ast.Call)}
    assert not calls & {"torch.cuda.device", "torch.cuda.current_stream"}
    if any(c.startswith("lib.leaf_") or ".leaf_" in c for c in calls):
        assert "build.current_stream" in calls
