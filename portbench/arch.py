"""Find a configuration's architecture by its name, `arch` in the
configuration's file. An architecture is two files of that name:

- `archs/<arch>.py`, the port's side: `build(cfg, dtype)` returns the
  port's model (a `torch.nn.Module` whose state-dict keys and order are
  the reference's `layout`), which `program.model` fills with the
  benchmark's weights;
- `reference/archs/<arch>.py`, the plain reference, which imports nothing
  of the port: `layout(cfg)` yields every tensor's (name, shape, kind) in
  the port's state-dict order; `forward(cfg, ctx, w, images)` is the whole
  float32 forward, head included; `BN_MOMENTUM`, the running statistics'
  momentum, only where the model has running statistics (tensors of kind
  `mean` and `var`); `TINY`, the configuration's overrides at which the
  benchmark's CPU tests run the arch.

An arch with either file missing fails, naming both files; nothing falls
back to another model.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Dict

HERE = Path(__file__).resolve().parent
FOLDERS: Dict[str, Path] = {"program": HERE / "archs",
                            "reference": HERE / "reference" / "archs"}


@functools.lru_cache(maxsize=None)
def _module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        f"portbench_arch_{path.parent.parent.name}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load(name: str, side: str) -> ModuleType:
    """The module of arch `name` on `side` ("program" or "reference")."""
    files = {s: folder / f"{name}.py" for s, folder in FOLDERS.items()}
    missing = [str(f) for f in files.values() if not f.is_file()]
    if missing:
        raise ValueError(f"unknown arch {name!r}: looked for "
                         + " and ".join(str(f) for f in files.values())
                         + "; missing " + " and ".join(missing))
    return _module(files[side])
