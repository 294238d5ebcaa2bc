"""The JAX package's JPEG helper as the port's tests reach it: built under a
lock, moved into place whole, and loaded from there.

The JAX package compiles `leaffliction_tpu/data/native/libleafjpeg.so`
beside its source at first use (`build.sh` runs `g++ -o` on that path). A
process that dlopens the file while another one writes it finds it too
short, and then decodes through PIL for the rest of its life while the
port decodes through libjpeg, or dies of SIGBUS. `ready(build_dir)` keeps
the JAX side of a port test off that path:

- under an `fcntl.flock` on `build_dir/jax.lock` it compiles the JAX
  package's own `decoder.cpp` with its `build.sh` flags to a temporary
  name and moves it (`os.replace`) to `build_dir/jax/libleafjpeg.so`, only
  when that file is missing or older than the source, so the file at that
  path is always whole;
- it points the JAX module's `_LIB_PATH` there, and, unless the module
  already loaded a library in this process, clears its `_lib` and
  `_load_failed`, so the JAX package's unchanged `_load()` opens that file;
- without g++ or libjpeg both sides decode through PIL, as they would
  anyway. If one side has the helper and the other not, it raises, naming
  both.

Call it from a module-scoped fixture of a test file whose JAX side decodes
JPEGs in-process, not at import: collection imports every test module in
every worker.
"""

import fcntl
import os
import subprocess
from pathlib import Path

from leaffliction_tpu.data import native as jnative
from leaffliction_tpu_torch.data import native as tnative

BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]  # the JAX build.sh's


def library(build_dir=BUILD_DIR) -> Path:
    """Where `ready(build_dir)` puts the JAX package's helper."""
    return Path(build_dir) / "jax" / "libleafjpeg.so"


def _build(src: Path, out: Path) -> None:
    tmp = out.with_name(f"{out.name}.{os.getpid()}")
    try:
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(src), "-ljpeg"],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def ready(build_dir=BUILD_DIR) -> bool:
    """Load the JAX package's JPEG helper from `library(build_dir)`,
    building it there first if needed; → whether both packages decode
    through libjpeg (False: both through PIL). Raises if only one does."""
    src = jnative._DIR / "decoder.cpp"
    out = library(build_dir)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(Path(build_dir) / "jax.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists() or out.stat().st_mtime < src.stat().st_mtime:
            try:
                _build(src, out)
            except (OSError, subprocess.SubprocessError):
                pass  # no g++ or no libjpeg: PIL decodes
    if jnative._lib is None:
        jnative._LIB_PATH = out
        # without the file `_load` would build in place: PIL instead
        jnative._load_failed = not out.exists()
    jax_side, port_side = jnative.native_available(), \
        tnative.native_available()
    if jax_side != port_side:
        def said(ok):
            return "libjpeg" if ok else "PIL"

        raise RuntimeError(
            f"the JAX package decodes through {said(jax_side)} "
            f"({jnative._LIB_PATH}), the port through {said(port_side)} "
            f"({tnative.LIB_PATH}): a comparison of the two is meaningless")
    return jax_side
