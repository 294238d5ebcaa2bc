"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds `leaffliction_tpu_torch`. The run
makes its inputs and weights from the seed, sets up and warms the cell's
shapes, measures for `--seconds`, judges what the timed path produced
against the plain reference (`portbench/reference/`), and prints one JSON
object as the last line of standard output (the numbers compared, with
their limits, are also the last lines of standard error). With
`--trace 1` it reads the per-layer metrics from a profiler trace of part
of the window instead of the end-to-end ones.

It needs the CUDA cards the cell asks for and exits non-zero without them;
it also exits non-zero if JAX, flax or the JAX package were loaded. Build
and kernel caches stay in `build/` inside the checkout.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the script's own folder is not a package root: its modules are imported
# as `portbench.*` from the checkout's root
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != Path(__file__).resolve().parent]
CACHE = ROOT / "build" / "portbench"


def _fixed_caches() -> None:
    """Kernel and build caches at fixed paths inside the checkout, so only
    a checkout's first run builds and compiles."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    _fixed_caches()
    from portbench import harness

    cell = harness.find_cell(args.workload)
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from leaffliction_tpu_torch.core.device import resolve_device

    run = harness.Run(cell, args.seed, args.seconds, bool(args.trace),
                      resolve_device("cuda"), T0)
    result = harness.execute(run)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
