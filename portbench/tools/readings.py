"""Read a cell's numbers over many seeds in one process: for each seed one
run of the cell (set-up and a window of one epoch), and every number the
comparison can judge, for the port and for the control and the planted
fault put in its place (`drivers/<kind>.readings`), from which the cell's
limits are set.

    python3 portbench/tools/readings.py --workload <name> --seeds 1 2 3 ...

One JSON line a seed. Needs the card, as a run does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != Path(__file__).resolve().parent]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=0.0,
                   help="the window (default: one epoch)")
    p.add_argument("--detail", action="store_true",
                   help="also print the widest leaves and each epoch's "
                        "evaluation")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    from portbench.run import _fixed_caches

    _fixed_caches()
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    from leaffliction_tpu_torch.core.device import resolve_device

    cell = harness.find_cell(args.workload)
    device = resolve_device("cuda")
    drv = harness.driver(cell.traffic["kind"])
    for seed in args.seeds:
        t = time.perf_counter()
        run = harness.Run(cell, seed, args.seconds, False, device, t)
        out = drv.readings(run, args.detail)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "numbers": out, "setup_s": run.setup_s,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
