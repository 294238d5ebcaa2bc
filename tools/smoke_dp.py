#!/usr/bin/env python3
"""`chip_smoke.py`'s data- and tensor-parallel phases alone (25, 26), with
what they need first: phase 10's one-rank training numbers, phase 11's JPEG
tree and split manifest, phase 14's north-star tree and phase 6's artifact
dir.

    python tools/smoke_dp.py [--seed N]

Run from the root of a checkout on a machine with a CUDA card; it runs the
`leaffliction_tpu_torch` and `chip_smoke.py` of the checkout it sits in, so
a copy placed in an older checkout runs that tree's phases. It builds the
kernels, then prints the phases' lines as the smoke prints them beside the
card's name and power limit: two ranks on cuda:0 over gloo against one
process (f32), the train CLI and `--balance-from` on two ranks with every
kernel call held against its twin, the serving mesh, then tensor
parallelism (four ranks on data 2 x model 2 and two on 1 x 2, against one
process, and the train CLI with `--mesh-model 2`). It imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import torch

    import chip_smoke as cs
    from leaffliction_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print("smoke_dp: CUDA is not available", file=sys.stderr)
        return 1
    cs.CARD = cs.nvidia_smi()
    t0 = time.perf_counter()
    build.load()
    cs.log("2 build", seconds=f"{time.perf_counter() - t0:.2f}")
    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory(prefix="smoke_dp_") as tmp:
        tmp = Path(tmp)
        learn = tmp / "model"
        cs.write_artifacts(torch, learn, args.seed)
        images = rng.integers(0, 256, (4 * 64, cs.SIZE, cs.SIZE, 3),
                              dtype=np.uint8)
        _, train_ms = cs.phase_training(torch, args.seed, rng)
        cs.phase_train_cli(tmp, rng, torch.cuda.get_device_name(0))
        tree = tmp / "fused" / "tree"
        cs.write_north_star_tree(tree, rng)
        launches, _, eq = cs.phase_data_parallel(
            torch, tmp, args.seed, rng, tree, train_ms, learn, images)
        cs.log("25 launches", **launches)
        tp = cs.phase_tensor_parallel(torch, tmp, args.seed, train_ms, eq,
                                      learn, images)
        cs.log("26 launches", **tp)
    print(f"nvidia-smi: {cs.nvidia_smi()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
