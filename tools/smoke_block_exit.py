#!/usr/bin/env python3
"""`chip_smoke.py`'s exit phase alone (31): the residual blocks' exit
kernels of `csrc/block_exit.cu` held against the plain twin at every exit
of the train cells (leafcnn-base b32, resnet18 b128; a mismatch exits
non-zero), then the forward and backward kernels timed at three of those
exits against their bytes bounds, and the twin's eager chain forward and
backward beside the kernels'.

    python tools/smoke_block_exit.py [--seed N]

Run from the root of a checkout on a machine with a CUDA card; it runs the
`leaffliction_tpu_torch` and `chip_smoke.py` of the checkout it sits in. It
builds the kernels, prints the phase's lines as the smoke prints them
beside the card's name and power limit, then one JSON line of the timed
rows. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

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
        print("smoke_block_exit: CUDA is not available", file=sys.stderr)
        return 1
    cs.CARD = cs.nvidia_smi()
    t0 = time.perf_counter()
    build.load()
    cs.log("2 build", seconds=f"{time.perf_counter() - t0:.2f}",
           nvcc_seconds=f"{build.build_seconds:.2f}")
    for line in build.build_log.splitlines():
        if "exit_" in line or "registers" in line:
            cs.log("2 ptxas", info=json.dumps(
                line.split("ptxas info    :")[-1].strip()))
    rows = cs.phase_block_exit(torch, args.seed)
    print(json.dumps({"block_exit": rows, "card": cs.CARD}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
