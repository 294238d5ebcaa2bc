#!/usr/bin/env python3
"""`chip_smoke.py`'s streamed train path phase alone (29), with what it
needs first: phase 11 (a JPEG tree, its split manifest, a trained model
and the train CLI's log).

    python tools/smoke_streamed.py [--seed N]

Run from the root of a checkout on a machine with a CUDA card; it runs the
`leaffliction_tpu_torch` and `chip_smoke.py` of the checkout it sits in. It
builds the kernels, then prints the phases' lines as the smoke prints them
(whether keras is importable and what the train CLI wrote for it; 16 steps
streamed and gathered, eager and chained, bit-equal; ms a step of each,
the host-to-device rates and the replays' busy share; the train CLI with
`--no-device-dataset`) beside the card's name and power limit. It imports
nothing of JAX.
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
        print("smoke_streamed: CUDA is not available", file=sys.stderr)
        return 1
    cs.CARD = cs.nvidia_smi()
    t0 = time.perf_counter()
    build.load()
    cs.log("2 build", seconds=f"{time.perf_counter() - t0:.2f}")
    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory(prefix="smoke_streamed_") as tmp:
        tmp = Path(tmp)
        cli11_s = cs.phase_train_cli(tmp, rng, torch.cuda.get_device_name(0))
        cs.phase_streamed(torch, tmp, args.seed, rng, cli11_s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
