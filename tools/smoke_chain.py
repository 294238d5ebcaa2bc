#!/usr/bin/env python3
"""`chip_smoke.py`'s multi-step dispatch and FLOPs phases alone (27 and
28), with what they need first: phase 11 (a JPEG tree, its split manifest
and a trained model), and the served leafcnn-base and resnet18 with their
forward ms a 64-batch (as phases 12 and 17 time them).

    python tools/smoke_chain.py [--seed N]

Run from the root of a checkout on a machine with a CUDA card; it runs the
`leaffliction_tpu_torch` and `chip_smoke.py` of the checkout it sits in, so
a copy placed in an older checkout runs that tree's phases. It builds the
kernels, then prints the phases' lines as the smoke prints them (K = 8
graph replays against eager steps, chained and eager ms a step, the train
CLI chained and not, a chained run killed and resumed; the FLOP counts of
`bench.py`'s six train steps and the two forwards, and their MFU) beside
the card's name and power limit. It imports nothing of JAX.
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
    from leaffliction_tpu_torch.predict.predictor import (
        SERVING_BATCH,
        Predictor,
    )

    if not torch.cuda.is_available():
        print("smoke_chain: CUDA is not available", file=sys.stderr)
        return 1
    cs.CARD = cs.nvidia_smi()
    t0 = time.perf_counter()
    build.load()
    cs.log("2 build", seconds=f"{time.perf_counter() - t0:.2f}")
    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory(prefix="smoke_chain_") as tmp:
        tmp = Path(tmp)
        cs.phase_train_cli(tmp, rng, torch.cuda.get_device_name(0))
        served = {}
        for arch in ("leafcnn", "resnet18"):
            learn = tmp / f"served_{arch}"
            cs.write_artifacts(torch, learn, args.seed, arch)
            predictor = Predictor(learn, device=torch.device("cuda")).load()
            x64 = predictor._upload(rng.integers(
                0, 256, (SERVING_BATCH, cs.SIZE, cs.SIZE, 3), dtype=np.uint8))
            served["leafcnn-base" if arch == "leafcnn" else arch] = (
                learn, cs.forward_ms(torch, predictor.model_loader.model,
                                     x64))
        _, step_ms = cs.phase_chain(torch, tmp, args.seed, rng)
        cs.phase_flops(torch, args.seed, rng, step_ms, served)
    return 0


if __name__ == "__main__":
    sys.exit(main())
