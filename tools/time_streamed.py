#!/usr/bin/env python3
"""The train step on the streamed path against the gather path, through
`fit`: leafcnn-base 224 px b32 bf16 REGULARIZED (random weights), the
uint8 train set either uploaded a batch at a time (`device_dataset=False`,
what `--no-device-dataset`, a set of 6e9 bytes or more and every mesh
run) or kept on the card (`device_dataset=True`), chained (K = 8 steps a
CUDA graph replay) and eager (K = 1), in the order gather, streamed,
streamed, gather for each K.

    python tools/time_streamed.py [--seed N] [--steps N] [--epochs N]

`fit` records a CUDA event after each dispatch (its `step_callback`); the
ms a step of a dispatch is the interval between two consecutive events of
one epoch over its steps, so it holds the card's waits for the uploads and
for the host as well as its work. The set has `--steps` batches an epoch
of random pixels (the time does not depend on them) and a 64-image val
set. Run from the root of a checkout on a machine with a CUDA card; it
runs the `leaffliction_tpu_torch` and `chip_smoke.py` of the checkout it
sits in, so a copy placed in an older checkout times that tree. It prints
its lines as `chip_smoke.py` does, beside the card's name and power limit,
and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def store_of(rng, n: int, size: int, classes: int):
    """A `DeviceImageStore` of `n` random images that keeps its pixels on
    the host too, so either path can read them."""
    from leaffliction_tpu_torch.data.loader import DeviceImageStore

    store = DeviceImageStore(rng.integers(0, classes, n), size)
    store.images = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    store.host_pixels = True
    return store


def timed_fit(torch, cs, train, val, seed: int, epochs: int, k: int,
              streamed: bool) -> dict:
    """One `fit` from a fresh state → the ms a step of every dispatch
    interval inside an epoch (sorted), the steps and the train seconds."""
    from leaffliction_tpu_torch.data.loader import BatchIterator
    from leaffliction_tpu_torch.train.trainer import fit

    data = torch.from_numpy(train.images[:2048]).cuda()
    state, fns, _ = cs.chain_setup(torch, "leafcnn-base", "regularized",
                                   seed, data)
    del data
    ends = []

    def mark(epoch, step_in_epoch, st, generator):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        ends.append((epoch, step_in_epoch, event))

    res = fit(fns, state,
              BatchIterator(train, cs.TRAIN_BATCH, shuffle=True, seed=seed),
              BatchIterator(val, cs.TRAIN_BATCH, shuffle=False), fns.cfg,
              epochs=epochs, seed=seed, device_dataset=not streamed,
              chain_steps=k, step_callback=mark)
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) / (sb - sa)
                for (ea, sa, a), (eb, sb, b) in zip(ends, ends[1:])
                if ea == eb)
    return {"ms": ms, "steps": res.steps_ran, "train_s": res.train_time_s}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=48,
                   help="batches of 32 an epoch")
    p.add_argument("--epochs", type=int, default=2)
    args = p.parse_args()

    import torch

    import chip_smoke as cs
    from leaffliction_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print("time_streamed: CUDA is not available", file=sys.stderr)
        return 1
    cs.CARD = cs.nvidia_smi()
    t0 = time.perf_counter()
    build.load()
    cs.log("build", seconds=f"{time.perf_counter() - t0:.2f}")
    rng = np.random.default_rng(args.seed)
    train = store_of(rng, args.steps * cs.TRAIN_BATCH, cs.SIZE, cs.CLASSES)
    val = store_of(rng, 64, cs.SIZE, cs.CLASSES)
    out = {}
    for k in (8, 1):
        for streamed in (False, True, True, False):
            name = f"{'streamed' if streamed else 'gather'}_k{k}"
            r = timed_fit(torch, cs, train, val, args.seed, args.epochs, k,
                          streamed)
            out.setdefault(name, []).append(r)
            ms = r["ms"]
            cs.log("streamed step", path=name, k=k, batch=cs.TRAIN_BATCH,
                   img=cs.SIZE, model="leafcnn-base", dtype="bf16",
                   steps=r["steps"], intervals=len(ms),
                   ms_per_step_median=f"{np.median(ms):.3f}",
                   ms_min=f"{ms[0]:.3f}", ms_max=f"{ms[-1]:.3f}",
                   train_s=f"{r['train_s']:.3f}",
                   tree=str(REPO.name))
    summary = {name: float(np.median([m for r in runs for m in r["ms"]]))
               for name, runs in out.items()}
    cs.log("streamed summary", ms_per_step_median=json.dumps(
        {k: round(v, 3) for k, v in summary.items()}), tree=str(REPO.name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
