#!/usr/bin/env python3
"""Times of kernel K6 (opt-in distortion) at chosen image counts.

    python tools/time_distortion.py [N ...]     (default: 16 64)

Run from the root of a checkout on a machine with a CUDA card; it times the
`leaffliction_tpu_torch` of the checkout it sits in, so a copy placed in an
older checkout times that tree's K6. For each N it makes N leaf-like 224²
images (`chip_smoke.leafish_image`), seeds and cutoffs from seed N, holds
the wrapper's output exact against `distortion_plain`, and prints one line
of JSON: kernel-only device time a call (torch.profiler, 50 calls), the
wrapper's time a call (CUDA events over 50 back-to-back calls), the twin's,
a sha256 of the output, and the card's name and power limit (`nvidia-smi`).
It imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    import torch

    import chip_smoke
    from leaffliction_tpu_torch.ops.kernels.distortion import (
        distortion,
        distortion_plain,
    )

    if not torch.cuda.is_available():
        print("time_distortion: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    rows = {}
    for n in [int(a) for a in sys.argv[1:]] or [16, 64]:
        rng = np.random.default_rng(n)
        imgs = torch.from_numpy(np.stack([chip_smoke.leafish_image(rng, 224)
                                          for _ in range(n)])).cuda()
        seeds = torch.from_numpy(rng.integers(0, 2 ** 32, (n, 3),
                                              dtype=np.int64)).cuda()
        cutoffs = torch.from_numpy(rng.uniform(0, 2, n).astype(
            np.float32)).cuda()

        def call():
            return distortion(imgs, seeds, cutoffs)

        got = call()
        if not torch.equal(got, distortion_plain(imgs, seeds, cutoffs)):
            raise AssertionError(f"K6 at n={n} differs from its twin")
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                call()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages()
                if "distortion" in e.key and e.self_device_time_total > 0]
        launches = sum(e.count for e in seen)
        rows[n] = {
            "kernel_ms": round(sum(e.self_device_time_total for e in seen)
                               / 1e3 / max(launches, 1), 5),
            "launches_per_call": launches / 50,
            "call_ms": round(chip_smoke.cuda_ms(torch, call, 50), 5),
            "twin_ms": round(chip_smoke.cuda_ms(
                torch, lambda: distortion_plain(imgs, seeds, cutoffs), 3), 4),
            "sha256": hashlib.sha256(got.cpu().numpy().tobytes()
                                     ).hexdigest()[:16]}
    print(json.dumps({"rows": rows, "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
