#!/usr/bin/env python3
"""Times of the fused balance with strict distortion noise against the default.

    python tools/time_strict_balance.py [REPS]     (default: 5)

Run from the root of a checkout on a machine with a CUDA card; it times the
`leaffliction_tpu_torch` of the checkout it sits in, so a copy placed in an
older checkout times that tree's balance. It writes the smoke's north-star
tree (`chip_smoke.write_north_star_tree`, seed 0: 1,530 leaf-like 256²
JPEGs, 110 generated) into a temporary directory and runs
`data/fused_balance.balance_to_device` on the card at 224 px, REPS times
in each mode, the modes alternating (LEAF_STRICT_DISTORTION unset, then
set to 1) after one untimed run of each. It also times
`ops/augment.draw_distortion` alone for 64 images of 224² in each mode
(median of 10, the card synchronised). It prints one line of JSON: per mode
the augment stage's seconds and the balance's wall (each run, and the
median), the draw's ms, and the card's name and power limit
(`nvidia-smi`). It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

MODES = {"default": None, "strict": "1"}


def set_mode(mode: str) -> None:
    if MODES[mode] is None:
        os.environ.pop("LEAF_STRICT_DISTORTION", None)
    else:
        os.environ["LEAF_STRICT_DISTORTION"] = MODES[mode]


def main() -> int:
    import torch

    import chip_smoke
    from leaffliction_tpu_torch.data.fused_balance import balance_to_device
    from leaffliction_tpu_torch.ops.augment import draw_distortion

    if not torch.cuda.is_available():
        print("time_strict_balance: needs a CUDA card", file=sys.stderr)
        return 1
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    cuda = torch.device("cuda")
    rows = {m: {"augment_s": [], "balance_s": [], "draw_ms": []}
            for m in MODES}
    with tempfile.TemporaryDirectory(prefix="strict_balance_") as tmp:
        tree = Path(tmp) / "tree"
        chip_smoke.write_north_star_tree(tree, np.random.default_rng(0))
        for rep in range(reps + 1):
            for mode in MODES:
                set_mode(mode)
                res = balance_to_device(tree, 224, seed=0,
                                        target_dir=Path(tmp) / "target",
                                        write_artifacts=False, device=cuda)
                if rep:  # the first run of each mode builds and warms up
                    rows[mode]["augment_s"].append(res.stages["augment_s"])
                    rows[mode]["balance_s"].append(res.balance_time_s)
                del res
        for mode in MODES:
            set_mode(mode)
            for _ in range(11):
                rngs = [np.random.default_rng([0, i]) for i in range(64)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                draw_distortion(rngs, (224, 224), cuda)
                torch.cuda.synchronize()
                rows[mode]["draw_ms"].append((time.perf_counter() - t0) * 1e3)
            rows[mode]["draw_ms"] = rows[mode]["draw_ms"][1:]
    out = {mode: {"augment_s": r["augment_s"],
                  "augment_s_median": statistics.median(r["augment_s"]),
                  "balance_s": r["balance_s"],
                  "balance_s_median": statistics.median(r["balance_s"]),
                  "draw64_ms_median": statistics.median(r["draw_ms"])}
           for mode, r in rows.items()}
    print(json.dumps({"rows": out, "reps": reps, "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
