"""Print a configuration's frozen values, the file
`portbench/frozen/<config>.json` that the benchmark's CPU tests hold the
configuration to:

- `layout_sha256`: sha256 of its layout (each tensor's name, shape and
  kind, as JSON);
- `weights_sha256`: sha256 of its weights drawn on the CPU from a fixed
  seed over fixed images, each tensor's name, dtype and bytes;
- `train_flops_per_image` and `forward_flops_per_image`: `flops.py`'s
  counts.

    python3 portbench/tools/freeze.py --config <name> \
        > portbench/frozen/<name>.json

Runs on the CPU, in seconds.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    # run as a script: import `portbench.*` from the checkout's root
    sys.path[0] = str(Path(__file__).resolve().parents[2])

import torch  # noqa: E402

from portbench import flops, harness, weights  # noqa: E402
from portbench.reference import models  # noqa: E402

TOOL = "portbench/tools/freeze.py"


def layout_sha256(cfg: dict) -> str:
    spec = [[n, list(s), k] for n, s, k in models.layout(cfg)]
    return hashlib.sha256(json.dumps(spec).encode()).hexdigest()


def weights_sha256(cfg: dict) -> str:
    g = torch.Generator().manual_seed(5)
    x8 = torch.randint(0, 256, (16, 24, 24, 3), generator=g,
                       dtype=torch.uint8)
    w = weights.draw(cfg, x8, torch.Generator().manual_seed(2 ** 31 + 3))
    h = hashlib.sha256()
    for name, t in w.items():
        h.update(name.encode())
        h.update(str(t.dtype).encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def frozen(cfg: dict) -> dict:
    """The configuration's frozen values, computed now."""
    return {"layout_sha256": layout_sha256(cfg),
            "weights_sha256": weights_sha256(cfg),
            "train_flops_per_image": int(flops.train_flops_per_image(cfg)),
            "forward_flops_per_image":
                int(flops.forward_flops_per_image(cfg))}


def text(cfg: dict) -> str:
    """The file's text."""
    return json.dumps(frozen(cfg), indent=1) + "\n"


def config(name: str) -> dict:
    """The configuration named `name` in BENCHMARK.json, from its file."""
    entries = {c["name"]: c for c in
               harness.load_json(harness.ROOT / "BENCHMARK.json")["configs"]}
    if name not in entries:
        raise SystemExit(f"unknown configuration {name!r}; BENCHMARK.json "
                         f"has {sorted(entries)}")
    return harness.load_json(harness.ROOT / entries[name]["file"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    args = p.parse_args(argv)
    sys.stdout.write(text(config(args.config)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
