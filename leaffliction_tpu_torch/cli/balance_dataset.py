"""`python -m leaffliction_tpu_torch.cli.balance_dataset` — legacy balancer
entry point.

Port of `leaffliction_tpu/cli/balance_dataset.py`, with `--device` (cuda
by default; `core/device.py`): balances `--source-dir` into `--target-dir`
(`augmented_directory` by default) with `data/balancer.DatasetBalancer`.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from leaffliction_tpu_torch.core.logging import get_logger, setup_logging

LOGGER = get_logger(__name__)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Balance dataset classes via augmentation (legacy entry)"
    )
    parser.add_argument("--source-dir", default="images")
    parser.add_argument("--target-dir", default="augmented_directory")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--workers", type=int, default=None,
                        help="Kept for flag parity; batching is on-device")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    setup_logging()
    args = parse_args(argv)
    source = Path(args.source_dir)
    if not source.exists():
        LOGGER.error("Source directory not found: %s", source)
        sys.exit(1)

    from leaffliction_tpu_torch.data.balancer import DatasetBalancer

    DatasetBalancer(
        source_dir=source, target_dir=Path(args.target_dir), seed=args.seed,
        device=args.device,
    ).run()


if __name__ == "__main__":
    main()
