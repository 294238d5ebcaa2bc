"""Colored stdout logging for the port's CLIs.

Copy of `leaffliction_tpu/core/logging.py`: a colored root logger at INFO by
default, noisy third-party loggers held at WARNING.
"""

from __future__ import annotations

import logging
import os
import sys

_LEVEL_COLORS = {
    logging.DEBUG: "\x1b[36m",      # cyan
    logging.INFO: "\x1b[32m",       # green
    logging.WARNING: "\x1b[33m",    # yellow
    logging.ERROR: "\x1b[31m",      # red
    logging.CRITICAL: "\x1b[1;31m", # bold red
}
_RESET = "\x1b[0m"

_NOISY = ("PIL", "matplotlib", "urllib3")


class _ColorFormatter(logging.Formatter):
    def __init__(self, use_color: bool) -> None:
        super().__init__("%(asctime)s [%(levelname)s] %(name)s: %(message)s",
                         datefmt="%H:%M:%S")
        self._use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        text = super().format(record)
        if self._use_color:
            color = _LEVEL_COLORS.get(record.levelno, "")
            if color:
                return f"{color}{text}{_RESET}"
        return text


def setup_logging(level: int | str = logging.INFO) -> None:
    """Configure the root logger once: colored stream handler, quiet libs."""
    if isinstance(level, str):
        level = getattr(logging, level.upper(), logging.INFO)
    root = logging.getLogger()
    root.setLevel(level)
    # Replace any pre-existing stream handlers so repeated calls are idempotent.
    for handler in list(root.handlers):
        root.removeHandler(handler)
    handler = logging.StreamHandler(sys.stdout)
    use_color = sys.stdout.isatty() and os.environ.get("NO_COLOR") is None
    handler.setFormatter(_ColorFormatter(use_color))
    root.addHandler(handler)
    for name in _NOISY:
        logging.getLogger(name).setLevel(logging.WARNING)


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)
