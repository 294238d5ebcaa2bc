"""Training configuration.

Copy of `leaffliction_tpu/train/config.py`: the reference's REGULARIZED and
FAST config dicts as one dataclass; `fast()` applies the FAST override.
`cache` has no effect (the loader always caches decoded images in host RAM)
but is kept for flag parity.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"
    lr: float = 2e-3
    weight_decay: float = 1e-4
    label_smoothing: float = 0.02
    cosine_decay: bool = True
    ema_decay: float = 0.999
    clipnorm: float = 0.5
    cache: bool = False

    # loop behavior (reference callbacks)
    plateau_patience: int = 3
    plateau_factor: float = 0.3
    early_stop_patience: int = 6

    @staticmethod
    def regularized() -> "TrainConfig":
        return TrainConfig()

    @staticmethod
    def fast() -> "TrainConfig":
        return TrainConfig(
            optimizer="adam", lr=3e-3, weight_decay=0.0, label_smoothing=0.0,
            cosine_decay=True, ema_decay=0.0, clipnorm=0.0, cache=True,
        )

    def as_dict(self) -> dict:
        return {
            "optimizer": self.optimizer,
            "lr": self.lr,
            "weight_decay": self.weight_decay,
            "label_smoothing": self.label_smoothing,
            "cosine_decay": self.cosine_decay,
            "ema_decay": self.ema_decay,
            "clipnorm": self.clipnorm,
            "cache": self.cache,
        }
