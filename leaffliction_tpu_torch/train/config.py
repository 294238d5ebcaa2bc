"""Training configurations: the JAX package's `TrainConfig`, reused as it is.

It is a plain dataclass (the FAST and REGULARIZED presets) that imports no
JAX; the port's modules and scripts take it from here.
"""

from leaffliction_tpu.train.config import TrainConfig

__all__ = ["TrainConfig"]
