"""leaffliction_tpu_torch — the PyTorch/CUDA port of leaffliction_tpu.

The serving path of `leaffliction-predict` on an NVIDIA H100: the LeafCNN
forward in eval mode, the batch and single prediction modes, and the leaf
mask montage, whose two TPU Pallas kernels (the connected-components round
and the Canny front end) are hand-written CUDA kernels here (`csrc/`, built
with nvcc at first use by `kernels/build.py`). Module names mirror the JAX
package (`ops/components.py` ↔ `ops/components.py`). The package imports
`torch` and never `jax` or `flax`; it reuses the JAX package's jax-free host
modules (JPEG decode, metrics, viz, CLI helpers).

Entry point: `python -m leaffliction_tpu_torch.cli.predict`.
"""

__version__ = "0.1.0"
