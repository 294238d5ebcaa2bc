"""leaffliction_tpu_torch — the PyTorch/CUDA port of leaffliction_tpu.

On an NVIDIA H100: the serving path of `leaffliction-predict` (the LeafCNN
forward, the batch and single prediction modes, the leaf mask montage), the
training path of `leaffliction-train` in manifest mode (LeafCNN in training
mode, the in-step flip/rotate/contrast augmentation, AdamW with clip, cosine
LR and EMA written to optax's semantics, the trainer and the artifact set)
and the fused balance → train path (`--balance-from`). The TPU Pallas
kernels of those paths are hand-written CUDA kernels here (`csrc/`, built
with nvcc at first use by `kernels/build.py`). Module names mirror the JAX
package (`ops/components.py` ↔ `ops/components.py`). The package imports
`torch` and nothing of `jax`, `flax` or the JAX package: it keeps its own
copies of the host modules it needs (JPEG decode, manifests, scan, split,
the balancing plan, the loader, the train config, metrics, viz, the predict
CLI's helpers).

Entry points: `python -m leaffliction_tpu_torch.cli.predict` and
`python -m leaffliction_tpu_torch.cli.train`.
"""

__version__ = "0.1.0"
