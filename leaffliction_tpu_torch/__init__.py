"""leaffliction_tpu_torch — the PyTorch/CUDA port of leaffliction_tpu.

On an NVIDIA H100 it does what the JAX package does: distribution
analysis, class balancing (the fused balance → train path and the
materialising balancer), split, training (LeafCNN or the ResNet backbone,
the in-step augmentation, AdamW/Adam with clip, cosine LR and EMA written
to optax's semantics, resume and step checkpoints, K steps a CUDA graph
replay, data and tensor parallelism), batch and single prediction with the
mask montage and `--evaluate`, and the segmentation and analysis
transforms. `train/flops.py` counts a step's FLOPs and gives its MFU
against the card's bf16 peak. The TPU Pallas kernels of those paths are
hand-written CUDA kernels here (`csrc/`, built with nvcc at first use by
`kernels/build.py`). Module names mirror the JAX package
(`ops/components.py` ↔ `ops/components.py`). The package imports `torch`
and nothing of `jax`, `flax` or the JAX package: it keeps its own copies
of the host modules it needs (JPEG decode, manifests, scan, split, the
balancing plan, the loader, the train config, metrics, viz, the CLIs'
host helpers).

Entry points, the JAX package's seven CLIs with the same flags (and
`--device` where they run on the card): `python -m
leaffliction_tpu_torch.cli.<name>` for `predict`, `train`, `augment`,
`balance_dataset`, `distribution`, `split` and `transform`.
"""

__version__ = "0.1.0"
