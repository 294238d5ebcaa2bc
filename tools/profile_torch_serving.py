#!/usr/bin/env python3
"""Profile the PyTorch port's serving and training paths on one CUDA card.

    python tools/profile_torch_serving.py [--out build/profile]
        [--arch leafcnn|resnet10|resnet18] [--train-batch 32 [128 ...]]

Windows, each after a warm-up, under `torch.profiler` (CPU + CUDA): one
64-image serving batch through the `Predictor` (the --arch model with the
conv stem, leafcnn-base by default, 224 px, bf16, weights from a seed, as
`chip_smoke.py` writes them); one 224² mask montage; 20 calls each of K4
(one `_propagate` to the fixpoint) and K5 at [8, 224, 224]; one training
step of the same model at 224 px, bf16, REGULARIZED, with augmentation
(`StepFns.train_step_gather` over a device-resident uint8 batch) at each
--train-batch; 20 calls of K1 at [32, 224, 224, 3], bf16 out. For each
window it prints the wall time, the summed device time of all kernels, the
device busy share (their ratio), the device time by kernel group
(convolution and matmul, K1/K4/K5, reductions, elementwise, pooling,
copies) and the top operators by device time, and writes the full
`key_averages` tables under --out. The card's name and power limit are
printed first.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


# kernel-name fragments → group, first match wins
GROUPS = [
    ("k1", ("train_aug_smem", "row_pass", "col_pass", "channel_mean",
            "contrast<")),
    ("k4_k5", ("cc_propagate", "gauss5", "sobel_mag", "nms(")),
    ("conv_matmul", ("xmma", "cudnn", "cutlass", "gemm", "conv")),
    ("pooling", ("max_pool", "avg_pool")),
    ("reduction", ("reduce_kernel",)),
    ("copy_cast_fill", ("Memcpy", "Memset", "copy_kernel", "fill")),
    ("elementwise", ("elementwise", "multi_tensor")),
]


def kernel_group(name: str) -> str:
    for group, frags in GROUPS:
        if any(f in name for f in frags):
            return group
    return "other"


def profile_window(torch, name: str, fn, out: Path, top: int = 12) -> None:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # kernels appear as their own CUDA-side events; CPU ops also carry the
    # device time of the kernels they launched, so only CUDA events count
    busy_us = sum(device_us(e) for e in events
                  if str(getattr(e, "device_type", "")).endswith("CUDA"))
    table = events.table(sort_by="self_device_time_total", row_limit=60)
    (out / f"{name}.txt").write_text(table)
    busy = (f"device_busy_ms={busy_us / 1e3:.3f} "
            f"busy_share={busy_us / wall_us:.3f}" if busy_us else
            "device_busy=not measured (the trace holds no CUDA events)")
    print(f"[{name}] wall_ms={wall_us / 1e3:.3f} {busy}", flush=True)
    groups: dict = {}
    for e in events:
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            g = kernel_group(e.key)
            groups[g] = groups.get(g, 0.0) + device_us(e)
    print("    by group (device ms): " + " ".join(
        f"{g}={us / 1e3:.3f}" for g, us in sorted(
            groups.items(), key=lambda kv: -kv[1])), flush=True)
    ranked = sorted(events, key=device_us, reverse=True)[:top]
    for e in ranked:
        print(f"    {device_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=str(ROOT / "build" / "profile"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--arch", choices=["leafcnn", "resnet10", "resnet18"],
                   default="leafcnn")
    p.add_argument("--train-batch", type=int, nargs="+", default=[32])
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from leaffliction_tpu_torch.ops.kernels.components import cc_propagate
    from leaffliction_tpu_torch.ops.kernels.edge import edge_nms
    from leaffliction_tpu_torch.predict.predictor import Predictor

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(f"nvidia-smi: {smoke.nvidia_smi()}", flush=True)
    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory(prefix="profile_") as tmp:
        learn = Path(tmp) / "model"
        smoke.write_artifacts(torch, learn, args.seed, args.arch)
        predictor = Predictor(learn, device="cuda").load()
        images = rng.integers(0, 256, (64, 224, 224, 3), dtype=np.uint8)
        profile_window(torch, f"serving_64_{args.arch}", lambda: predictor
                       ._probs_for_arrays(images), out)

        leaf = smoke.leafish_image(rng, 224)
        profile_window(torch, "montage_224", lambda: predictor
                       .generate_mask_visualization(leaf), out)

    n, size = 8, 224
    mask = torch.from_numpy(rng.random((n, size, size)) < 0.5).cuda()
    lab = torch.where(mask, torch.arange(1, size * size + 1,
                                         dtype=torch.int32, device="cuda"
                                         ).reshape(size, size), 0)
    gray = torch.rand(n, size, size, device="cuda") * 255

    def kernels():
        for _ in range(20):
            cc_propagate(lab, mask, 2 * size)
            edge_nms(gray)

    profile_window(torch, "k4_k5_x20", kernels, out)

    from leaffliction_tpu_torch.train.config import TrainConfig
    from leaffliction_tpu_torch.ops.kernels.rotate import train_aug
    from leaffliction_tpu_torch.train.steps import (
        build_step_fns,
        create_train_state,
    )

    for b in args.train_batch:
        data = torch.from_numpy(np.stack([smoke.leafish_image(rng, size)
                                          for _ in range(b)])).cuda()
        labels = torch.from_numpy(rng.integers(0, 8, b)).cuda()
        state = create_train_state(
            smoke.smoke_model(torch, args.arch, "conv", torch.bfloat16),
            args.seed, "cuda")
        fns = build_step_fns(TrainConfig.regularized(), 8, 1000)
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        sel = torch.arange(b, device="cuda")
        mask = torch.ones(b, device="cuda")
        profile_window(torch, f"train_step_{args.arch}_b{b}",
                       lambda: fns.train_step_gather(
                           state, data, labels, sel, mask, gen), out, top=25)
        del state, fns
    b = 32
    data = torch.from_numpy(np.stack([smoke.leafish_image(rng, size)
                                      for _ in range(b)])).cuda()
    angles = torch.linspace(-18, 18, b, device="cuda")
    factors = torch.linspace(0.9, 1.1, b, device="cuda")

    def k1():
        for _ in range(20):
            train_aug(data, angles, factors, torch.bfloat16)

    profile_window(torch, "k1_b32_x20", k1, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
