#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with one CUDA card. It imports
nothing of JAX. Phases, each printed on its own line; any failure raises and
the script exits non-zero without printing a result:

1. the device, and `nvidia-smi` name and power limit;
2. the build of the CUDA kernels from `leaffliction_tpu_torch/csrc` (nvcc);
3. K4, the connected-components round, against its plain twin on the card:
   masks [8,224,224] at densities 0.2/0.5/0.8, 3 rounds each, exact;
4. K5, the Canny front end, against its twin on the card: [8,224,224],
   L1 and L2, max |diff| <= 1e-3;
5. serving: a leafcnn-base 224 px / 8-class / bf16 artifact dir written from
   --seed (flax layout), loaded by `ModelLoader`, 256 images through the
   `Predictor`; probabilities finite, rows summing to 1 +- 1e-3, and the first
   8 rows within 2e-2 of the port's f32 forward on the CPU;
6. the mask montage (`generate_mask_visualization`) on 8 leaf-like 224²
   images; K4 and K5 must have launched, and each mask agrees with the CPU
   plain path on >= 99.9% of pixels;
7. where PIL is installed, the CLI in batch mode in a subprocess;
8. timings with CUDA events: serving per 64-batch, ms per mask, K4 and K5
   each beside its twin on the card.

Kernel launch counts are reset just before phase 5 and read right after
phase 6, so they count the main path's launches only. The last lines are the
card's name and power limit, a JSON line of per-kernel results, and
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BATCH, SIZE, CLASSES = 8, 224, 8
LABELS = [f"Plant_class{i}" for i in range(CLASSES)]


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def leafish_image(rng, size):
    """Green blob on light background (the tests' `_leafish_image`)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cy, cx = size / 2 + rng.normal(0, 3), size / 2 + rng.normal(0, 3)
    ry, rx = size * 0.32 + rng.normal(0, 2), size * 0.38 + rng.normal(0, 2)
    blob = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
    img = np.full((size, size, 3), 235, np.uint8)
    img[..., 0][blob] = 40 + (rng.random() * 40)
    img[..., 1][blob] = 120 + (rng.random() * 80)
    img[..., 2][blob] = 30 + (rng.random() * 40)
    noise = rng.normal(0, 4, img.shape)
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of fn() in ms, by CUDA events after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def seeded_state_dict(torch, model, rng):
    """Random leafcnn variables from numpy: lecun-normal convs and dense,
    non-identity BatchNorm and input statistics."""
    sd = {}
    for key, ref in model.state_dict().items():
        shape = tuple(ref.shape)
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "weight":
            fan_in = int(np.prod(shape[1:]))
            std = np.sqrt(1.0 / fan_in) * (0.3 if "Dense" in key else 1.0)
            a = rng.normal(0.0, std, shape)
        elif key == "norm_mean":
            a = rng.uniform(0.4, 0.5, shape)
        elif key == "norm_var":
            a = rng.uniform(0.05, 0.08, shape)
        elif leaf == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif leaf == "scale":
            a = rng.uniform(0.8, 1.2, shape)
        else:  # biases and BatchNorm means
            a = rng.normal(0.0, 0.05, shape)
        sd[key] = torch.from_numpy(a.astype(np.float32))
    return sd


def phase_kernels_k4(torch, rng):
    from leaffliction_tpu_torch.ops.components import _segment_planes
    from leaffliction_tpu_torch.ops.kernels.components import (
        cc_round,
        cc_round_plain,
    )

    h = w = SIZE
    label_bits = (h * w + 1).bit_length()
    flat = torch.arange(1, h * w + 1, dtype=torch.int32,
                        device="cuda").reshape(h, w)
    err = 0
    for density in (0.2, 0.5, 0.8):
        mask = torch.from_numpy(rng.random((BATCH, h, w)) < density).cuda()
        segs = _segment_planes(mask, label_bits, torch.int32)
        got = ref = torch.where(mask, flat, 0)
        for r in range(3):
            got = cc_round(got, mask, *segs, label_bits)
            ref = cc_round_plain(ref, mask, *segs, label_bits)
            torch.cuda.synchronize()
            err = max(err, int((got - ref).abs().max()))
            if not torch.equal(got, ref):
                bad = int((got != ref).sum())
                raise AssertionError(f"K4 differs from its twin: density "
                                     f"{density}, round {r}, {bad} pixels")
    log("3 k4", shape=[BATCH, h, w], densities=[0.2, 0.5, 0.8], rounds=3,
        max_abs_err=err, exact=True)
    return err


def phase_kernels_k5(torch, rng):
    from leaffliction_tpu_torch.ops.kernels.edge import (
        edge_nms,
        edge_nms_plain,
    )

    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32)
    gray = np.stack([((xx * (3 + i) + yy * 2) % 200
                      + rng.normal(0, 5, (SIZE, SIZE)))
                     for i in range(BATCH)]).astype(np.float32)
    gray = torch.from_numpy(gray).cuda()
    err = 0.0
    for l2 in (False, True):
        got = edge_nms(gray, l2)
        ref = edge_nms_plain(gray, l2)
        torch.cuda.synchronize()
        e = float((got - ref).abs().max())
        if not e <= 1e-3:
            raise AssertionError(f"K5 differs from its twin: l2={l2}, "
                                 f"max |diff| {e}")
        err = max(err, e)
    log("4 k5", shape=[BATCH, SIZE, SIZE], l2=[False, True], max_abs_err=err,
        tol=1e-3)
    return gray, err


def write_artifacts(torch, learn: Path, seed: int):
    from leaffliction_tpu_torch.convert import to_flax
    from leaffliction_tpu_torch.models.leafcnn import build_leafcnn
    from leaffliction_tpu_torch.train.checkpoint import save_model_msgpack

    model = build_leafcnn(CLASSES, "base")
    sd = seeded_state_dict(torch, model, np.random.default_rng(seed))
    learn.mkdir(parents=True, exist_ok=True)
    save_model_msgpack(learn / "leaf_cnn.msgpack", to_flax(sd))
    meta = {
        "model_file": "leaf_cnn.msgpack",
        "labels": LABELS,
        "data": {"img_size": SIZE, "num_classes": CLASSES},
        "model": {"name": "leaf_cnn", "widths": [32, 64, 128, 256],
                  "separable": False, "use_normalization": True,
                  "stem": "conv"},
        "training": {"mixed_precision": True},
    }
    (learn / "meta.json").write_text(json.dumps(meta, indent=2))


def cpu_f32_forward(torch, learn: Path, images: np.ndarray) -> np.ndarray:
    from leaffliction_tpu_torch.convert import to_state_dict
    from leaffliction_tpu_torch.models.leafcnn import build_leafcnn
    from leaffliction_tpu_torch.train.checkpoint import load_model_msgpack

    model = build_leafcnn(CLASSES, "base", dtype=torch.float32)
    model.load_state_dict(to_state_dict(
        load_model_msgpack(learn / "leaf_cnn.msgpack")))
    with torch.inference_mode():
        x = torch.from_numpy(images).float() / 255.0
        return torch.softmax(model.eval()(x), -1).numpy()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import leaffliction_tpu_torch as pkg

    if not Path(pkg.__file__).resolve().is_relative_to(ROOT):
        raise RuntimeError(f"leaffliction_tpu_torch imported from "
                           f"{pkg.__file__}, not from this checkout {ROOT}")

    from leaffliction_tpu_torch.core.device import resolve_device
    from leaffliction_tpu_torch.kernels import build
    from leaffliction_tpu_torch.ops.kernels.components import cc_round
    from leaffliction_tpu_torch.ops.kernels.edge import edge_nms
    from leaffliction_tpu_torch.predict.predictor import (
        SERVING_BATCH,
        Predictor,
    )

    # 1. device
    device = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log("1 device", kind=json.dumps(kind), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    print(f"nvidia-smi: {smi}", flush=True)

    # 2. kernel build
    t0 = time.perf_counter()
    build.load()
    log("2 build", seconds=f"{time.perf_counter() - t0:.2f}",
        nvcc_seconds=f"{build.build_seconds:.2f}", lib=build.library_path())
    for line in build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("    ptxas " + line.split("ptxas info    :")[-1].strip())

    rng = np.random.default_rng(args.seed)
    # 3-4. kernels against their twins on the card
    k4_err = phase_kernels_k4(torch, rng)
    gray, k5_err = phase_kernels_k5(torch, rng)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        learn = tmp / "model"
        write_artifacts(torch, learn, args.seed)
        images = rng.integers(0, 256, (4 * SERVING_BATCH, SIZE, SIZE, 3),
                              dtype=np.uint8)
        leaves = [leafish_image(rng, SIZE) for _ in range(BATCH)]

        # --- the main path: counts from here to the end of phase 6 ---
        cc_round.launches = 0
        edge_nms.launches = 0

        # 5. serving
        predictor = Predictor(learn, device=device).load()
        probs = predictor._probs_for_arrays(images)
        torch.cuda.synchronize()
        if probs.shape != (len(images), CLASSES):
            raise AssertionError(f"probabilities shape {probs.shape}")
        if not np.isfinite(probs).all():
            raise AssertionError("non-finite probabilities")
        row_err = float(np.abs(probs.sum(-1) - 1.0).max())
        if not row_err <= 1e-3:
            raise AssertionError(f"probability rows sum off by {row_err}")

        # 6. mask montage
        montages = [predictor.generate_mask_visualization(a) for a in leaves]
        torch.cuda.synchronize()
        launches = {"cc_round": cc_round.launches,
                    "edge_nms": edge_nms.launches}
        # --- end of the main path ---
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"{name} never launched on the main "
                                     "path")

        ref = cpu_f32_forward(torch, learn, images[:BATCH])
        prob_err = float(np.abs(probs[:BATCH] - ref).max())
        if not prob_err <= 2e-2:
            raise AssertionError(f"bf16 card vs f32 CPU: max |dprob| "
                                 f"{prob_err} > 2e-2")
        top1 = float((probs[:BATCH].argmax(-1) == ref.argmax(-1)).mean())
        log("5 serving", model="leafcnn-base", img=SIZE, classes=CLASSES,
            dtype="bf16", images=len(images), chunks=len(images) // 64,
            row_sum_err=f"{row_err:.2e}", max_dprob_vs_cpu_f32=prob_err,
            top1_agree=top1)

        from leaffliction_tpu_torch.segment.mask import (
            apply_mask_white,
            make_mask_single,
        )

        agree = []
        for a, montage in zip(leaves, montages):
            m_gpu = make_mask_single(torch.from_numpy(a).cuda())[0].cpu()
            m_cpu = make_mask_single(torch.from_numpy(a))[0]
            agree.append(float((m_gpu == m_cpu).float().mean()))
            if montage.shape != (SIZE, SIZE, 3) or montage.dtype != np.uint8:
                raise AssertionError(f"montage {montage.shape} "
                                     f"{montage.dtype}")
            cpu_montage = apply_mask_white(torch.from_numpy(a), m_cpu)
            same = (montage == cpu_montage.to(torch.uint8).numpy()).all(-1)
            agree.append(float(same.mean()))
        if not min(agree) >= 0.999:
            raise AssertionError(f"mask agreement with the CPU path "
                                 f"{min(agree)} < 0.999")
        log("6 montage", images=BATCH, size=SIZE,
            k4_launches=launches["cc_round"],
            k5_launches=launches["edge_nms"],
            min_pixel_agreement_vs_cpu=min(agree))

        # 7. the CLI in batch mode
        try:
            from PIL import Image
        except ImportError:
            log("7 cli", skipped="PIL is not installed")
        else:
            img_dir = tmp / "images"
            img_dir.mkdir()
            for i, a in enumerate(leaves):
                Image.fromarray(a).save(img_dir / f"leaf{i}.jpg", quality=95)
            out_json = tmp / "batch_results.json"
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                [str(ROOT)] + [q for q in [os.environ.get("PYTHONPATH")]
                               if q]))
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "leaffliction_tpu_torch.cli.predict",
                 str(img_dir), "--batch-mode", "--device", "cuda",
                 "-learnings", str(learn), "-json", str(out_json),
                 "-out", str(tmp / "prediction_output")],
                cwd=tmp, env=env, capture_output=True, text=True,
                timeout=600)
            cli_s = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"CLI rc={proc.returncode}\n"
                                     f"{proc.stderr[-4000:]}")
            results = json.loads(out_json.read_text())
            rows = results["batch_results"]
            if len(rows) != BATCH or results["summary"]["total_images"] \
                    != BATCH:
                raise AssertionError(f"CLI wrote {len(rows)} results")
            if not all(r["top_prediction"] in LABELS for r in rows):
                raise AssertionError("CLI predicted an unknown label")
            log("7 cli", rc=proc.returncode, results=len(rows),
                seconds=f"{cli_s:.2f}")

        # 8. timings (CUDA events; host clock around synchronised work)
        x64 = predictor._upload(images[:SERVING_BATCH])
        fwd_ms = cuda_ms(torch, lambda: predictor._infer(images[:64]), 10)
        with torch.inference_mode():
            dev_ms = cuda_ms(torch, lambda: torch.softmax(
                predictor.model_loader.model(x64.float() / 255.0), -1), 10)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            predictor._probs_for_arrays(images)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = sorted(walls)[1]
        log("8 serving", ms_per_64_batch_end_to_end=f"{wall * 1e3 / 4:.3f}",
            img_per_s=f"{len(images) / wall:.1f}",
            ms_per_64_batch_upload_and_forward=f"{fwd_ms:.3f}",
            ms_per_64_batch_forward_on_device=f"{dev_ms:.3f}")

        mask_s = []
        for a in leaves:
            t0 = time.perf_counter()
            predictor.generate_mask_visualization(a)
            torch.cuda.synchronize()
            mask_s.append(time.perf_counter() - t0)
        log("8 montage", ms_per_224_mask_median=f"{np.median(mask_s) * 1e3:.3f}",
            ms_min=f"{min(mask_s) * 1e3:.3f}", ms_max=f"{max(mask_s) * 1e3:.3f}",
            k4_rounds_per_mask=launches["cc_round"] / BATCH)

        from leaffliction_tpu_torch.ops.components import _segment_planes
        from leaffliction_tpu_torch.ops.kernels.components import (
            cc_round_plain,
        )
        from leaffliction_tpu_torch.ops.kernels.edge import edge_nms_plain

        label_bits = (SIZE * SIZE + 1).bit_length()
        mask = torch.from_numpy(rng.random((BATCH, SIZE, SIZE)) < 0.5).cuda()
        segs = _segment_planes(mask, label_bits, torch.int32)
        lab = torch.where(mask, torch.arange(
            1, SIZE * SIZE + 1, dtype=torch.int32, device="cuda").reshape(
                SIZE, SIZE), 0)
        k4 = [cuda_ms(torch, lambda: cc_round(lab, mask, *segs, label_bits),
                      50),
              cuda_ms(torch, lambda: cc_round_plain(lab, mask, *segs,
                                                    label_bits), 50)]
        k5 = [cuda_ms(torch, lambda: edge_nms(gray), 50),
              cuda_ms(torch, lambda: edge_nms_plain(gray), 50)]
        log("8 kernels", k4_round_ms=f"{k4[0]:.4f}",
            k4_twin_ms=f"{k4[1]:.4f}", k5_batch_ms=f"{k5[0]:.4f}",
            k5_twin_ms=f"{k5[1]:.4f}", shape=[BATCH, SIZE, SIZE])

    kernels = [
        {"name": "cc_round", "route": "cuda",
         "source": "leaffliction_tpu_torch/csrc/cc_round.cu",
         "replaces": "leaffliction_tpu/ops/pallas/components.py:98",
         "launches": launches["cc_round"], "max_abs_err": k4_err,
         "ms": round(k4[0], 5), "plain_ms": round(k4[1], 5)},
        {"name": "edge_nms", "route": "cuda",
         "source": "leaffliction_tpu_torch/csrc/edge_nms.cu",
         "replaces": "leaffliction_tpu/ops/pallas/edge.py:108",
         "launches": launches["edge_nms"], "max_abs_err": k5_err,
         "ms": round(k5[0], 5), "plain_ms": round(k5[1], 5)},
    ]
    print(f"nvidia-smi: {nvidia_smi()}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
