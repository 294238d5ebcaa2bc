#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with one CUDA card. It imports
nothing of JAX. Phases, each printed on its own line with the card's name and
power limit; any failure raises and the script exits non-zero without
printing a result:

1. the device, and `nvidia-smi` name and power limit;
2. the build of the CUDA kernels from `leaffliction_tpu_torch/csrc` (nvcc);
3. K4, the connected-components round, against its plain twin on the card:
   masks [8,224,224] at densities 0.2/0.5/0.8, 3 rounds each, exact;
4. K5, the Canny front end, against its twin on the card: [8,224,224],
   L1 and L2, max |diff| <= 1e-3;
5. K1, the fused train augmentation, against its twin on the card at
   [32,224,224,3], angles in +-18 degrees: uint8 -> f32 <= 1e-5, uint8 ->
   bf16 <= 2^-8, f32 in without contrast <= 1e-5, angle 0 with factor 1 the
   dequantised input within 1e-6;
6. serving: a leafcnn-base 224 px / 8-class / bf16 artifact dir written from
   --seed (flax layout), loaded by `ModelLoader`, 256 images through the
   `Predictor`; probabilities finite, rows summing to 1 +- 1e-3, and the first
   8 rows within 2e-2 of the port's f32 forward on the CPU;
7. the mask montage (`generate_mask_visualization`) on 8 leaf-like 224²
   images; K4 and K5 must have launched, and each mask agrees with the CPU
   plain path on >= 99.9% of pixels;
8. where PIL is installed, the predict CLI in batch mode in a subprocess;
9. one f32 train step, card against CPU: leafcnn-tiny 64 px, batch 8, TF32
   off, augmentation and dropout off; with cuDNN off, loss within 1e-4
   relative and every gradient within 1e-3 relative L2; with cuDNN on (the
   backend training runs), loss within 1e-4, all gradients together within
   1e-3 relative L2 and each within 1e-2 (a BatchNorm bias gradient is a
   near-cancelling sum whose relative error reaches ~6e-3 on some inputs);
10. training at full width: leafcnn-base 224 px, batch 32, bf16, REGULARIZED,
   augmentation on, over a device-resident uint8 dataset of leaf-like images:
   30 steps on one fixed batch (the last loss below the first), then 25
   timed steps on gathered batches; every loss finite and K1 launched once
   per step; ms/step (CUDA events, median) and img/s;
11. where PIL is installed, the train CLI (2 epochs, 224 px, batch 32) on a
   JPEG tree of 8 classes x 32 images, then the predict CLI on its
   artifacts, each in a subprocess with rc 0;
12. timings with CUDA events: serving per 64-batch, ms per mask, K4 and K5,
   and K1 at 32 and 128 x 224² (bf16 out), each kernel beside its twin.

Kernel launch counts are reset just before each main path and read right
after it: serving (phases 6-7) for K4 and K5, training (phase 10) for K1.
The last lines are the card's name and power limit, a JSON line of
per-kernel results, and `{"ok": true, "device": {...}}`.
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
TRAIN_BATCH, FIXED_STEPS, TIMED_STEPS = 32, 30, 25
CARD = ""  # nvidia-smi name and power limit, set once in main


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items())
          + (f" card={json.dumps(CARD)}" if CARD else ""), flush=True)


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


def phase_kernels_k1(torch, rng):
    from leaffliction_tpu_torch.ops.kernels.rotate import (
        train_aug,
        train_aug_plain,
    )

    n = TRAIN_BATCH
    imgs = torch.from_numpy(np.stack([leafish_image(rng, SIZE)
                                      for _ in range(n)])).cuda()
    angles = torch.from_numpy(rng.uniform(-18, 18, n).astype(
        np.float32)).cuda()
    factors = torch.from_numpy(rng.uniform(0.9, 1.1, n).astype(
        np.float32)).cuda()
    errs = {}
    for name, dt in (("u8_f32", torch.float32), ("u8_bf16", torch.bfloat16)):
        got = train_aug(imgs, angles, factors, dt)
        ref = train_aug_plain(imgs, angles, factors, dt)
        torch.cuda.synchronize()
        if got.dtype != dt or got.shape != imgs.shape:
            raise AssertionError(f"K1 {name}: {got.dtype} {got.shape}")
        errs[name] = float((got.float() - ref.float()).abs().max())
    x = imgs.float() / 255.0
    errs["f32_rotate"] = float((train_aug(x, angles)
                                - train_aug_plain(x, angles)).abs().max())
    ident = train_aug(imgs, torch.zeros_like(angles), torch.ones_like(
        factors))
    errs["identity"] = float((ident - x).abs().max())
    tols = {"u8_f32": 1e-5, "u8_bf16": 2.0 ** -8, "f32_rotate": 1e-5,
            "identity": 1e-6}
    for name, tol in tols.items():
        if not errs[name] <= tol:
            raise AssertionError(f"K1 {name} differs from its twin: max "
                                 f"|diff| {errs[name]} > {tol}")
    log("5 k1", shape=[n, SIZE, SIZE, 3], angle_range_deg=[
        round(float(angles.min()), 3), round(float(angles.max()), 3)],
        **{f"max_abs_err_{k}": v for k, v in errs.items()},
        tols=json.dumps(tols))
    return imgs, angles, factors, max(errs["u8_f32"], errs["f32_rotate"])


def phase_step_check(torch):
    """One f32 train step (tiny, 64 px, batch 8) on the card and the CPU."""
    import copy

    from leaffliction_tpu_torch.train.config import TrainConfig
    from leaffliction_tpu_torch.models.leafcnn import LeafCNN, init_leafcnn
    from leaffliction_tpu_torch.train.steps import loss_fn

    cfg = TrainConfig.regularized()
    cpu_model = init_leafcnn(LeafCNN(CLASSES, (16, 32, 64)), 0)
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.random((8, 64, 64, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, CLASSES, 8))
    mask = torch.ones(8)

    def grads(model, dev):
        loss, _ = loss_fn(model(x.to(dev), train=True), labels.to(dev),
                          mask.to(dev), CLASSES, cfg.label_smoothing)
        g = torch.autograd.grad(loss, list(model.parameters()))
        return loss.item(), [t.cpu().double() for t in g]

    def worst(a, b):
        return max(float((p - q).norm() / q.norm().clamp_min(1e-30))
                   for p, q in zip(a, b))

    def overall(a, b):
        return float(torch.cat([(p - q).ravel() for p, q in zip(a, b)]).norm()
                     / torch.cat([q.ravel() for q in b]).norm())

    l_cpu, g_cpu = grads(cpu_model, "cpu")
    with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        l_gpu, g_gpu = grads(copy.deepcopy(cpu_model).cuda(), "cuda")
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        l_dnn, g_dnn = grads(copy.deepcopy(cpu_model).cuda(), "cuda")
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_rel = worst(g_gpu, g_cpu)
    if not (loss_rel <= 1e-4 and grad_rel <= 1e-3):
        raise AssertionError(f"f32 step card vs CPU: loss rel {loss_rel}, "
                             f"worst grad rel L2 {grad_rel}")
    # cuDNN on: the backend the bf16 training runs. A BatchNorm bias
    # gradient is a near-cancelling sum, so its own relative error is held
    # loosely; all gradients together are held at 1e-3.
    dnn = {"loss": abs(l_dnn - l_cpu) / abs(l_cpu),
           "all": overall(g_dnn, g_cpu), "worst": worst(g_dnn, g_cpu)}
    if not (dnn["loss"] <= 1e-4 and dnn["all"] <= 1e-3
            and dnn["worst"] <= 1e-2):
        raise AssertionError(f"f32 step card (cuDNN) vs CPU: {dnn}")
    log("9 step check", model="leafcnn-tiny", img=64, batch=8, dtype="f32",
        tf32=False, loss_rel_err=f"{loss_rel:.3e}",
        worst_grad_rel_l2=f"{grad_rel:.3e}", tol_loss=1e-4, tol_grad=1e-3,
        cudnn_loss_rel_err=f"{dnn['loss']:.3e}",
        cudnn_all_grads_rel_l2=f"{dnn['all']:.3e}",
        cudnn_worst_grad_rel_l2=f"{dnn['worst']:.3e}",
        cudnn_tol_all=1e-3, cudnn_tol_worst=1e-2)


def phase_training(torch, seed: int, rng):
    """leafcnn-base 224 b32 bf16 REGULARIZED with K1 on every step."""
    from leaffliction_tpu_torch.train.config import TrainConfig
    from leaffliction_tpu_torch.models.leafcnn import build_leafcnn
    from leaffliction_tpu_torch.ops.image import compute_norm_stats
    from leaffliction_tpu_torch.ops.kernels.components import cc_round
    from leaffliction_tpu_torch.ops.kernels.edge import edge_nms
    from leaffliction_tpu_torch.ops.kernels.rotate import train_aug
    from leaffliction_tpu_torch.train.steps import (
        build_step_fns,
        create_train_state,
    )

    n_data = 4 * TRAIN_BATCH
    data = torch.from_numpy(np.stack([leafish_image(rng, SIZE)
                                      for _ in range(n_data)])).cuda()
    labels = torch.from_numpy(rng.integers(0, CLASSES, n_data)).cuda()
    model = build_leafcnn(CLASSES, "base", dtype=torch.bfloat16)
    state = create_train_state(model, seed, "cuda")
    mean, var = compute_norm_stats(data)
    with torch.no_grad():
        state.model.norm_mean.copy_(mean)
        state.model.norm_var.copy_(var)
    fns = build_step_fns(TrainConfig.regularized(), CLASSES, 1000)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mask = torch.ones(TRAIN_BATCH, device="cuda")
    fixed = torch.arange(TRAIN_BATCH, device="cuda")
    sels = [torch.from_numpy(rng.choice(n_data, TRAIN_BATCH, replace=False)
                             ).cuda() for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # --- the main path: counts from here to the end of the timed steps ---
    cc_round.launches = edge_nms.launches = train_aug.launches = 0
    t0 = time.perf_counter()
    losses = [fns.train_step_gather(state, data, labels, fixed, mask,
                                    gen)["loss"] for _ in range(FIXED_STEPS)]
    torch.cuda.synchronize()
    fixed_s = time.perf_counter() - t0
    events = []
    t0 = time.perf_counter()
    for sel in sels:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(fns.train_step_gather(state, data, labels, sel, mask,
                                            gen)["loss"])
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = train_aug.launches
    # --- end of the main path ---
    steps = FIXED_STEPS + TIMED_STEPS
    if launches != steps:
        raise AssertionError(f"K1 launched {launches} times in {steps} "
                             "train steps")
    loss = torch.stack(losses).float().cpu().numpy()
    if not np.isfinite(loss).all():
        raise AssertionError(f"non-finite training loss: {loss}")
    if not loss[FIXED_STEPS - 1] < loss[0]:
        raise AssertionError(f"loss on a fixed batch did not fall in "
                             f"{FIXED_STEPS} steps: {loss[:FIXED_STEPS]}")
    ms = sorted(s.elapsed_time(e) for s, e in events)
    med = float(np.median(ms))
    log("10 training", model="leafcnn-base", img=SIZE, batch=TRAIN_BATCH,
        dtype="bf16", config="REGULARIZED", augment=True, steps=steps,
        k1_launches=launches, loss_first=f"{loss[0]:.4f}",
        loss_after_fixed_steps=f"{loss[FIXED_STEPS - 1]:.4f}",
        loss_last=f"{loss[-1]:.4f}",
        ms_per_step_median=f"{med:.3f}",
        ms_per_step_min=f"{ms[0]:.3f}", ms_per_step_max=f"{ms[-1]:.3f}",
        img_per_s=f"{TRAIN_BATCH * 1e3 / med:.1f}",
        wall_ms_per_step_timed=f"{wall_s * 1e3 / TIMED_STEPS:.3f}",
        wall_ms_per_step_first_30=f"{fixed_s * 1e3 / FIXED_STEPS:.3f}",
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    return launches, med


def write_jpeg_tree(root: Path, rng, per_class: int = 32) -> None:
    from PIL import Image

    for i in range(CLASSES):
        d = root / "Plant" / f"class{i}"
        d.mkdir(parents=True)
        for j in range(per_class):
            Image.fromarray(leafish_image(rng, 256)).save(
                d / f"image ({j}).JPG", quality=90)


def run_cli(args, cwd: Path, timeout: int = 900):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [q for q in [os.environ.get("PYTHONPATH")] if q]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{args[0]} rc={proc.returncode}\n"
                             f"{proc.stderr[-4000:]}")
    return time.perf_counter() - t0


def phase_train_cli(tmp: Path, rng, kind: str):
    from leaffliction_tpu_torch.data.manifest import write_split_manifest

    src = tmp / "tree"
    write_jpeg_tree(src, rng)
    manifest = tmp / "manifest_split.json"
    write_split_manifest(src, manifest, val_ratio=0.2, seed=32)
    models = tmp / "trained"
    train_s = run_cli(["leaffliction_tpu_torch.cli.train", "--manifest",
                       str(manifest), "--epochs", "2", "--img-size",
                       str(SIZE), "--batch-size", str(TRAIN_BATCH),
                       "--out-dir", str(models)], tmp)
    for name in ("leaf_cnn.msgpack", "labels.json", "history.json",
                 "meta.json", "confusion_matrix.json"):
        if not (models / name).exists():
            raise AssertionError(f"train CLI wrote no {name}")
    history = json.loads((models / "history.json").read_text())
    if sorted(history) != ["accuracy", "loss", "val_accuracy", "val_loss"] \
            or any(len(v) != 2 for v in history.values()):
        raise AssertionError(f"history: {history}")
    meta = json.loads((models / "meta.json").read_text())
    if meta["system"].get("device_kind") != kind \
            or meta["system"].get("backend") != "cuda":
        raise AssertionError(f"meta system block: {meta['system']}")
    out_json = tmp / "trained_batch_results.json"
    predict_s = run_cli(["leaffliction_tpu_torch.cli.predict",
                         str(src / "Plant" / "class0"), "--batch-mode",
                         "-learnings", str(models), "-json", str(out_json),
                         "-out", str(tmp / "trained_predictions")], tmp)
    rows = json.loads(out_json.read_text())["batch_results"]
    if len(rows) != 32:
        raise AssertionError(f"predict CLI served {len(rows)} of 32 images")
    log("11 train cli", classes=CLASSES, images=CLASSES * 32,
        train_items=meta["data"]["train_items"],
        val_items=meta["data"]["val_items"], epochs=2,
        val_accuracy=json.dumps(history["val_accuracy"]),
        saved_variant=meta["saved_variant"],
        train_cli_wall_s=f"{train_s:.2f}", predict_cli_rc=0,
        predict_cli_wall_s=f"{predict_s:.2f}", served=len(rows))


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
    from leaffliction_tpu_torch.ops.kernels.rotate import train_aug
    from leaffliction_tpu_torch.predict.predictor import (
        SERVING_BATCH,
        Predictor,
    )

    # 1. device
    global CARD
    device = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    CARD = nvidia_smi()
    print(f"nvidia-smi: {CARD}", flush=True)
    log("1 device", kind=json.dumps(kind), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    # 2. kernel build
    t0 = time.perf_counter()
    build.load()
    log("2 build", seconds=f"{time.perf_counter() - t0:.2f}",
        nvcc_seconds=f"{build.build_seconds:.2f}", lib=build.library_path())
    for line in build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("2 ptxas", info=json.dumps(
                line.split("ptxas info    :")[-1].strip()))

    rng = np.random.default_rng(args.seed)
    # 3-4. kernels against their twins on the card
    k4_err = phase_kernels_k4(torch, rng)
    gray, k5_err = phase_kernels_k5(torch, rng)
    k1_imgs, k1_angles, k1_factors, k1_err = phase_kernels_k1(torch, rng)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        learn = tmp / "model"
        write_artifacts(torch, learn, args.seed)
        images = rng.integers(0, 256, (4 * SERVING_BATCH, SIZE, SIZE, 3),
                              dtype=np.uint8)
        leaves = [leafish_image(rng, SIZE) for _ in range(BATCH)]

        # --- the serving path: counts from here to the end of phase 7 ---
        cc_round.launches = edge_nms.launches = train_aug.launches = 0

        # 6. serving
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

        # 7. mask montage
        montages = [predictor.generate_mask_visualization(a) for a in leaves]
        torch.cuda.synchronize()
        launches = {"cc_round": cc_round.launches,
                    "edge_nms": edge_nms.launches}
        # --- end of the serving path ---
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"{name} never launched on the serving "
                                     "path")

        ref = cpu_f32_forward(torch, learn, images[:BATCH])
        prob_err = float(np.abs(probs[:BATCH] - ref).max())
        if not prob_err <= 2e-2:
            raise AssertionError(f"bf16 card vs f32 CPU: max |dprob| "
                                 f"{prob_err} > 2e-2")
        top1 = float((probs[:BATCH].argmax(-1) == ref.argmax(-1)).mean())
        log("6 serving", model="leafcnn-base", img=SIZE, classes=CLASSES,
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
        log("7 montage", images=BATCH, size=SIZE,
            k4_launches=launches["cc_round"],
            k5_launches=launches["edge_nms"],
            min_pixel_agreement_vs_cpu=min(agree))

        # 8. the predict CLI in batch mode
        try:
            from PIL import Image
        except ImportError:
            log("8 cli", skipped="PIL is not installed")
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
            log("8 cli", rc=proc.returncode, results=len(rows),
                seconds=f"{cli_s:.2f}")

        # 9-11. training
        phase_step_check(torch)
        k1_launches, _ = phase_training(torch, args.seed, rng)
        try:
            import PIL  # noqa: F401
        except ImportError:
            log("11 train cli", skipped="PIL is not installed")
        else:
            phase_train_cli(tmp, rng, kind)

        # 12. timings (CUDA events; host clock around synchronised work)
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
        log("12 serving", ms_per_64_batch_end_to_end=f"{wall * 1e3 / 4:.3f}",
            img_per_s=f"{len(images) / wall:.1f}",
            ms_per_64_batch_upload_and_forward=f"{fwd_ms:.3f}",
            ms_per_64_batch_forward_on_device=f"{dev_ms:.3f}")

        mask_s = []
        for a in leaves:
            t0 = time.perf_counter()
            predictor.generate_mask_visualization(a)
            torch.cuda.synchronize()
            mask_s.append(time.perf_counter() - t0)
        log("12 montage", ms_per_224_mask_median=f"{np.median(mask_s) * 1e3:.3f}",
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
        log("12 kernels", k4_round_ms=f"{k4[0]:.4f}",
            k4_twin_ms=f"{k4[1]:.4f}", k5_batch_ms=f"{k5[0]:.4f}",
            k5_twin_ms=f"{k5[1]:.4f}", shape=[BATCH, SIZE, SIZE])

        from leaffliction_tpu_torch.ops.kernels.rotate import train_aug_plain

        k1 = {}
        for n in (TRAIN_BATCH, 4 * TRAIN_BATCH):
            reps = -(-n // TRAIN_BATCH)
            imgs = k1_imgs.repeat(reps, 1, 1, 1)[:n]
            ang = k1_angles.repeat(reps)[:n]
            fac = k1_factors.repeat(reps)[:n]
            k1[n] = [cuda_ms(torch, lambda: train_aug(
                         imgs, ang, fac, torch.bfloat16), 20),
                     cuda_ms(torch, lambda: train_aug_plain(
                         imgs, ang, fac, torch.bfloat16), 20)]
        log("12 k1", out="bf16",
            **{f"k1_ms_{n}x224": f"{v[0]:.4f}" for n, v in k1.items()},
            **{f"k1_twin_ms_{n}x224": f"{v[1]:.4f}" for n, v in k1.items()})

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
        {"name": "train_aug", "route": "cuda",
         "source": "leaffliction_tpu_torch/csrc/train_aug.cu",
         "replaces": "leaffliction_tpu/ops/pallas/rotate.py:752, "
                     "leaffliction_tpu/ops/pallas/rotate.py:583, "
                     "leaffliction_tpu/ops/pallas/rotate.py:801",
         "launches": k1_launches, "max_abs_err": k1_err,
         "ms": round(k1[TRAIN_BATCH][0], 5),
         "plain_ms": round(k1[TRAIN_BATCH][1], 5)},
    ]
    print(f"nvidia-smi: {nvidia_smi()}", flush=True)
    print(json.dumps({"kernels": kernels, "card": CARD}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
