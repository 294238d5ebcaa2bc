"""`python -m leaffliction_tpu_torch.cli.train` — train LeafCNN or the ResNet
backbone (`--arch resnet10|resnet18`, with `--stem conv|s2d`) on one CUDA
device (or the CPU, when asked for by name), from a split manifest or
straight from a `PLANT/CLASS` tree with `--balance-from`.

Port of `leaffliction_tpu/cli/train.py`: the same flags plus `--device`
(cuda by default; `core/device.py`), the same artifact set in `--out-dir`
(`train/artifacts.py`). Manifest mode: validate the manifest (with the
augmented → split fallback), build the label mapping from the train items,
decode both splits through `data/loader.ImageStore` (`--transform`: then
segment every image, leaf on white, through `apply_training_transform`). `--balance-from <tree>`:
check `--val-ratio` first, then balance on the device
(`data/fused_balance.balance_to_device`: decode once, upload once, the six
augmentation ops with kernels K2 and K3), split in memory
(`--val-ratio`, `--split-seed`; `manifest_augmented.json`,
`manifest_split.json` and `split_summary.csv` in `artifacts/datasets`),
`--transform` on the device (`apply_training_transform_device`), and train
on the rows gathered on the device. Then, either way: adapt the input
normalisation on at most 2048 train images, build the model, state and step
functions, `fit`, evaluate the saved variant, write the artifacts (the
JAX CLI's `meta.json` model block for the same flags: `name` is the arch,
and `widths`, `drop_block` and `drop_top` are the `--scale` preset's even
for a ResNet, as the JAX CLI writes them). `main` returns the fit result,
with `--balance-from` the balance's counts and stage times, and with
`--transform` the transform's seconds.

Mid-run checkpoints and resume, as `leaffliction_tpu/cli/train.py:438-562`
(`train/checkpoint.py`, in `<out-dir>/checkpoints`): `--checkpoint-every N`
saves a checkpoint every N epochs and writes `checkpoints/history.json`;
`--checkpoint-every-steps N` saves every N steps off the training thread
(`AsyncStepCheckpointer`, closed when `fit` returns or raises, so the save
in flight commits); `--resume` restores the
latest checkpoint: a step checkpoint continues inside its epoch (the
generator's saved state, the epoch's consumed batches skipped, the meta's
history), an epoch checkpoint at the next epoch with
`checkpoints/history.json`; with none it warns and trains from scratch.
Manifest mode and `--balance-from` both resume (the fused balance is
deterministic by seed and reruns). `--profile-dir DIR` runs `fit` under
`torch.profiler` (CPU activity, and CUDA activity on the card) and writes
its Chrome trace to `DIR/train_trace.json`, the port's trainer and graph
spans among its events (`core/trace.py`). The run logs the port's
counters (`trace.counters()`) and its kernels' launches
(`kernels/build.launch_counts()`: K1, each BatchNorm kernel and the
BatchNorm layout copies) in one line when training ends.

Data parallelism, one process per device (`parallel/`): launch N
processes with torchrun,

    python -m torch.distributed.run --nproc-per-node N \
        -m leaffliction_tpu_torch.cli.train ... --mesh-data N

and each joins the process group (`maybe_initialize`, first), takes
`cuda:LOCAL_RANK` unless `--device` pins one (ranks pinned to one card
share it over gloo; each on its own card, NCCL), and runs the JAX
package's SPMD step on its rows: `--batch-size` is per process (global
batch B×N). Manifest mode strides the train items by rank
(`items_for_process`) and pads every rank to the same step count
(`global_steps_per_epoch`, zero-mask batches); `--balance-from` balances
the same tree on every rank (`check_replicated` holds the fused datasets
equal) and each step takes its rows of a global index batch; validation
runs on global batches, each rank its rows. Rank 0 alone writes the
manifests, checkpoints, `history.json`, the profile and the artifacts;
`meta.json` records `system.mesh` {"data": D, "model": T} and
`system.collective_backend`.

Tensor parallelism, `--mesh-model T` on D·T processes (`--mesh-data D`,
or -1 for the world size over T): rank r is data index r // T and model
index r % T; the data indices split the batch as above (`--batch-size` a
data index, global B×D; manifest mode strides the items by data index),
and the T ranks of a data index hold the channel blocks of the state
tensors that JAX's `tp_shardings` picks at `min_size` 64
(`parallel/tensor.shard_train_state`, logged as the number of sharded
state leaves) and gather activations where channels mix. Checkpoints and
the artifacts are the full state, gathered over the model group; a resume
slices it for this rank, on any mesh. A mesh that does not cover the
processes stops with JAX's "does not cover" error and the torchrun line.

`--steps-per-dispatch K` chains K train steps a dispatch, as
`leaffliction_tpu/cli/train.py:523-531`: -1 (the default) means 8 on a
CUDA device and 1 on the CPU, then K is clamped to [1, steps per epoch]
and a K > 1 is logged ("Chaining K train steps per dispatch"). On the card
in one process a chunk of K steps is one replay of a CUDA graph, captured
at the run's first chunk (kernel K1 inside it), and the epoch's remainder
one replay of a one-step graph (`train/graph.py`); a capture that fails
raises, and nothing falls back to eager steps. The eval runs eagerly.
A replay saves what the eager step's launches cost the host beyond its
device time, and each run pays a capture (PERF.md §6 has the measured
break-even: a short run of a device-bound model is quicker with K = 1).
On the CPU the chunk's steps run eagerly, with the same results as K = 1.
On a mesh the steps keep the chunking (callbacks, step checkpoints and
log lines per chunk) but run eagerly, since a graph cannot hold the
collectives (logged once). K = 1 runs every step eagerly. Step
checkpoints land on chunk boundaries, as in JAX.

The `.keras` artifact, as `leaffliction_tpu/cli/train.py:576-629`: when
the keras package is importable, rank 0 writes `<out-dir>/leaf_cnn.keras`
after the other artifacts (the saved variant's weights, those of
`leaf_cnn.msgpack`; `train/keras_export.py`) and records it in
`meta.json` as `keras_file`. It is the default; `--no-export-keras` turns
it off. LeafCNN only: with `--arch resnet*`, or without keras, it is
skipped, with a warning only for an explicit `--export-keras`. A failed
export logs a warning and never fails the run.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import random
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from leaffliction_tpu_torch.core import trace
from leaffliction_tpu_torch.core.logging import get_logger, setup_logging
from leaffliction_tpu_torch.data.loader import (
    BatchIterator,
    DeviceImageStore,
    ImageStore,
    global_steps_per_epoch,
    items_for_process,
    sample_batch,
)
from leaffliction_tpu_torch.data.manifest import (
    build_label_mapping,
    load_manifest,
    select_items,
)
from leaffliction_tpu_torch.train.config import TrainConfig

LOGGER = get_logger(__name__)

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train LeafCNN or a ResNet (PyTorch/CUDA port) using "
                    "manifest_split.json")
    p.add_argument("--manifest", type=Path,
                   default=Path("artifacts/datasets/manifest_augmented.json"))
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--lr", type=float, default=None,
                   help="override the preset base learning rate "
                        "(regularized 2e-3 / fast 3e-3)")
    p.add_argument("--no-normalization", action="store_true")
    p.add_argument("--no-mixed-precision", action="store_true",
                   help="Disable bfloat16 compute (f32 throughout)")
    p.add_argument("--fast", action="store_true")
    p.add_argument("--scale", choices=["tiny", "small", "base"],
                   default="base")
    mx = p.add_mutually_exclusive_group()
    mx.add_argument("--tiny", action="store_true")
    mx.add_argument("--small", action="store_true")
    mx.add_argument("--base", action="store_true")
    p.add_argument("--separable", action="store_true")
    p.add_argument("--stem", choices=["conv", "s2d"], default="conv")
    p.add_argument("--arch", choices=["leafcnn", "resnet10", "resnet18"],
                   default="leafcnn",
                   help="Backbone: leafcnn (--scale, --separable) or the "
                        "ResNet presets")
    p.add_argument("--transform", action="store_true",
                   help="Apply the mask-segmentation training transform to "
                        "all images (reference training transform hook)")
    p.add_argument("--target-val-acc", type=float, default=None)
    p.add_argument("--out-dir", type=Path, default=Path("artifacts/models"))
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; fails without CUDA) "
                        "or cpu")
    p.add_argument("--mesh-data", type=int, default=-1,
                   help="data-parallel processes: -1 (all of them) or the "
                        "world size torchrun launched")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="tensor-parallel ranks a data index: the state's "
                        "channels are sharded over them")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="Save a resume checkpoint every N epochs "
                        "(synchronous)")
    p.add_argument("--checkpoint-every-steps", type=int, default=0,
                   help="Save a resume checkpoint every N steps off the "
                        "training thread (skipped while the previous save "
                        "is in flight); a killed run resumes mid-epoch")
    p.add_argument("--resume", action="store_true",
                   help="Resume from the latest checkpoint in "
                        "<out-dir>/checkpoints")
    p.add_argument("--profile-dir", type=Path, default=None,
                   help="Write a torch.profiler Chrome trace of the "
                        "training run to DIR/train_trace.json")
    p.add_argument("--steps-per-dispatch", type=int, default=-1,
                   help="train steps per dispatch: one CUDA graph replay "
                        "on the card (-1: 8 on CUDA, 1 on the CPU; at most "
                        "the steps of an epoch; 1 runs eagerly)")
    p.add_argument("--no-device-dataset", action="store_true",
                   help="Upload each batch's pixels instead of keeping the "
                        "uint8 dataset on the device (the default when it "
                        "is under 6 GB)")
    p.add_argument("--balance-from", type=Path, default=None,
                   help="Fused balance→split→train: class-balancing "
                        "augmentation on the device straight into the "
                        "training dataset, the ratio split in memory, then "
                        "training")
    p.add_argument("--val-ratio", type=float, default=0.2,
                   help="Validation ratio for the in-memory split "
                        "(--balance-from only)")
    p.add_argument("--split-seed", type=int, default=32,
                   help="Seed for the in-memory split shuffle "
                        "(--balance-from only)")
    p.add_argument("--materialize-augmented", action="store_true",
                   help="Also write the augmented JPEG tree to "
                        "augmented_directory/ (off the training path)")
    kx = p.add_mutually_exclusive_group()
    kx.add_argument("--export-keras", action="store_true", default=None,
                    dest="export_keras",
                    help="Write <out-dir>/leaf_cnn.keras, the reference's "
                         "artifact, loadable by keras.models.load_model "
                         "(leaf_cnn arch only; requires the keras package). "
                         "The default when keras is importable")
    kx.add_argument("--no-export-keras", action="store_false", default=None,
                    dest="export_keras",
                    help="Skip the .keras export even when keras is "
                         "importable")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    p = build_parser()
    args = p.parse_args(argv)
    for name in ("tiny", "small", "base"):
        if getattr(args, name, False):
            args.scale = name
    # torch from here on: --help and flag errors stay fast
    from leaffliction_tpu_torch.parallel.distributed import world_size
    from leaffliction_tpu_torch.parallel.mesh import MeshSpec

    world = world_size()
    try:
        MeshSpec(data=args.mesh_data, model=args.mesh_model).resolve(world)
    except ValueError as exc:
        d, t = max(args.mesh_data, 1), max(args.mesh_model, 1)
        n = d * t
        flags = f"--mesh-data {d}" + (f" --mesh-model {t}" if t > 1 else "")
        p.error(f"--mesh-data: {exc}; to train on {n} devices, launch {n} "
                f"processes with torchrun (python -m torch.distributed.run "
                f"--nproc-per-node {n} -m leaffliction_tpu_torch.cli.train "
                f"... {flags})")
    return args


def resolve_chain_steps(requested: int, device, steps_per_epoch: int
                        ) -> int:
    """`--steps-per-dispatch`: -1 (or any negative) means 8 on a CUDA device
    and 1 on the CPU; then at least 1 and at most the steps of an epoch
    (`leaffliction_tpu/cli/train.py:523-531`)."""
    k = requested
    if k < 0:
        k = 8 if device.type == "cuda" else 1
    return max(1, min(k, steps_per_epoch))


def validate_manifest(manifest: Path) -> Path:
    """Augmented → split fallback (`srcs/cli/train.py:120-148`)."""
    if manifest.exists():
        return manifest
    if manifest.name == "manifest_augmented.json":
        fallback = manifest.with_name("manifest_split.json")
        if fallback.exists():
            LOGGER.warning("Augmented manifest not found, falling back to: %s",
                           fallback)
            return fallback
    raise FileNotFoundError(f"Manifest not found: {manifest}")


def main(argv=None) -> Optional[Dict[str, object]]:
    args = parse_args(argv)
    setup_logging()
    random.seed(args.seed)
    np.random.seed(args.seed)

    fused = args.balance_from is not None
    if fused:
        if not args.balance_from.exists():
            LOGGER.error("Training failed: dataset directory not found: %s",
                         args.balance_from)
            return None
        # before the balance runs: a bad ratio should not cost a decode
        if not (0.0 < args.val_ratio < 1.0):
            LOGGER.error("Training failed: --val-ratio must be in (0, 1), "
                         "got %s", args.val_ratio)
            return None
    else:
        try:
            manifest_path = validate_manifest(args.manifest)
        except FileNotFoundError as exc:
            LOGGER.error("Training failed: %s", exc)
            return None
        _, items = load_manifest(manifest_path)
        train_items = select_items(items, "train")
        val_items = select_items(items, "val")
        if not train_items or not val_items:
            LOGGER.error("Insufficient data (train=%d, val=%d)",
                         len(train_items), len(val_items))
            return None
        label2idx = build_label_mapping(train_items)
        num_classes = len(label2idx)
        LOGGER.info("Classes: %d", num_classes)

    # torch after validation so --help and bad inputs stay fast
    import torch.distributed as dist

    from leaffliction_tpu_torch.parallel.distributed import (
        maybe_initialize,
        shutdown,
    )

    joined = not dist.is_initialized()
    backend = maybe_initialize(args.device)
    joined = joined and backend is not None
    try:
        return _train(args, fused, backend,
                      None if fused else (manifest_path, train_items,
                                          val_items, label2idx))
    finally:
        if joined:  # the group this call joined; a caller's stays
            shutdown()


def _train(args, fused: bool, backend: Optional[str], manifest_mode
           ) -> Optional[Dict[str, object]]:
    """`main` after the inputs were checked and the process group (if
    any) joined."""
    import torch

    from leaffliction_tpu_torch.core.device import resolve_device
    from leaffliction_tpu_torch.core.sysinfo import get_system_info
    from leaffliction_tpu_torch.models.leafcnn import (
        SCALE_PRESETS,
        build_leafcnn,
    )
    from leaffliction_tpu_torch.models.resnet import build_resnet
    from leaffliction_tpu_torch.ops.image import compute_norm_stats
    from leaffliction_tpu_torch.parallel.distributed import rank_device
    from leaffliction_tpu_torch.parallel.mesh import (
        TP_MIN_SIZE,
        MeshSpec,
        check_replicated,
        make_mesh,
    )
    from leaffliction_tpu_torch.parallel.tensor import shard_train_state
    from leaffliction_tpu_torch.train.artifacts import (
        full_state_dict,
        save_training_artifacts,
    )
    from leaffliction_tpu_torch.train.steps import (
        build_step_fns,
        create_train_state,
    )
    from leaffliction_tpu_torch.kernels.build import launch_counts
    from leaffliction_tpu_torch.train.trainer import evaluate, fit

    device = resolve_device(str(rank_device(args.device)))
    mesh = make_mesh(MeshSpec(data=args.mesh_data, model=args.mesh_model),
                     device)
    n_data = mesh.data  # data indices: each holds B rows of the batch
    rank0 = mesh.rank == 0
    if mesh.world > 1:
        LOGGER.info("Mesh %s: rank %d of %d (data %d, model %d) on %s (%s); "
                    "--batch-size %d a data index, global batch %d",
                    mesh.shape, mesh.rank, mesh.world, mesh.data_rank,
                    mesh.model_rank, device, backend, args.batch_size,
                    args.batch_size * n_data)
    if manifest_mode is not None:
        manifest_path, train_items, val_items, label2idx = manifest_mode
        num_classes = len(label2idx)
    else:
        manifest_path = args.balance_from
    cfg = TrainConfig.fast() if args.fast else TrainConfig.regularized()
    if args.lr is not None:
        cfg = dataclasses.replace(cfg, lr=args.lr)
    LOGGER.info("Mode: %s -> %s", "FAST" if args.fast else "REGULARIZED",
                cfg.as_dict())

    fused_dd = None  # ((train images, labels), (val images, labels))
    balance = transform_s = None
    if fused:
        from leaffliction_tpu_torch.data.fused_balance import (
            balance_to_device,
            split_fused_result,
        )

        # every rank balances the same tree with the same seed; rank 0
        # alone writes the manifests (and the JPEG tree)
        res = balance_to_device(args.balance_from, args.img_size,
                                seed=args.seed,
                                materialize=args.materialize_augmented,
                                write_artifacts=rank0, device=device)
        train_rows, val_rows = split_fused_result(
            res, val_ratio=args.val_ratio, split_seed=args.split_seed,
            src_root=args.balance_from, write_artifacts=rank0)
        if len(train_rows) == 0 or len(val_rows) == 0:
            LOGGER.error("Insufficient data (train=%d, val=%d)",
                         len(train_rows), len(val_rows))
            return None
        label2idx = res.label2idx
        num_classes = len(label2idx)
        LOGGER.info("Classes: %d (fused: %d originals + %d augmented; "
                    "train=%d val=%d)", num_classes, res.n_original,
                    res.n_generated, len(train_rows), len(val_rows))
        if args.transform:
            from leaffliction_tpu_torch.data.loader import (
                apply_training_transform_device,
            )

            t_tf = time.perf_counter()
            res.device_images = apply_training_transform_device(
                res.device_images)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            transform_s = time.perf_counter() - t_tf
            LOGGER.info("Training transform applied on device in %.1fs",
                        transform_s)
        labels_dev = torch.from_numpy(res.labels.astype(np.int64)).to(device)

        def rows(sel):
            idx = torch.from_numpy(sel.astype(np.int64)).to(device)
            return (res.device_images.index_select(0, idx),
                    labels_dev.index_select(0, idx))

        fused_dd = (rows(train_rows), rows(val_rows))
        res.device_images = None  # the two gathers are the only copies kept
        if mesh.world > 1:
            for (imgs, labs), split in zip(fused_dd, ("train", "val")):
                check_replicated(imgs, mesh, f"the fused {split} images")
                check_replicated(labs, mesh, f"the fused {split} labels")
        train_store = DeviceImageStore(res.labels[train_rows], args.img_size)
        val_store = DeviceImageStore(res.labels[val_rows], args.img_size)
        train_items = [res.items[i] for i in train_rows]
        val_items = [res.items[i] for i in val_rows]
        balance = {"n_original": res.n_original,
                   "n_generated": res.n_generated,
                   "train": len(train_rows), "val": len(val_rows),
                   "balance_time_s": res.balance_time_s, **res.stages}
        n_train = len(train_items)
        pad_to_steps = None
    else:
        n_train = len(train_items)
        pad_to_steps = None
        if n_data > 1:
            # the same step count on every rank, whatever its shard
            pad_to_steps = global_steps_per_epoch(n_train, args.batch_size,
                                                  n_data)
            train_items = items_for_process(train_items, mesh.data_rank,
                                            n_data)
            LOGGER.info("Data index %d/%d loads %d of %d train items (%d "
                        "steps an epoch)", mesh.data_rank, n_data,
                        len(train_items), n_train, pad_to_steps)
        t_load = time.perf_counter()
        train_store = ImageStore(train_items, label2idx, args.img_size)
        val_store = ImageStore(val_items, label2idx, args.img_size)
        LOGGER.info("Decoded %d train + %d val images in %.1fs",
                    len(train_store), len(val_store),
                    time.perf_counter() - t_load)
        if args.transform:
            from leaffliction_tpu_torch.data.loader import (
                apply_training_transform,
            )

            t_tf = time.perf_counter()
            apply_training_transform(train_store, device=device)
            apply_training_transform(val_store, device=device)
            transform_s = time.perf_counter() - t_tf
            LOGGER.info("Training transform applied in %.1fs", transform_s)

    # --batch-size is per data index: the streamed path iterates this
    # rank's shard at B; the fused path (every rank holds the whole
    # dataset) and the validation set iterate global batches of B×D and
    # each rank takes its data index's rows
    global_batch = args.batch_size * n_data
    train_iter = BatchIterator(train_store, global_batch if fused
                               else args.batch_size, shuffle=True,
                               seed=args.seed, pad_to_steps=pad_to_steps)
    val_iter = BatchIterator(val_store, global_batch, shuffle=False)
    LOGGER.info("Device: %s (%s)", device,
                torch.cuda.get_device_name(device)
                if device.type == "cuda" else "host")

    dtype = torch.float32 if args.no_mixed_precision else torch.bfloat16
    if args.arch == "leafcnn":
        model = build_leafcnn(num_classes, args.scale,
                              separable=args.separable,
                              use_norm=not args.no_normalization,
                              stem=args.stem, dtype=dtype)
    else:
        model = build_resnet(num_classes, args.arch,
                             use_norm=not args.no_normalization,
                             stem=args.stem, dtype=dtype)
    total_steps = train_iter.steps_per_epoch() * args.epochs
    chain_steps = resolve_chain_steps(args.steps_per_dispatch, device,
                                      train_iter.steps_per_epoch())
    if chain_steps > 1:
        LOGGER.info("Chaining %d train steps per dispatch", chain_steps)
    state = create_train_state(model, args.seed, device)

    # adaptive normalization on ≤2048 train samples
    # (`srcs/model/cnn.py:107-131`)
    if not args.no_normalization:
        if fused_dd is not None:
            sample = fused_dd[0][0][:2048]  # already on the device
        else:
            sample = torch.from_numpy(sample_batch(train_store, 2048)).to(
                device)
        mean, var = compute_norm_stats(sample)
        if mesh.world > 1:  # the ranks start equal: rank 0's statistics
            mean, var = mesh.broadcast(torch.stack([mean, var]))
        with torch.no_grad():
            state.model.norm_mean.copy_(mean)
            state.model.norm_var.copy_(var)
        LOGGER.info("Adapted normalization: mean=%s", mean.cpu().numpy())
    # tensor parallelism: every rank keeps its channel blocks of the
    # tensors JAX's rule shards, decided on the final state
    if mesh.model > 1:
        plan = shard_train_state(state, mesh, TP_MIN_SIZE)
        n_params = sum(plan[k] for k in state.params)
        n_stats = sum(plan[k] for k in state.batch_stats)
        LOGGER.info("Tensor parallelism: %d state leaves sharded over "
                    "model=%d", 4 * n_params + 2 * n_stats, mesh.model)
    step_fns = build_step_fns(cfg, num_classes, total_steps, mesh=mesh)

    preset = SCALE_PRESETS[args.scale]
    meta = {
        "run": {"seed": args.seed, "epochs": args.epochs,
                "batch_size": args.batch_size},
        "data": {"manifest": str(manifest_path.resolve()),
                 "img_size": args.img_size, "num_classes": num_classes,
                 "train_items": n_train,
                 "val_items": len(val_items)},
        "model": {"name": ("leaf_cnn" if args.arch == "leafcnn"
                           else args.arch),
                  "scale": args.scale,
                  "separable": bool(args.separable),
                  "stem": args.stem,
                  "use_normalization": not args.no_normalization,
                  "widths": list(preset["widths"]),
                  "drop_block": preset["drop_block"],
                  "drop_top": preset["drop_top"],
                  "l2": cfg.weight_decay},
        "training": {"optimizer": cfg.optimizer, "base_lr": cfg.lr,
                     "cosine_decay": bool(cfg.cosine_decay),
                     "label_smoothing": cfg.label_smoothing,
                     "ema_decay": cfg.ema_decay, "clipnorm": cfg.clipnorm,
                     "mixed_precision": not args.no_mixed_precision},
        "system": dict(get_system_info(device), mesh=mesh.shape),
    }
    if mesh.world > 1:  # the JAX meta's keys, plus the collectives' backend
        meta["system"]["collective_backend"] = backend

    # the uint8 dataset stays on the device unless it is too large for it
    # (the fused path's dataset is on the device already)
    dataset_bytes = train_store.images.nbytes + val_store.images.nbytes
    device_dataset = (fused_dd is None and not args.no_device_dataset
                      and mesh.world == 1 and dataset_bytes < 6e9)
    if device_dataset:
        LOGGER.info("Device-resident dataset enabled (%.0f MB)",
                    dataset_bytes / 1e6)

    opts = _resume(args, state)
    saver = _checkpointing(args, opts, train_iter.steps_per_epoch(), mesh)
    with contextlib.ExitStack() as stack:
        if saver is not None:
            stack.callback(saver.close)  # commit the save in flight
        prof = None
        if args.profile_dir is not None and rank0:
            from torch.profiler import ProfilerActivity, profile

            args.profile_dir.mkdir(parents=True, exist_ok=True)
            prof = stack.enter_context(profile(activities=[
                ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if device.type == "cuda" else [])))
            LOGGER.info("Profiler started -> %s", args.profile_dir)
        trace.clear()  # the counters logged below are this run's
        result = fit(step_fns, state, train_iter, val_iter, cfg,
                     epochs=args.epochs, seed=args.seed,
                     target_val_acc=args.target_val_acc,
                     device_dataset=device_dataset,
                     train_device_data=fused_dd[0] if fused_dd else None,
                     val_device_data=fused_dd[1] if fused_dd else None,
                     chain_steps=chain_steps, **opts)
    if prof is not None:
        trace_path = args.profile_dir / "train_trace.json"
        prof.export_chrome_trace(str(trace_path))
        LOGGER.info("Profiler trace written to %s", trace_path)
    LOGGER.info("Training done: %d steps in %.1fs (%.1f images/sec), "
                "val_acc=%.4f (%s)", result.steps_ran, result.train_time_s,
                result.images_per_sec, result.val_accuracy,
                result.best_variant)
    LOGGER.info("Trace counters: %s; kernel launches: %s", trace.counters(),
                launch_counts())

    _, _, y_true, y_pred = evaluate(
        step_fns, result.state, val_iter,
        device_data=fused_dd[1] if fused_dd else None)
    if mesh.data_rank == 0:  # gathered over the model group when sharded
        full = full_state_dict(result.state)
    if rank0:  # one writer for the shared out-dir
        save_training_artifacts(args.out_dir, result.state, label2idx,
                                result.history, result.best_variant, y_true,
                                y_pred, meta=meta, state_dict=full)
        if args.export_keras is not False:
            _export_keras_artifact(model, full, args)
    return {"fit": result, "balance": balance, "transform_s": transform_s,
            "mesh": mesh}


def _export_keras_artifact(model, state_dict, args) -> None:
    """Write the reference's `.keras` artifact next to the msgpack, from
    the same weights (`state_dict`, the saved variant's full state), and
    record it in meta.json (`keras_file`). Never fails the run: keras
    missing, another architecture, a shape mismatch inside
    `export_keras` or a meta.json rewrite error each log a warning (the
    first two only for an explicit `--export-keras`) and return."""
    from leaffliction_tpu_torch.train.keras_export import (
        export_keras,
        keras_available,
    )

    explicit = args.export_keras is True
    if args.arch != "leafcnn":
        if explicit:
            LOGGER.warning("--export-keras supports the leaf_cnn "
                           "architecture only; skipping for %s", args.arch)
        return
    if not keras_available():
        # the default-on path quietly lacks the optional artifact on
        # installs without keras
        if explicit:
            LOGGER.warning("--export-keras requested but the keras package "
                           "is not importable; skipping")
        return
    try:
        kpath = export_keras(model, state_dict, args.img_size,
                             Path(args.out_dir) / "leaf_cnn.keras")
        meta_path = Path(args.out_dir) / "meta.json"
        meta_json = json.loads(meta_path.read_text())
        meta_json["keras_file"] = str(kpath)
        meta_path.write_text(json.dumps(meta_json, indent=2))
        LOGGER.info("Keras artifact exported: %s", kpath)
    except Exception as exc:
        LOGGER.warning(".keras export failed (run artifacts are intact): %s",
                       exc)


def _resume(args, state) -> Dict[str, object]:
    """`fit`'s start from `--resume`: the latest checkpoint in
    `<out-dir>/checkpoints` restored into `state` in place, the generator's
    saved state, and where to start (a step checkpoint: its epoch, skipping
    the steps it had run, and its meta's history; an epoch checkpoint: the
    next epoch and `history.json`)."""
    from leaffliction_tpu_torch.train import checkpoint as ck

    ckpt_dir = args.out_dir / "checkpoints"
    opts: Dict[str, object] = {"start_epoch": 0, "skip_steps": 0,
                               "history": None, "generator_state": None}
    if not args.resume:
        return opts
    latest = ck.latest_resume_step(ckpt_dir)
    if latest is None:
        LOGGER.warning("No checkpoint found in %s; training from scratch",
                       ckpt_dir)
        return opts
    _, opts["generator_state"] = ck.restore_resume_checkpoint(
        ckpt_dir, latest, state)
    meta = ck.read_step_meta(ckpt_dir, latest)
    if meta is not None:
        opts["start_epoch"] = int(meta["epoch"])
        opts["skip_steps"] = int(meta["step_in_epoch"])
        opts["history"] = meta.get("history")
        LOGGER.info("Resumed from step checkpoint: epoch %d, step %d",
                    opts["start_epoch"] + 1, opts["skip_steps"])
    else:
        opts["start_epoch"] = latest + 1
        hist_file = ckpt_dir / "history.json"
        if hist_file.exists():
            opts["history"] = json.loads(hist_file.read_text())
        LOGGER.info("Resumed from checkpoint at epoch %d", latest + 1)
    return opts


def _checkpointing(args, opts: Dict[str, object], steps_per_epoch: int,
                   mesh):
    """Add `fit`'s checkpoint callbacks to `opts` (`--checkpoint-every`:
    a synchronous save and `history.json` every N epochs;
    `--checkpoint-every-steps`: the asynchronous step checkpointer, whose
    meta holds the same history dict that `fit` extends) → the step
    checkpointer, or None. Data parallel, rank 0 alone writes (the ranks'
    states are the same); tensor parallel, data index 0's model group
    gathers the state and rank 0 writes it; the step checkpointer's
    `close` waits for every rank."""
    from leaffliction_tpu_torch.parallel.tensor import full_sections
    from leaffliction_tpu_torch.train import checkpoint as ck

    ckpt_dir = args.out_dir / "checkpoints"
    gathers = mesh.model > 1 and mesh.data_rank == 0
    if args.checkpoint_every > 0 and (mesh.rank == 0 or gathers):
        def epoch_callback(epoch, st, hist, generator):
            if (epoch + 1) % args.checkpoint_every == 0:
                if mesh.rank != 0:  # its part of rank 0's gather
                    full_sections(st)
                    return
                ck.save_resume_checkpoint(ckpt_dir, epoch, st, generator)
                tmp = ckpt_dir / "history.json.tmp"
                tmp.write_text(json.dumps(hist))
                tmp.replace(ckpt_dir / "history.json")
                LOGGER.info("Checkpoint saved at epoch %d", epoch + 1)

        opts["epoch_callback"] = epoch_callback
    if args.checkpoint_every_steps <= 0:
        return None
    saver = ck.AsyncStepCheckpointer(ckpt_dir, args.checkpoint_every_steps,
                                     mesh=mesh if mesh.world > 1 else None)
    if opts["history"] is None:
        opts["history"] = {"loss": [], "accuracy": [], "val_loss": [],
                           "val_accuracy": []}
    history = opts["history"]

    def step_callback(epoch, step_in_epoch, st, generator):
        saver.maybe_save(epoch * steps_per_epoch + step_in_epoch, st,
                         {"epoch": epoch, "step_in_epoch": step_in_epoch,
                          "history": history}, generator)

    opts["step_callback"] = step_callback
    return saver


if __name__ == "__main__":
    main()
