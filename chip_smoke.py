#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main paths on one GPU: serving,
training, the fused balance, the materialising balance, the segmentation
and analysis transforms, resume with step checkpoints, data parallelism
(two ranks sharing the card, and the serving mesh), tensor parallelism
(four and two ranks sharing the card), multi-step dispatch (CUDA graphs
of K train steps), FLOP counts with MFU and the streamed train path, with
LeafCNN and the ResNet backbone.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with one CUDA card. It imports
nothing of JAX. Phases, each printed on its own line with the card's name and
power limit; any failure raises and the script exits non-zero without
printing a result:

1. the device, and `nvidia-smi` name and power limit;
2. the build of the CUDA kernels from `leaffliction_tpu_torch/csrc` (nvcc);
3. K4, connected-components propagation to the fixpoint in one launch
   (`cc_propagate`), against its plain twin (the host loop over the round)
   on the card: masks [8,224,224] at densities 0.2/0.5/0.8 with the full
   round limit (h + w) and with a limit of 3 that binds (the shared-memory
   kernel), and [1,291,291] (the global-memory kernel); labels and
   per-image rounds exact;
4. K5, the Canny front end (one launch a call), against its twin on the
   card: [8,224,224] and [1,224,224], L1 and L2, bit-equal (torch.equal);
5. K1, the fused train augmentation, against its twin on the card at
   [32,224,224,3], angles in +-18 degrees: uint8 -> f32 <= 2^-23 (both
   divide exactly; the kernel's channel sums run in another order than
   torch.sum, read alone with contrast factor 0), uint8 -> bf16 <= 2^-8
   (the single-launch shared-memory kernel), f32 in without
   contrast (the rotation alone, multi-pass) exact, angle 0 with factor 1
   the dequantised input within 1e-6;
6. serving: a leafcnn-base 224 px / 8-class / bf16 artifact dir written from
   --seed (flax layout), loaded by `ModelLoader`, 256 images through the
   `Predictor`; probabilities finite, rows summing to 1 +- 1e-3, and the first
   8 rows within 2e-2 of the port's f32 forward on the CPU;
7. the mask montage (`generate_mask_visualization`) on 8 leaf-like 224²
   images; K4 and K5 must have launched, and each mask agrees with the CPU
   plain path on >= 99.9% of pixels; K4 launches per mask, and rounds per
   mask from the kernel's own device counts (read after the montage);
8. where PIL is installed, the predict CLI in batch mode in a subprocess;
9. one f32 train step, card against CPU: leafcnn-tiny 64 px, batch 8, TF32
   off, augmentation and dropout off, on the first input draw (seeds 11 to
   26, for each backend) on which the card and the CPU make the same ReLU
   and max-pool decisions (`Decisions`: a value within rounding of 0 or
   of a tie sends a gradient elsewhere on one side); with cuDNN off,
   loss within 1e-4 relative and every gradient within 1e-3 relative L2;
   with cuDNN on (the backend training runs), loss within 1e-4, all
   gradients together within 1e-3 relative L2 and each within 1e-2;
10. training at full width: leafcnn-base 224 px, batch 32, bf16, REGULARIZED,
   augmentation on, over a device-resident uint8 dataset of leaf-like images:
   30 steps on one fixed batch (the last loss below the first), then 25
   timed steps on gathered batches; every loss finite and K1 launched once
   per step; ms/step (CUDA events, median) and img/s;
11. where PIL is installed, the train CLI (2 epochs, 224 px, batch 32) on a
   JPEG tree of 8 classes x 32 images, then the predict CLI on its
   artifacts, each in a subprocess with rc 0;
12. timings: serving per 64-batch, ms per mask (with K4 launches and
   rounds per mask), K4 per `_propagate` at [1,224,224] and [8,224,224]
   (the shared-memory kernel) and [1,291,291] (the global one) with its
   time per round, K5 at [8,224,224] and at [1,224,224] (the montage's
   shape) with its blocks per image and the host cost of each piece of a
   wrapper (device check, stream lookup, output allocation, ctypes), K1
   at 32 and 128 x 224² (bf16 out) and K1's f32 mode at [32,224,224,3];
   each kernel's kernel-only device time and launches per call
   (torch.profiler), its wrapper-included time over back-to-back calls
   (CUDA events) and its twin's; then K1 (8 to 128 images) and K2 (16 to
   128) by batch size, the blocks per image each launch takes and its
   kernel-only time;
13. the balancing kernels against their twins on the card at the fused
   device batch [64,224,224,3] of leaf-like images: K2 (expand rotation,
   angles in +-30 degrees), K3 (cubic shear, s in +-0.2, both directions),
   K6 (opt-in distortion, cutoffs in 0-2 %, seeds); each max |diff| and the
   share of differing values: all three exact (torch.equal, the gate);
14. the fused balance -> split -> train command at full width, in process:
   `cli.train.main(["--balance-from", tree, ...])` at leafcnn-base 224 px,
   batch 32, bf16, REGULARIZED, 2 epochs, over a 256² JPEG tree with the
   north-star class profile (Apple 220/200/200/195, Grape 190/185/180/160:
   1,530 originals, 110 augmentations by the per-plant plan); K1, K2 and K3
   each launched, and the images of each K3 call recorded; counts,
   artifacts, the balance's stage seconds and generated img/s, the
   command's wall; then the predict CLI serves the trained model (rc 0);
15. the opt-in K6 path: the same balance with and without
   LEAF_PALLAS_DISTORT=1; K6 launched, the images of each K6 call
   recorded, every non-distortion row byte-equal, each distortion row
   correlated > 0.8 with its source, noisy (mean |diff| > 1) and stretched
   to <= 5 and >= 250; the sha256 of the distortion rows (two trees' runs
   at one seed compare their Philox streams by it);
16. timings: K2, K3 and K6 per 64-batch, kernel only (torch.profiler) and
   wrapper included (CUDA events), beside their twins; K3 and K6 also at
   the images of the command's own calls (phases 14 and 15), each held
   exact against its twin there, with its blocks per image (K6: the
   cluster size) and its bound; and each balancing op (parameters drawn
   once) per 64-chunk;
17. ResNet serving: resnet18 (conv stem) 224 px / 8-class / bf16 artifact
   dir written from --seed (flax layout), loaded by `ModelLoader`, 256
   images through the `Predictor`, with phase 6's gates (finite, rows sum
   to 1 +- 1e-3, the first 8 rows within 2e-2 of the f32 CPU forward); ms
   per 64-batch end to end, upload and forward, forward on the device;
   then resnet10 (s2d stem) on 64 images with the same gates;
18. phase 9's step check with resnet10 (64 px, batch 8, f32, TF32 off,
   dropout and augmentation off), cuDNN off and on, at phase 9's
   tolerances;
19. ResNet training at full width: resnet18 224 px, bf16, REGULARIZED,
   augmentation on, over a device-resident uint8 set of 256 leaf-like
   images, at b128 (20 fixed-batch then 10 timed steps) and b32 (30 then
   15): the last fixed-batch loss below the first, every loss finite, K1
   launched once per step; median ms/step (CUDA events), img/s, peak GB;
20. where PIL is installed, the train CLI with `--arch resnet10 --stem
   s2d` (1 epoch, 224 px, b32) on phase 11's JPEG tree and the predict
   CLI in batch mode on its artifacts, each in a subprocess with rc 0;
   then the predict CLI in single mode in process (the montage: K4 and
   K5 launched);
21. the JPEG-materialising balancer (`data/balancer.DatasetBalancer`) on
   the card, in process: (a) phase 14's north-star tree at its native 256²
   (110 generated): per-class counts equal the plan, the
   `manifest_augmented.json` totals, each rotate output at PIL's expanded
   size for its f32 angle, K2 and K3 launched; the wall and the copy,
   decode, upload, device, download-wait, encode and manifest seconds;
   (b) `bench.py`'s balancer tree (Apple 260 / 60 at 224², 200
   generated), 3 runs: generated img/s median, min and max; (c) the host
   pool (`LEAF_BALANCE_BACKEND=host`) and the device backend on tree (a),
   both with LEAF_STRICT_DISTORTION=1 and PIL's codec: the same file
   names and the same sha256 for every distortion file; the host pool's
   img/s; the device run, untimed, holds every K2 and K3 call exact
   against its twin at the image counts 21a ran; (d) a tree with one plant a source shape (256², 320², 16×200,
   200×16, 64×48) under LEAF_PALLAS_DISTORT=1: every K2, K3 and K6 call
   held exact against its twin on the same inputs, each shape reached,
   each plant balanced; (e) the augment CLI on one 256² image (7 files)
   and on tree (a), each alone, then the distribution and split CLIs on
   tree (a) side by side, each in a subprocess with rc 0, their CSVs and
   manifests counting every image;
22. the segmentation and analysis slice on 64 leaf-like 256² JPEGs with
   brown spots, at the default `config.yaml` (inclusive strategy, GrabCut,
   masks at the 1.3× upscale, 333²): (a) the single-image transform CLI
   with the default types in a subprocess on the card and with `--device
   cpu`, each writing the JAX CLI's file set (no Hist figure where
   matplotlib is missing), and `make_mask` card against CPU on >= 99.9% of
   pixels; (b) folder mode in process, timed: images/s and the decode,
   masks, filters and encode seconds, K4 and K5 launches per image and
   each call's shape and K4 kernel (shared memory or global); (c) folder
   mode again with every K4 and K5 call held exact against its twin at the
   call's own shape; (d) ms per mask at 333² and 256², chunks of 16 and 1,
   and K4 per call on the inclusive candidate at [16,333,333] and
   [1,256,256] (kernel only, wrapper included, twin, rounds); (e) `train
   --transform` for 1 epoch in manifest mode (phase 11's manifest) and with
   `--balance-from` (phase 14's tree): the transform's seconds;
23. resume on the train path, in process, on phase 11's manifest
   (leafcnn-base 224 b32 bf16 REGULARIZED, K1 on, cuDNN deterministic in
   this phase only, `--steps-per-dispatch 1` on every run): (a) a 3-epoch train CLI run under `--profile-dir`, (b)
   the same with `--checkpoint-every-steps 2` killed by an exception at
   step 4 of epoch 2, (c) `--resume` to the end; (c)'s final state (model,
   moments, EMA), step, lr_scale and generator state against (a)'s,
   expected bit-equal and held at 1e-3 relative L2 a tensor, the last
   epoch's loss at 1e-4; (a)'s Chrome trace holds a K1 kernel, a
   convolution kernel and `aten::cudnn_convolution`; then a subprocess run
   SIGKILLed once a step meta of epoch 2 has committed, resumed in process
   to its artifacts; every K1 call of these runs held against its twin
   (its bf16 output at 2^-8, the same inputs in f32 at 2^-23); then phase
   10's step in alternating blocks without and with `maybe_save` every
   step (cadence 2): median ms per step (CUDA events), `maybe_save`'s host
   µs a call (saves and skips apart) and each save's wall;
24. the library functions no CLI calls: `ops/geometry.homography_warp` at
   [8,224,224,3] (rotations, expand, shears, perspective, identity;
   reflected and filled borders) card against CPU within 1e-3 on [0, 255];
   `utils/mask_utils.apply_morphological_operations` card against CPU
   exactly (4 operations, 2 sizes, 3 masks); `evaluate_from_manifest` with
   phase 11's trained model on the manifest's val split;
25. data parallelism on the one card: two ranks share cuda:0 over gloo
   (NCCL refuses two ranks on one GPU), spawned with torch.multiprocessing,
   each setting torchrun's variables and joining through `parallel/`:
   (a) leafcnn-base 64 px f32 (TF32 off, cuDNN deterministic), 8 images a
   rank, 5 steps with augmentation and dropout, against one process at 16
   images from the same seed, whose first step runs on the ranks' ReLU and
   max-pool decisions (`Decisions`: the ranks' statistics summed in
   another order move values within rounding of 0 or of a tie, 1-8 of
   15 million on an H100, and such a flip moves the gradients by up to
   3e-3): the first step at phase 9's cuDNN bars (loss
   within 1e-4 relative, the global gradients all together within 1e-3
   relative L2 and each within 1e-2), the ranks' states bit-equal after
   the 5 steps; each later step's loss and the final parameters are held
   against a control read in the same run, the one process again with
   cuDNN off (Adam's first updates of near-zero gradients turn any
   summation order's rounding into ±lr flips): each within the larger of
   phase 9's bar (loss 1e-4, parameters 1e-3 relative L2) and 3x the
   control's drift at that step; (b) the train CLI
   on both ranks in process (leafcnn-base 224 px bf16, --batch-size 32 a
   rank, global 64, 2 epochs on phase 11's manifest), every K1 call held against
   its twin (phase 5's bars): artifacts written once, by rank 0, meta.json
   mesh {"data": 2, "model": 1} and backend gloo, a finite train loss that
   falls, the ranks' states bit-equal; ms per step and global img/s beside
   phase 10's one rank, and the host share of the steps spent in
   all_reduce; (c) `--balance-from` on phase 14's tree on both ranks, every
   K1, K2 and K3 call held against its twin: `check_replicated` on the four
   fused tensors, the manifests written by rank 0 alone, a finite history;
   (d) `Predictor(devices=[cuda:0, cuda:0])` against the one-device
   predictor on 256 images for leafcnn-base and resnet18: f32 within 1e-4,
   bf16 top-1 equal with the largest |dp| printed; the predict CLI's
   `--mesh-data 2` exits 1 with "does not cover 1 devices".
26. Tensor parallelism on the one card, the ranks sharing cuda:0 over
   gloo (`spawn_ranks`): (a) phase 25a's leafcnn-base f32 run on data 2 x
   model 2 (four ranks, the state sharded at JAX's `min_size` 64) against
   one process and its control at 25a's bars, every rank's gathered
   state bit-equal and each rank's blocks bit-equal across its data
   group; (b) resnet10 64 px f32 on 1 x 2, 8 images, 3 steps, against one
   process and its cuDNN-off control at the same bars; in (a) and (b) the
   one process's first step runs on the ranks' decisions, as in 25a; (c)
   the train CLI with `--mesh-data 1 --mesh-model 2` on phase 11's manifest (224 px
   bf16, b32, 2 epochs), every K1 call held against its twin: artifacts
   written once, by rank 0, meta mesh {"data": 1, "model": 2}, a finite
   train loss that falls, the ranks' states bit-equal, the saved model
   served by the one-device predictor at phase 6's gates; ms per step and
   img/s beside phase 10's one rank and phase 25b, the bytes gathered and
   all-reduced a step and the host share of the step in the model group's
   collectives.
27. multi-step dispatch (`train/graph.py`): (a) leafcnn-base 224 b32 bf16
   REGULARIZED and resnet18 224 b32 FAST, 16 steps from one state and
   generator as two replays of a K = 8 CUDA graph against 16 eager steps,
   cuDNN deterministic: each state tensor within 1e-3 relative L2
   (phase 23's gate; bit-equal expected), the step and the generator
   state equal, K1 launched 16 times eagerly and 16 plus the graph's one
   warm-up step chained; (b) leafcnn-base b32 and
   resnet18 b128 (REGULARIZED): ms a step from CUDA events around each
   replay over K (median, min, max) beside the eager step in the same run,
   the capture's seconds, the graph pool's and the peak GB, the replays'
   busy share and K1 kernel events (torch.profiler, one replay: K of them);
   (c) the train CLI at its defaults (K =
   min(8, steps an epoch), logged) and with `--steps-per-dispatch 1` on
   phase 11's manifest, 2 epochs: wall and ms a step of each; (d) `--steps-
   per-dispatch 2 --checkpoint-every-steps 2`, 3 epochs, killed after the
   chunk that ends at step 4 of epoch 2, then `--resume`, against the same
   chained run uninterrupted under `--profile-dir`, at phase 23's gates,
   one callback a dispatch, the uninterrupted run's K1 launches equal to
   its trace's K1 kernel events. In every part K1's launches equal the
   steps run plus one warm-up step a train graph (the replays add the
   launches their graph holds; the warm-ups run on the card);
28. FLOPs and MFU (`train/flops.py`, torch's count of convolutions and
   matrix products, forward and backward, against the card's dense bf16
   peak by its name): (a) `bench.py`'s six train steps at 224 px, bf16
   REGULARIZED (leafcnn-base b32, s2d b32 and b128; resnet18 b128, s2d
   b128 and b32), one eager step each on a fresh state, every K1 call held
   against its twin at phase 5's bars: GFLOP a step and an image, each
   equal to batch / 2 × the CPU's count of the same function at batch 2,
   exactly; (b) MFU (median, min, max) of 27b's chained and eager
   leafcnn-base b32 and resnet18 b128 steps, and of the other four chained
   (a K = 5 graph: its first chunk untimed, then 2 replays timed by CUDA
   events, 10 steps); K1's launches equal the steps run plus one warm-up
   step a graph; (c) the served forward (`Predictor._infer`, 64 images)
   of phase 12's leafcnn-base and phase 17's resnet18: GFLOP, equal to 32
   × the CPU's count at 2 images, and the MFU of phases 12's and 17's
   forward ms; every MFU in (0, 1];
29. the streamed train path (`train/trainer.prefetch_to_device`: pinned
   staging buffers, copies on a side stream, events) and the `.keras`
   artifact: (a) whether keras is importable; without it, phase 11's train
   CLI wrote neither `leaf_cnn.keras` nor `keras_file` and logged no
   warning about it; with it, phase 11's model exported and served through
   the `.keras` branch of `ModelLoader` at phase 6's gates; (b)
   leafcnn-base 224 b32 bf16 REGULARIZED in one process over 128 leaf-like
   images held on the host and on the card, cuDNN deterministic: 16 steps
   streamed and gathered, eagerly and as two K = 8 replays, every state
   bit-equal to the eager gather steps' (266/266 tensors, the step and
   the generator state), every eager K1 call held against its twin (phase
   5's bars); then ms a step of either path from CUDA events between
   consecutive dispatches (the waits for uploads and for the host
   included; median, min, max), eager in turns and chained, the pinned and
   pageable host-to-device GB/s and bytes a step, the replays' busy share
   and K1 kernel events; (c) the train CLI with `--no-device-dataset` on
   phase 11's manifest, 2 epochs, in process: wall, ms a step, beside
   phase 11's subprocess wall; K1 launched once a step plus one warm-up
   step a graph;
30. the BatchNorm (+ReLU) kernels (`csrc/batch_norm.cu`): (a) at every
   BatchNorm shape of the train cells (leafcnn-base b32, resnet18 b128),
   bf16 channels-last, ReLU on and off, the module's forward (with the
   running update) and backward held against the plain twin on the same
   inputs at the `gpu` tests' tolerances (`bn_held_to_twin`; a mismatch
   fails the smoke); (b) at the cells' largest BatchNorm shapes ([32, 32,
   224, 224] and [128, 64, 112, 112], ReLU on): each of the four kernels
   (statistics, normalise, gradient sums, dx) kernel only (torch.profiler,
   the finalisation apart), through its wrapper (CUDA events) and its
   twin's passes (plain PyTorch on the card), with its bytes bound at
   3.35 TB/s; the forward and the backward whole, kernels against twin
   (`tools/smoke_batch_norm.py` runs it alone);
31. the residual blocks' exit (`csrc/block_exit.cu`): (a) at every exit
   of the train cells (leafcnn-base b32's four stages: SE, shortcut, ReLU,
   spatial dropout, 2x2/2 pool; resnet18 b128's stem pool, 3x3/2 SAME,
   and its blocks' exits at four widths), bf16 channels-last, the
   kernels' forward and backward held against the plain twin on the same
   inputs: the output and the pool's picks bit-equal, dy and d_shortcut
   within one bf16 step, the SE gate's gradient within the `gpu` tests'
   bound (`exit_held_to_twin`; a mismatch fails the smoke); (b) at three
   of those shapes, the forward and backward kernels (the finalisation
   apart) kernel only, through the wrapper, and the twin's whole eager
   chain, forward and backward, each with its bytes bound at 3.35 TB/s
   (`tools/smoke_block_exit.py` runs it alone).

Kernel launch counts are reset just before each main path and read right
after it: serving (phases 6-7) for K4 and K5, training (phase 10) for K1,
the fused command (phase 14) for K1, K2 and K3, the opt-in balance (phase
15) for K6, ResNet training (phase 19, each batch size) for K1, the
ResNet single mode (phase 20) for K4 and K5, the materialising
balancer (phase 21 a and d) for K2, K3 and K6, the transform folder run
(phase 22b) for K4 and K5, `train --transform` (phase 22e) for K4, K5,
K1, K2 and K3, the resume runs (phase 23: (a), (b), (c) and the resume
after the SIGKILL, in process) for K1, each rank's train CLI runs
(phase 25 b and c, in the rank's process) for K1, K2 and K3, each
rank's train CLI run of phase 26c for K1, phase 27's eager,
warm-up and replayed steps and train CLI runs (a to d) for K1, and phase
28's counted steps (a) and its graphs' warm-up and replayed steps (b) for
K1, and phase 29's steps (b, both parts) and train CLI run (c) for K1;
a kernel's
`launches` is the sum over the paths that run it. The BatchNorm kernels'
counters are set to 0 at the same points of the training paths of phase
10, 19 (each batch size) and 27 (a, eager and replayed, and c) and held
there (`bn_held`): each BatchNorm layer runs the four kernels and two
finalisations in every train step and warm-up step, the normalise in
every eval forward, and nothing is copied into or out of channels-last;
so are the exit's (`exit_held`): each exit (a LeafCNN stage, a ResNet
block, the ResNet's stem pool) runs the forward and backward kernels in
every train step and warm-up step, the finalisation where it has SE, the
forward in every eval forward, and nothing is copied. The last lines are the card's name and power limit, a JSON line
of per-kernel results (`ms` the kernel-only device time, `call_ms` the
wrapper-included time, each with its bound: the larger of the bytes it must
move over 3.35 TB/s and its operations over 67 T/s, the H100's published
memory and 32-bit non-tensor rates), and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
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
FUSED_BATCH, NATIVE = 64, 256
# the north-star tree: 1,530 originals, 8 classes, 110 augmentations
NORTH_STAR = {"Apple": (220, 200, 200, 195), "Grape": (190, 185, 180, 160)}
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


# the H100 SXM's published rates (NVIDIA's data sheet): HBM bytes/s,
# and the float32 rate outside the tensor cores, taken for every 32-bit
# operation on the CUDA cores (integer ones too, so the bound stays a floor)
HBM_BYTES_PER_S, OPS_PER_S = 3.35e12, 67e12


def bound(nbytes: float, ops: float):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move `nbytes` (each input read once, each output written once) and do
    `ops` 32-bit operations, whichever is longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


@contextlib.contextmanager
def k4_rounds_recorded():
    """Keep the int32 [n] round counts of every `cc_propagate` call that
    `_propagate` makes, without reading them (no sync): a list, read by the
    caller after the block."""
    from leaffliction_tpu_torch.ops import components

    real, kept = components.cc_propagate, []

    def recording(labels, mask, limit):
        out, rounds = real(labels, mask, limit)
        kept.append(rounds)
        return out, rounds

    components.cc_propagate = recording
    try:
        yield kept
    finally:
        components.cc_propagate = real


@contextlib.contextmanager
def images_recorded(name: str):
    """The image count of every call the balancing ops make to the kernel
    wrapper `name` (`shear_cubic` or `distortion`, as `ops.augment` holds
    them): a list, read by the caller after the block."""
    from leaffliction_tpu_torch.ops import augment

    real, kept = getattr(augment, name), []

    def recording(imgs, *args):
        kept.append(int(imgs.shape[0]))
        return real(imgs, *args)

    setattr(augment, name, recording)
    try:
        yield kept
    finally:
        setattr(augment, name, real)


def host_us(fn, iters: int = 2000) -> float:
    """Mean host time of fn() in microseconds (host clock, after a warm-up)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def wrapper_pieces(torch, gray):
    """The host cost (µs) of each piece of K5's wrapper on `gray`, as every
    wrapper runs them: the checks, `contiguous`, the output, the device
    index, the raw stream handle, the library handle, and one ctypes call
    (one that launches nothing)."""
    from leaffliction_tpu_torch.kernels import build

    lib = build.load()

    def checks():
        return (gray.is_cuda and gray.dim() == 3
                and gray.dtype == torch.float32 and gray.shape[1] >= 3)

    pieces = {
        "checks": checks,
        "contiguous": gray.contiguous,
        "empty_like": lambda: torch.empty_like(gray),
        "get_device": gray.get_device,
        "raw_stream": lambda: build.current_stream(gray.get_device()),
        "build_load": build.load,
        "ctypes_call": lambda: lib.leaf_edge_nms_tiles(SIZE, SIZE),
    }
    return {k: round(host_us(fn), 3) for k, fn in pieces.items()}


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean time of fn() in ms over back-to-back calls, wrapper included, by
    CUDA events after a warm-up."""
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


def forward_ms(torch, model, x64) -> float:
    """The served forward on the card: an uploaded uint8 [64, S, S, 3]
    batch → probabilities, ms by `cuda_ms` over 10 calls."""
    with torch.inference_mode():
        return cuda_ms(torch, lambda: torch.softmax(
            model(x64.float() / 255.0), -1), 10)


# the kernels of each wrapper, by name fragment (torch.profiler's keys)
KERNEL_NAMES = {
    "cc_propagate": ("cc_smem_kernel", "cc_global_kernel"),
    "edge_nms": ("edge_nms_tile",),
    "train_aug": ("train_aug_smem",),
    "train_aug_f32": ("row_pass", "col_pass", "rotation_controls_kernel"),
    "rotate_expand": ("rotate_expand_smem",),
    "shear_cubic": ("shear_cubic_band", "shear_cubic_simple"),
    "distortion": ("distortion_cluster", "distortion_simple"),
    "bn_stats": ("StatsOp",),
    "bn_apply": ("ApplyOp",),
    "bn_grad_reduce": ("GradOp",),
    "bn_dx": ("DxOp",),
    "bn_finalize": ("bn_finalize",),
    "exit_forward": ("exit_forward",),
    "exit_backward": ("exit_backward",),
    "exit_finalize": ("exit_finalize",),
}


def kernel_ms(torch, fn, kernel: str, iters: int):
    """(kernel-only device ms, kernel launches) per call of fn(): the
    device time torch.profiler records for the kernels named by
    KERNEL_NAMES[kernel], over `iters` calls after a warm-up. The profiler's
    device tracing can start late and miss launches, so each profile runs
    the calls in a warm-up step of its schedule (traced, discarded) and
    records the second; a profile that still missed some is taken again (up
    to five times, each logged), and the last resort is the profile that
    recorded the most launches, each kernel's mean time per recorded launch
    counted as many times a call as it launched, rounded. If no profile
    recorded a launch, it raises."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    best = []
    for attempt in range(1, 6):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                time.sleep(0.05)
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        seen = [(e.count, float(getattr(e, "self_device_time_total",
                                        getattr(e, "self_cuda_time_total",
                                                0.0))))
                for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")
                and any(f in e.key for f in KERNEL_NAMES[kernel])]
        if sum(n for n, _ in seen) > sum(n for n, _ in best):
            best = seen
        if seen and all(n % iters == 0 for n, _ in seen):
            break
        log("profiler", kernel=kernel, attempt=attempt,
            launches_recorded=sum(n for n, _ in seen), calls=iters)
    ms, launches = 0.0, 0
    for n, us in best:
        per_call = max(1, round(n / iters))
        ms += us / 1e3 / n * per_call
        launches += per_call
    if not (launches and ms > 0):
        raise AssertionError(f"the profiler saw no device time for {kernel}")
    return ms, launches


def timed(torch, kernel: str, fn, plain, iters: int, plain_iters: int):
    """{"ms", "launches", "call_ms", "plain_ms"} of one kernel's wrapper."""
    ms, launches = kernel_ms(torch, fn, kernel, iters)
    return {"ms": ms, "launches": launches,
            "call_ms": cuda_ms(torch, fn, iters),
            "plain_ms": cuda_ms(torch, plain, plain_iters)}


def seeded_state_dict(torch, model, rng):
    """Random variables for any of the port's models, from numpy:
    lecun-normal convs and dense (the head scaled by 0.3), non-identity
    BatchNorm and input statistics."""
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


def fmt_timed(prefix: str, t: dict) -> dict:
    return {f"{prefix}_kernel_ms": f"{t['ms']:.4f}",
            f"{prefix}_launches_per_call": t["launches"],
            f"{prefix}_call_ms": f"{t['call_ms']:.4f}",
            f"{prefix}_twin_ms": f"{t['plain_ms']:.4f}"}


def seeded_labels(torch, mask):
    """Every foreground pixel labelled with its flat index + 1."""
    h, w = mask.shape[-2:]
    flat = torch.arange(1, h * w + 1, dtype=torch.int32,
                        device=mask.device).reshape(h, w)
    return torch.where(mask, flat, 0).contiguous()


def phase_kernels_k4(torch, rng):
    from leaffliction_tpu_torch.ops.kernels.components import (
        cc_propagate,
        cc_propagate_plain,
    )

    err, rounds = 0, {}
    cases = [(BATCH, SIZE, d, 2 * SIZE) for d in (0.2, 0.5, 0.8)]
    cases += [(BATCH, SIZE, 0.5, 3), (1, 291, 0.5, 582)]
    for n, size, density, limit in cases:
        mask = torch.from_numpy(rng.random((n, size, size)) < density).cuda()
        lab = seeded_labels(torch, mask)
        got, got_rounds = cc_propagate(lab, mask, limit)
        ref, ref_rounds = cc_propagate_plain(lab, mask, limit)
        torch.cuda.synchronize()
        err = max(err, int((got - ref).abs().max()))
        if not (torch.equal(got, ref) and torch.equal(got_rounds,
                                                      ref_rounds)):
            bad = int((got != ref).sum())
            raise AssertionError(
                f"K4 differs from its twin: [{n},{size},{size}] density "
                f"{density} limit {limit}: {bad} pixels, rounds "
                f"{got_rounds.tolist()} vs {ref_rounds.tolist()}")
        rounds[f"{n}x{size}_d{density}_limit{limit}"] = got_rounds.tolist()
    if any(r != 4 for r in rounds[f"{BATCH}x{SIZE}_d0.5_limit3"]):
        raise AssertionError("the capped run did not stop at 1 + 3 rounds")
    log("3 k4", cases=len(cases), rounds=json.dumps(rounds),
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
    for n in (BATCH, 1):
        for l2 in (False, True):
            got = edge_nms(gray[:n], l2)
            ref = edge_nms_plain(gray[:n], l2)
            torch.cuda.synchronize()
            e = float((got - ref).abs().max())
            if not torch.equal(got, ref):
                raise AssertionError(f"K5 differs from its twin: n={n}, "
                                     f"l2={l2}, max |diff| {e}")
            err = max(err, e)
    log("4 k5", shapes=[[BATCH, SIZE, SIZE], [1, SIZE, SIZE]],
        l2=[False, True], max_abs_err=err, exact=True)
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
    # the channel means alone: factor 0 leaves clip(mean, 0, 1)
    mean_only = [f(imgs, angles, torch.zeros_like(factors)) for f in (
        train_aug, train_aug_plain)]
    errs["u8_f32_means"] = float((mean_only[0] - mean_only[1]).abs().max())
    x = imgs.float() / 255.0
    errs["f32_rotate"] = float((train_aug(x, angles)
                                - train_aug_plain(x, angles)).abs().max())
    ident = train_aug(imgs, torch.zeros_like(angles), torch.ones_like(
        factors))
    errs["identity"] = float((ident - x).abs().max())
    tols = {"u8_f32": 2.0 ** -23, "u8_bf16": 2.0 ** -8, "f32_rotate": 0.0,
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


class Decisions:
    """The discrete decisions of a model's forward, in call order: the sign
    of each ReLU's output (`torch.relu`, and a BatchNorm called with
    `relu=True`, whose twin's own `torch.relu` is not counted twice) and
    the picks of each max-pool. The residual blocks' exit runs its twin
    (`ops.block_exit.block_exit_plain`, whose `torch.relu` and
    `F.max_pool2d` are these), so its ReLU and pool are seen as the models
    made them before the exit was one kernel. Within `recording()` they
    are appended to
    `seen` (on the host); within `replaying(seen)` the forward takes those
    instead of its own: a ReLU keeps exactly the elements the recorded sign
    kept, a max-pool reads the recorded picks (in its input's layout, so
    the gradient comes back in it). Two runs that differ in one decision
    (a value within rounding of 0 or of a tie) send a gradient elsewhere,
    which can move gradients by up to 3e-2 (`tests/test_torch_gpu.py`);
    run on one run's decisions, they differ by their arithmetic alone."""

    def __init__(self, torch):
        from leaffliction_tpu_torch.ops import block_exit
        from leaffliction_tpu_torch.ops.fused_bn import BatchNorm

        self.exits = block_exit
        self.torch, self.seen, self.depth = torch, [], 0
        self.relu, self.pool = torch.relu, torch.nn.functional.max_pool2d
        self.batch_norm, self.bn_forward = BatchNorm, BatchNorm.forward

    @contextlib.contextmanager
    def _patched(self, relu, bn, pool):
        from unittest import mock

        with mock.patch.object(self.torch, "relu", relu), \
                mock.patch.object(self.batch_norm, "forward", bn), \
                mock.patch.object(self.torch.nn.functional, "max_pool2d",
                                  pool), \
                mock.patch.object(self.exits, "block_exit",
                                  self.exits.block_exit_plain):
            yield

    def _bn(self, out_of):
        def forward(module, x, train=False, group=None, relu=False):
            self.depth += 1
            try:
                return out_of(module, x, train, group, relu)
            finally:
                self.depth -= 1
        return forward

    def recording(self):
        def relu(x):
            out = self.relu(x)
            if not self.depth:
                self.seen.append(out.detach().gt(0).cpu())
            return out

        def bn(module, x, train, group, relu):
            out = self.bn_forward(module, x, train, group, relu)
            if relu:
                self.seen.append(out.detach().gt(0).cpu())
            return out

        def pool(x, *args, **kwargs):
            out, idx = self.pool(x, *args, return_indices=True, **kwargs)
            self.seen.append(idx.cpu())
            return out

        return self._patched(relu, self._bn(bn), pool)

    @contextlib.contextmanager
    def replaying(self, seen: list):
        todo = iter(seen)

        def kept(x):
            return x.masked_fill(~next(todo).to(x.device), 0)

        def relu(x):
            return self.relu(x) if self.depth else kept(x)

        def bn(module, x, train, group, relu):
            out = self.bn_forward(module, x, train, group, False)
            return kept(out) if relu else out

        def pool(x, *args, **kwargs):
            idx = next(todo).to(x.device)
            if x.is_contiguous():
                return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
            n, c = idx.shape[:2]  # channels-last: gather along the rows
            rows = x.permute(0, 2, 3, 1).reshape(n, -1, c)
            at = idx.permute(0, 2, 3, 1).reshape(n, -1, c)
            return rows.gather(1, at).view(n, *idx.shape[2:], c).permute(
                0, 3, 1, 2)

        with self._patched(relu, self._bn(bn), pool):
            yield
        if next(todo, None) is not None:
            raise AssertionError("a replayed forward made fewer decisions "
                                 "than were recorded")


STEP_DRAWS = range(11, 27)


def phase_step_check(torch, arch: str = "leafcnn"):
    """One f32 train step (leafcnn-tiny, or a ResNet preset with dropout
    off; 64 px, batch 8) on the card and the CPU, with cuDNN off and on,
    each on the first draw of STEP_DRAWS on which both sides make the same
    decisions (`Decisions`)."""
    import copy

    from leaffliction_tpu_torch.train.config import TrainConfig
    from leaffliction_tpu_torch.models.leafcnn import LeafCNN, init_model
    from leaffliction_tpu_torch.models.resnet import (
        RESNET_PRESETS,
        LeafResNet,
    )
    from leaffliction_tpu_torch.train.steps import loss_fn

    cfg = TrainConfig.regularized()
    cpu_model = init_model(LeafCNN(CLASSES, (16, 32, 64)) if arch ==
                           "leafcnn" else LeafResNet(
                               CLASSES, **RESNET_PRESETS[arch],
                               drop_top=0.0), 0)

    def grads(model, dev, seed):
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.random((8, 64, 64, 3)).astype(np.float32))
        labels = torch.from_numpy(rng.integers(0, CLASSES, 8))
        mask = torch.ones(8)
        decisions = Decisions(torch)
        with decisions.recording():
            loss, _ = loss_fn(model(x.to(dev), train=True), labels.to(dev),
                              mask.to(dev), CLASSES, cfg.label_smoothing)
            g = torch.autograd.grad(loss, list(model.parameters()))
        return loss.item(), [t.cpu().double() for t in g], decisions.seen

    def agreed(cudnn: bool):
        """(seed, CPU loss and gradients, card's) of the first draw whose
        decisions agree."""
        card_model = copy.deepcopy(cpu_model).cuda()
        for seed in STEP_DRAWS:
            l_cpu, g_cpu, on_cpu = grads(cpu_model, "cpu", seed)
            with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
                l_card, g_card, on_card = grads(card_model, "cuda", seed)
            if len(on_cpu) == len(on_card) > 0 and all(
                    torch.equal(a, b) for a, b in zip(on_cpu, on_card)):
                return seed, (l_cpu, g_cpu), (l_card, g_card)
        raise AssertionError(f"{arch} f32 step (cuDNN {cudnn}): the card and "
                             "the CPU differ in a ReLU or max-pool decision "
                             f"on every draw of {STEP_DRAWS}")

    def worst(a, b):
        return max(float((p - q).norm() / q.norm().clamp_min(1e-30))
                   for p, q in zip(a, b))

    def overall(a, b):
        return float(torch.cat([(p - q).ravel() for p, q in zip(a, b)]).norm()
                     / torch.cat([q.ravel() for q in b]).norm())

    seed, (l_cpu, g_cpu), (l_gpu, g_gpu) = agreed(False)
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_rel = worst(g_gpu, g_cpu)
    if not (loss_rel <= 1e-4 and grad_rel <= 1e-3):
        raise AssertionError(f"{arch} f32 step card vs CPU: loss rel "
                             f"{loss_rel}, "
                             f"worst grad rel L2 {grad_rel}")
    # cuDNN on: the backend the bf16 training runs. A BatchNorm bias
    # gradient is a near-cancelling sum, so its own relative error is held
    # loosely; all gradients together are held at 1e-3.
    dnn_seed, (l_cpu, g_cpu), (l_dnn, g_dnn) = agreed(True)
    dnn = {"loss": abs(l_dnn - l_cpu) / abs(l_cpu),
           "all": overall(g_dnn, g_cpu), "worst": worst(g_dnn, g_cpu)}
    if not (dnn["loss"] <= 1e-4 and dnn["all"] <= 1e-3
            and dnn["worst"] <= 1e-2):
        raise AssertionError(f"{arch} f32 step card (cuDNN) vs CPU: {dnn}")
    log("9 step check" if arch == "leafcnn" else "18 resnet step check",
        model="leafcnn-tiny" if arch == "leafcnn" else arch, img=64,
        batch=8, dtype="f32", draw_seed=seed, cudnn_draw_seed=dnn_seed,
        tf32=False, loss_rel_err=f"{loss_rel:.3e}",
        worst_grad_rel_l2=f"{grad_rel:.3e}", tol_loss=1e-4, tol_grad=1e-3,
        cudnn_loss_rel_err=f"{dnn['loss']:.3e}",
        cudnn_all_grads_rel_l2=f"{dnn['all']:.3e}",
        cudnn_worst_grad_rel_l2=f"{dnn['worst']:.3e}",
        cudnn_tol_all=1e-3, cudnn_tol_worst=1e-2)


def batch_norm_launches() -> dict:
    """The BatchNorm kernels' launch counters (`launches` of
    `ops/kernels/batch_norm.py`, by kernel, and `copy`)."""
    from leaffliction_tpu_torch.ops.kernels import batch_norm

    return batch_norm.launches


def exit_launches() -> dict:
    """The exit kernels' launch counters (`launches` of
    `ops/kernels/block_exit.py`, by kernel, and `copy`)."""
    from leaffliction_tpu_torch.ops.kernels import block_exit

    return block_exit.launches


def step_kernels_zeroed() -> None:
    """Set the BatchNorm and exit kernels' counters to 0: a main path's
    counts start here."""
    for counters in (batch_norm_launches(), exit_launches()):
        for key in counters:
            counters[key] = 0


def exit_sites(model):
    """(exits, exits with SE) of a model: LeafCNN's stages and the ResNet's
    blocks, and the ResNet's conv stem pool (without SE)."""
    from leaffliction_tpu_torch.models.leafcnn import ResBlock, SEBlock
    from leaffliction_tpu_torch.models.resnet import BasicBlock, LeafResNet

    blocks = sum(isinstance(m, (ResBlock, BasicBlock))
                 for m in model.modules())
    stem = int(isinstance(model, LeafResNet) and model.stem == "conv")
    return blocks + stem, sum(isinstance(m, SEBlock)
                              for m in model.modules())


def exit_held(tag: str, got: dict, model, steps: int, eval_forwards=0
              ) -> dict:
    """`got`, the exit counts a main path read after
    `step_kernels_zeroed`, held to the model's exits each running the
    forward and backward kernels in every one of `steps` train steps (the
    finalisation at each exit with SE), the forward alone in every one of
    `eval_forwards` eval forwards (None: any positive number of them), and
    nothing copied into or out of channels-last → got."""
    sites, with_se = exit_sites(model)
    if eval_forwards is None:
        eval_forwards = (got["forward"] - got["backward"]) // sites
        if eval_forwards <= 0:
            raise AssertionError(f"{tag}: no eval forward reached the exit "
                                 f"kernels: {got}")
    want = {"forward": sites * (steps + eval_forwards),
            "backward": sites * steps, "finalize": with_se * steps,
            "copy": 0}
    if got != want:
        raise AssertionError(f"{tag}: exit launches {got}, want {want} "
                             f"({sites} exits, {with_se} with SE, {steps} "
                             f"steps, {eval_forwards} eval forwards)")
    return got


def bn_layers(model) -> int:
    from leaffliction_tpu_torch.ops.fused_bn import BatchNorm

    return sum(isinstance(m, BatchNorm) for m in model.modules())


def bn_held(tag: str, got: dict, layers: int, steps: int,
            eval_forwards=0) -> dict:
    """`got`, the BatchNorm counts a main path read after `bn_zeroed`, held
    to `layers` BatchNorms each running the statistics, normalise, gradient
    sums and dx kernels and two finalisations in every one of `steps`
    train steps, the normalise alone in every one of `eval_forwards` eval
    forwards (None: any positive number of them), and nothing copied into
    or out of channels-last → got."""
    if eval_forwards is None:
        eval_forwards = (got["apply"] - got["stats"]) // layers
        if eval_forwards <= 0:
            raise AssertionError(f"{tag}: no eval forward reached the "
                                 f"BatchNorm kernels: {got}")
    step = layers * steps
    want = {"stats": step, "apply": step + layers * eval_forwards,
            "grad_reduce": step, "dx": step, "finalize": 2 * step,
            "copy": 0}
    if got != want:
        raise AssertionError(f"{tag}: BatchNorm launches {got}, want {want} "
                             f"({layers} layers, {steps} steps, "
                             f"{eval_forwards} eval forwards)")
    return got


def phase_training(torch, seed: int, rng):
    """leafcnn-base 224 b32 bf16 REGULARIZED with K1 on every step."""
    from leaffliction_tpu_torch.train.config import TrainConfig
    from leaffliction_tpu_torch.models.leafcnn import build_leafcnn
    from leaffliction_tpu_torch.ops.image import compute_norm_stats
    from leaffliction_tpu_torch.ops.kernels.components import cc_propagate
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
    cc_propagate.launches = edge_nms.launches = train_aug.launches = 0
    step_kernels_zeroed()
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
    bn = dict(batch_norm_launches())
    ex = dict(exit_launches())
    # --- end of the main path ---
    steps = FIXED_STEPS + TIMED_STEPS
    if launches != steps:
        raise AssertionError(f"K1 launched {launches} times in {steps} "
                             "train steps")
    bn_held("10", bn, bn_layers(model), steps)
    exit_held("10", ex, model, steps)
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
        k1_launches=launches, bn_launches=json.dumps(bn),
        exit_launches=json.dumps(ex), loss_first=f"{loss[0]:.4f}",
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


def run_cli(args, cwd: Path, timeout: int = 900, log: Path | None = None):
    """Run `python -m args` in `cwd` (its output kept in `log` if given)
    → its wall seconds; raises on a non-zero exit."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [q for q in [os.environ.get("PYTHONPATH")] if q]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)
    if log is not None:
        log.write_text(proc.stdout + proc.stderr)
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
                       "--out-dir", str(models)], tmp,
                      log=tmp / "trained_cli.log")
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
    return train_s


def lsb_diff(got, ref):
    d = (got.int() - ref.int()).abs()
    return int(d.max()), float((d > 0).float().mean())


def phase_kernels_balance(torch, rng):
    """K2, K3 and K6 against their twins at [64,224,224,3]."""
    from leaffliction_tpu_torch.ops.augment import rotate_canvas_hw
    from leaffliction_tpu_torch.ops.kernels.distortion import (
        distortion,
        distortion_plain,
    )
    from leaffliction_tpu_torch.ops.kernels.warp import (
        rotate_expand,
        rotate_expand_plain,
        shear_cubic,
        shear_cubic_plain,
    )

    n = FUSED_BATCH
    imgs = torch.from_numpy(np.stack([leafish_image(rng, SIZE)
                                      for _ in range(n)])).cuda()
    angles = torch.from_numpy(rng.uniform(-30, 30, n).astype(
        np.float32)).cuda()
    shears = torch.from_numpy(rng.uniform(-0.2, 0.2, n).astype(
        np.float32)).cuda()
    horiz = torch.from_numpy(np.arange(n) % 2 == 0).cuda()
    seeds = torch.from_numpy(rng.integers(0, 2 ** 32, (n, 3),
                                          dtype=np.int64)).cuda()
    cutoffs = torch.from_numpy(rng.uniform(0, 2, n).astype(
        np.float32)).cuda()
    canvas = rotate_canvas_hw(SIZE, SIZE)
    calls = {
        "rotate_expand": (lambda: rotate_expand(imgs, angles, canvas),
                          lambda: rotate_expand_plain(imgs, angles, canvas)),
        "shear_cubic": (lambda: shear_cubic(imgs, shears, horiz),
                        lambda: shear_cubic_plain(imgs, shears, horiz)),
        "distortion": (lambda: distortion(imgs, seeds, cutoffs),
                       lambda: distortion_plain(imgs, seeds, cutoffs)),
    }
    errs = {}
    for name, (kernel, plain) in calls.items():
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        if got.dtype != torch.uint8 or got.shape != ref.shape:
            raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} vs "
                                 f"{tuple(ref.shape)}")
        errs[name] = lsb_diff(got, ref)
        if not torch.equal(got, ref):
            raise AssertionError(f"{name} differs from its twin by "
                                 f"{errs[name][0]} LSB (want exact)")
    log("13 balance kernels", shape=[n, SIZE, SIZE, 3], canvas=list(canvas),
        angle_range_deg=[round(float(angles.min()), 3),
                         round(float(angles.max()), 3)],
        **{f"{k}_max_abs_err": v[0] for k, v in errs.items()},
        **{f"{k}_share_differing": f"{v[1]:.3e}" for k, v in errs.items()},
        tol_lsb=0)
    return calls, {k: v[0] for k, v in errs.items()}


def write_north_star_tree(root: Path, rng) -> int:
    """The north-star class profile as 256² JPEGs of leaf-like images."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    jobs = []
    for plant, counts in NORTH_STAR.items():
        for ci, count in enumerate(counts):
            d = root / plant / f"{plant.lower()}_class{ci}"
            d.mkdir(parents=True)
            jobs += [(leafish_image(rng, NATIVE), d / f"image ({i}).JPG")
                     for i in range(count)]
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda job: Image.fromarray(job[0]).save(
            job[1], quality=90), jobs))
    return len(jobs)


def phase_fused_cli(torch, tmp: Path, rng, seed: int):
    """The whole --balance-from command in process, K1/K2/K3 counted."""
    from leaffliction_tpu_torch.cli.train import main as train_main
    from leaffliction_tpu_torch.ops.kernels.distortion import distortion
    from leaffliction_tpu_torch.ops.kernels.rotate import train_aug
    from leaffliction_tpu_torch.ops.kernels.warp import (
        rotate_expand,
        shear_cubic,
    )

    work = tmp / "fused"
    tree = work / "tree"
    t0 = time.perf_counter()
    n_files = write_north_star_tree(tree, rng)
    tree_s = time.perf_counter() - t0
    models = work / "models"
    cwd = os.getcwd()
    os.chdir(work)  # artifacts/datasets and augmented_directory land here
    try:
        # --- the fused path: counts from here to the end of the command ---
        train_aug.launches = rotate_expand.launches = 0
        shear_cubic.launches = distortion.launches = 0
        with images_recorded("shear_cubic") as k3_images:
            t0 = time.perf_counter()
            run = train_main(["--balance-from", str(tree), "--epochs", "2",
                              "--img-size", str(SIZE), "--batch-size",
                              str(TRAIN_BATCH), "--seed", str(seed),
                              "--out-dir", str(models)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {"train_aug": train_aug.launches,
                    "rotate_expand": rotate_expand.launches,
                    "shear_cubic": shear_cubic.launches,
                    "distortion": distortion.launches}
        # --- end of the fused path ---
    finally:
        os.chdir(cwd)
    if run is None:
        raise AssertionError("the --balance-from command stopped early")
    for name in ("train_aug", "rotate_expand", "shear_cubic"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the fused path")
    if launches["distortion"] != 0:
        raise AssertionError("K6 launched without LEAF_PALLAS_DISTORT")
    bal = run["balance"]
    if (bal["n_original"], bal["n_generated"]) != (n_files, 110):
        raise AssertionError(f"balance counts {bal}")
    datasets = work / "artifacts" / "datasets"
    wanted = [datasets / n for n in ("manifest_augmented.json",
                                     "manifest_split.json",
                                     "split_summary.csv")]
    wanted += [models / n for n in ("leaf_cnn.msgpack", "labels.json",
                                    "history.json", "meta.json",
                                    "confusion_matrix.json")]
    missing = [str(p) for p in wanted if not p.exists()]
    if missing:
        raise AssertionError(f"the fused command wrote no {missing}")
    history = json.loads((models / "history.json").read_text())
    loss = history["loss"] + history["val_loss"]
    if any(len(v) != 2 for v in history.values()) \
            or not np.isfinite(loss).all():
        raise AssertionError(f"history: {history}")
    aug = json.loads((datasets / "manifest_augmented.json").read_text())
    if aug["meta"]["augmented_images"] != 110 \
            or aug["meta"]["total_images"] != n_files + 110:
        raise AssertionError(f"manifest_augmented meta: {aug['meta']}")
    fit = run["fit"]
    log("14 fused cli", model="leafcnn-base", img=SIZE, batch=TRAIN_BATCH,
        dtype="bf16", epochs=2, originals=bal["n_original"],
        generated=bal["n_generated"], train=bal["train"], val=bal["val"],
        k1_launches=launches["train_aug"],
        k2_launches=launches["rotate_expand"],
        k3_launches=launches["shear_cubic"],
        k3_images_per_call=json.dumps(k3_images),
        artifacts=json.dumps(sorted(p.name for p in wanted)),
        decode_s=f"{bal['decode_s']:.3f}", upload_s=f"{bal['upload_s']:.4f}",
        augment_s=f"{bal['augment_s']:.4f}",
        balance_s=f"{bal['balance_time_s']:.3f}",
        generated_img_per_s=f"{bal['n_generated'] / bal['augment_s']:.1f}",
        train_s=f"{fit.train_time_s:.2f}", steps=fit.steps_ran,
        train_img_per_s=f"{fit.images_per_sec:.1f}",
        val_accuracy=json.dumps(history["val_accuracy"]),
        command_wall_s=f"{wall:.2f}", tree_write_s=f"{tree_s:.2f}")

    served = tree / "Grape" / "grape_class3"
    out_json = work / "batch_results.json"
    predict_s = run_cli(["leaffliction_tpu_torch.cli.predict", str(served),
                         "--batch-mode", "-learnings", str(models), "-json",
                         str(out_json), "-out", str(work / "predictions")],
                        work)
    rows = json.loads(out_json.read_text())["batch_results"]
    if len(rows) != NORTH_STAR["Grape"][3]:
        raise AssertionError(f"predict CLI served {len(rows)} images")
    log("14 fused predict", predict_cli_rc=0, served=len(rows),
        predict_cli_wall_s=f"{predict_s:.2f}")
    return tree, launches, k3_images


def phase_optin_k6(torch, tree: Path, seed: int):
    """The balance with and without LEAF_PALLAS_DISTORT=1."""
    from leaffliction_tpu_torch.data.fused_balance import balance_to_device
    from leaffliction_tpu_torch.ops.kernels.distortion import distortion

    def balance():
        return balance_to_device(tree, SIZE, seed=seed,
                                 write_artifacts=False, device="cuda")

    plain = balance()
    os.environ["LEAF_PALLAS_DISTORT"] = "1"
    try:
        # --- the opt-in path: counts from here to the end of the balance ---
        distortion.launches = 0
        with images_recorded("distortion") as k6_images:
            t0 = time.perf_counter()
            opt = balance()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = distortion.launches
        # --- end of the opt-in path ---
    finally:
        del os.environ["LEAF_PALLAS_DISTORT"]
    if launches <= 0:
        raise AssertionError("K6 never launched under LEAF_PALLAS_DISTORT=1")
    n0 = plain.n_original
    ops = [it.id.split("_aug_")[1].rsplit("_", 1)[0]
           for it in plain.items[n0:]]
    dist = [n0 + i for i, op in enumerate(ops) if op == "distortion"]
    rest = [n0 + i for i, op in enumerate(ops) if op != "distortion"]
    if not dist:
        raise AssertionError("the plan has no distortion task")
    a, b = plain.device_images, opt.device_images
    if not torch.equal(a[:n0], b[:n0]) or not torch.equal(a[rest], b[rest]):
        raise AssertionError("LEAF_PALLAS_DISTORT changed a row that is not "
                             "a distortion row")
    # each distortion row against its source original
    names = {it.id: i for i, it in enumerate(plain.items[:n0])}
    stats = []
    for r in dist:
        it = plain.items[r]
        stem, rest_id = it.id.rsplit("/", 1)
        src = f"{stem}/{rest_id.split('_aug_')[0]}.JPG"
        src_img = a[names[src]].float().cpu().numpy()
        got = b[r].float().cpu().numpy()
        corr = float(np.corrcoef(got.ravel(), src_img.ravel())[0, 1])
        noise = float(np.abs(got - src_img).mean())
        stats.append((corr, noise, float(got.min()), float(got.max())))
        if not (corr > 0.8 and noise > 1.0 and got.min() <= 5
                and got.max() >= 250):
            raise AssertionError(f"K6 row {r}: corr {corr}, mean |diff| "
                                 f"{noise}, range {got.min()}-{got.max()}")
    log("15 optin k6", k6_launches=launches,
        k6_images_per_call=json.dumps(k6_images), distortion_rows=len(dist),
        distortion_rows_sha256=hashlib.sha256(
            b[dist].cpu().numpy().tobytes()).hexdigest(),
        other_rows_byte_equal=len(rest) + n0,
        min_corr=f"{min(s[0] for s in stats):.4f}",
        min_mean_abs_diff=f"{min(s[1] for s in stats):.2f}",
        max_of_min=max(s[2] for s in stats),
        min_of_max=min(s[3] for s in stats),
        balance_wall_s=f"{wall:.3f}",
        augment_s_default=f"{plain.stages['augment_s']:.4f}",
        augment_s_k6=f"{opt.stages['augment_s']:.4f}")
    return launches, k6_images


def k3_case(torch, n, rng):
    """K3's inputs at n images, its call and its twin's."""
    from leaffliction_tpu_torch.ops.kernels.warp import (
        shear_cubic,
        shear_cubic_plain,
    )

    imgs = torch.from_numpy(np.stack([leafish_image(rng, SIZE)
                                      for _ in range(n)])).cuda()
    shears = torch.from_numpy(rng.uniform(-0.2, 0.2, n).astype(
        np.float32)).cuda()
    horiz = torch.from_numpy(rng.random(n) < 0.5).cuda()
    return (lambda: shear_cubic(imgs, shears, horiz),
            lambda: shear_cubic_plain(imgs, shears, horiz))


def k6_case(torch, n, rng):
    """K6's inputs at n images, its call and its twin's."""
    from leaffliction_tpu_torch.ops.kernels.distortion import (
        distortion,
        distortion_plain,
    )

    imgs = torch.from_numpy(np.stack([leafish_image(rng, SIZE)
                                      for _ in range(n)])).cuda()
    seeds = torch.from_numpy(rng.integers(0, 2 ** 32, (n, 3),
                                          dtype=np.int64)).cuda()
    cutoffs = torch.from_numpy(rng.uniform(0, 2, n).astype(
        np.float32)).cuda()
    return (lambda: distortion(imgs, seeds, cutoffs),
            lambda: distortion_plain(imgs, seeds, cutoffs))


def k3_bound(n):
    return bound(2 * n * SIZE * SIZE * 3 + 5 * n, 20 * n * SIZE * SIZE * 3)


def k6_bound(n):
    return bound(2 * n * SIZE * SIZE * 3 + 28 * n,
                 222 * n * SIZE * SIZE * 3)


def phase_balance_timings(torch, calls, rng, command_sizes):
    """K2/K3/K6 vs twins and each balancing op per 64-chunk (CUDA events);
    K3 and K6 also at the image counts of the command's own calls
    (`command_sizes[name]`), where the blocks an image takes differ from
    phase 13's, held exact against their twins there too."""
    from leaffliction_tpu_torch.data.fused_balance import resize_rotated
    from leaffliction_tpu_torch.kernels import build
    from leaffliction_tpu_torch.ops.augment import BATCH_KERNELS, DRAWS

    ms = {name: timed(torch, name, kernel, plain, 20, 5)
          for name, (kernel, plain) in calls.items()}
    lib = build.load()
    cases = {"shear_cubic": ("k3", k3_case, k3_bound,
                             lambda n: lib.leaf_shear_cubic_blocks_per_image(
                                 n, SIZE, SIZE)),
             "distortion": ("k6", k6_case, k6_bound,
                            lambda n: lib.leaf_distortion_blocks_per_image(
                                n, SIZE, SIZE))}
    for name, (tag, case, bound_of, blocks_of) in cases.items():
        case_rng = np.random.default_rng(16)
        sizes = command_sizes[name]
        for n in [n for n in sizes if n != FUSED_BATCH] + [FUSED_BATCH]:
            kernel, plain = case(torch, n, case_rng)
            got, ref = kernel(), plain()
            lsb = int((got.int() - ref.int()).abs().max())
            if not torch.equal(got, ref):
                raise AssertionError(f"{tag} at n={n}: {lsb} LSB from its "
                                     "twin (want exact)")
            t = timed(torch, name, kernel, plain, 50, 5)
            bound_ms, bound_by = bound_of(n)
            log(f"16 {tag}", shape=[n, SIZE, SIZE, 3],
                command_call=n in sizes, max_lsb=lsb,
                blocks_per_image=blocks_of(n),
                bound_us=f"{bound_ms * 1e3:.3f}", bound_by=bound_by,
                **fmt_timed(tag, t))
    imgs = torch.from_numpy(np.stack([leafish_image(rng, SIZE)
                                      for _ in range(FUSED_BATCH)])).cuda()
    rngs = [np.random.default_rng([7, i]) for i in range(FUSED_BATCH)]
    op_ms = {}
    for op, batch in BATCH_KERNELS.items():
        params = DRAWS[op](rngs, (SIZE, SIZE), torch.device("cuda"))
        op_ms[op] = cuda_ms(torch, lambda: batch(imgs, **params), 10)
        if op == "rotate":
            canvas = batch(imgs, **params)
            op_ms["rotate_resize_back"] = cuda_ms(
                torch, lambda: resize_rotated(canvas, params["angles"], SIZE),
                10)
    from leaffliction_tpu_torch.ops.augment import rotate_canvas_hw

    log("16 balance kernels", shape=[FUSED_BATCH, SIZE, SIZE, 3],
        rotate_expand_blocks_per_image=build.load()
        .leaf_rotate_expand_blocks_per_image(FUSED_BATCH, SIZE, SIZE,
                                             *rotate_canvas_hw(SIZE, SIZE)),
        **{k: v for name, t in ms.items()
           for k, v in fmt_timed(name, t).items()})
    log("16 balance ops", chunk=FUSED_BATCH,
        **{f"{k}_ms_per_chunk": f"{v:.4f}" for k, v in op_ms.items()})
    return ms


def smoke_model(torch, arch: str, stem: str, dtype):
    """leafcnn-base, or a ResNet preset with `stem`, for CLASSES classes."""
    from leaffliction_tpu_torch.models.leafcnn import build_leafcnn
    from leaffliction_tpu_torch.models.resnet import build_resnet

    if arch == "leafcnn":
        return build_leafcnn(CLASSES, "base", dtype=dtype)
    return build_resnet(CLASSES, arch, stem=stem, dtype=dtype)


def write_artifacts(torch, learn: Path, seed: int, arch: str = "leafcnn",
                    stem: str = "conv"):
    """A bf16 artifact dir in the flax layout (msgpack and meta.json) with
    weights drawn from `seed`: leafcnn-base, or a ResNet preset."""
    from leaffliction_tpu_torch.convert import to_flax
    from leaffliction_tpu_torch.train.checkpoint import save_model_msgpack

    model = smoke_model(torch, arch, stem, torch.float32)
    sd = seeded_state_dict(torch, model, np.random.default_rng(seed))
    learn.mkdir(parents=True, exist_ok=True)
    save_model_msgpack(learn / "leaf_cnn.msgpack", to_flax(sd))
    if arch == "leafcnn":
        block = {"name": "leaf_cnn", "widths": [32, 64, 128, 256],
                 "separable": False, "use_normalization": True,
                 "stem": "conv"}
    else:
        block = {"name": arch, "stem": stem, "use_normalization": True}
    meta = {
        "model_file": "leaf_cnn.msgpack",
        "labels": LABELS,
        "data": {"img_size": SIZE, "num_classes": CLASSES},
        "model": block,
        "training": {"mixed_precision": True},
    }
    (learn / "meta.json").write_text(json.dumps(meta, indent=2))


def cpu_f32_forward(torch, learn: Path, images: np.ndarray,
                    arch: str = "leafcnn", stem: str = "conv"
                    ) -> np.ndarray:
    from leaffliction_tpu_torch.convert import to_state_dict
    from leaffliction_tpu_torch.train.checkpoint import load_model_msgpack

    model = smoke_model(torch, arch, stem, torch.float32)
    model.load_state_dict(to_state_dict(
        load_model_msgpack(learn / "leaf_cnn.msgpack")))
    with torch.inference_mode():
        x = torch.from_numpy(images).float() / 255.0
        return torch.softmax(model.eval()(x), -1).numpy()


RESNET_TRAIN = ((128, 20, 10), (TRAIN_BATCH, 30, 15))  # batch, fixed, timed


def phase_resnet_serving(torch, tmp: Path, seed: int, rng, device):
    """resnet18 (conv stem, 256 images) and resnet10 (s2d stem, 64) served
    from seeded artifact dirs in the flax layout through the Predictor →
    each model's ms a 64-batch forward on the card, by arch."""
    from leaffliction_tpu_torch.predict.predictor import (
        SERVING_BATCH,
        Predictor,
    )

    served = {}

    for arch, stem, n in (("resnet18", "conv", 4 * SERVING_BATCH),
                          ("resnet10", "s2d", SERVING_BATCH)):
        learn = tmp / f"{arch}_{stem}"
        write_artifacts(torch, learn, seed, arch, stem)
        images = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
        predictor = Predictor(learn, device=device).load()
        model = predictor.model_loader.model
        if type(model).__name__ != "LeafResNet" or model.stem != stem \
                or model.dtype != torch.bfloat16:
            raise AssertionError(f"ModelLoader built {type(model).__name__}"
                                 f" for {arch} {stem}")
        probs = predictor._probs_for_arrays(images)
        torch.cuda.synchronize()
        if probs.shape != (n, CLASSES) or not np.isfinite(probs).all():
            raise AssertionError(f"{arch} probabilities {probs.shape}, "
                                 f"finite: {np.isfinite(probs).all()}")
        row_err = float(np.abs(probs.sum(-1) - 1.0).max())
        if not row_err <= 1e-3:
            raise AssertionError(f"{arch}: probability rows sum off by "
                                 f"{row_err}")
        ref = cpu_f32_forward(torch, learn, images[:BATCH], arch, stem)
        prob_err = float(np.abs(probs[:BATCH] - ref).max())
        if not prob_err <= 2e-2:
            raise AssertionError(f"{arch} bf16 card vs f32 CPU: max |dprob|"
                                 f" {prob_err} > 2e-2")
        top1 = float((probs[:BATCH].argmax(-1) == ref.argmax(-1)).mean())
        chunk = images[:SERVING_BATCH]
        x64 = predictor._upload(chunk)
        fwd_ms = cuda_ms(torch, lambda: predictor._infer(chunk), 10)
        dev_ms = forward_ms(torch, model, x64)
        served[arch] = dev_ms
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            predictor._probs_for_arrays(images)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = sorted(walls)[1]
        chunks = n // SERVING_BATCH
        log("17 resnet serving", model=arch, stem=stem, img=SIZE,
            classes=CLASSES, dtype="bf16", images=n, chunks=chunks,
            row_sum_err=f"{row_err:.2e}", max_dprob_vs_cpu_f32=prob_err,
            top1_agree=top1,
            ms_per_64_batch_end_to_end=f"{wall * 1e3 / chunks:.3f}",
            img_per_s=f"{n / wall:.1f}",
            ms_per_64_batch_upload_and_forward=f"{fwd_ms:.3f}",
            ms_per_64_batch_forward_on_device=f"{dev_ms:.3f}")
    return served


def phase_resnet_training(torch, seed: int, rng):
    """resnet18 224 bf16 REGULARIZED with K1 on every step, at b128 and
    b32, over a device-resident uint8 set of leaf-like images."""
    from leaffliction_tpu_torch.models.resnet import build_resnet
    from leaffliction_tpu_torch.ops.image import compute_norm_stats
    from leaffliction_tpu_torch.ops.kernels.rotate import train_aug
    from leaffliction_tpu_torch.train.config import TrainConfig
    from leaffliction_tpu_torch.train.steps import (
        build_step_fns,
        create_train_state,
    )

    n_data = 2 * RESNET_TRAIN[0][0]
    data = torch.from_numpy(np.stack([leafish_image(rng, SIZE)
                                      for _ in range(n_data)])).cuda()
    labels = torch.from_numpy(rng.integers(0, CLASSES, n_data)).cuda()
    mean, var = compute_norm_stats(data)
    total, medians = 0, {}
    for batch, fixed_steps, timed_steps in RESNET_TRAIN:
        model = build_resnet(CLASSES, "resnet18", dtype=torch.bfloat16)
        state = create_train_state(model, seed, "cuda")
        with torch.no_grad():
            state.model.norm_mean.copy_(mean)
            state.model.norm_var.copy_(var)
        fns = build_step_fns(TrainConfig.regularized(), CLASSES, 1000)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        mask = torch.ones(batch, device="cuda")
        fixed = torch.arange(batch, device="cuda")
        sels = [torch.from_numpy(rng.choice(n_data, batch, replace=False)
                                 ).cuda() for _ in range(timed_steps)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # --- the main path: counts from here to the end of the timed steps
        train_aug.launches = 0
        step_kernels_zeroed()
        t0 = time.perf_counter()
        losses = [fns.train_step_gather(state, data, labels, fixed, mask,
                                        gen)["loss"]
                  for _ in range(fixed_steps)]
        torch.cuda.synchronize()
        fixed_s = time.perf_counter() - t0
        events = []
        for sel in sels:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(fns.train_step_gather(state, data, labels, sel,
                                                mask, gen)["loss"])
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        launches = train_aug.launches
        bn = dict(batch_norm_launches())
        ex = dict(exit_launches())
        # --- end of the main path ---
        steps = fixed_steps + timed_steps
        if launches != steps:
            raise AssertionError(f"K1 launched {launches} times in {steps} "
                                 f"resnet18 train steps at b{batch}")
        bn_held(f"19 b{batch}", bn, bn_layers(model), steps)
        exit_held(f"19 b{batch}", ex, model, steps)
        loss = torch.stack(losses).float().cpu().numpy()
        if not np.isfinite(loss).all():
            raise AssertionError(f"non-finite resnet18 loss: {loss}")
        if not loss[fixed_steps - 1] < loss[0]:
            raise AssertionError(f"resnet18 b{batch}: loss on a fixed batch "
                                 f"did not fall in {fixed_steps} steps: "
                                 f"{loss[:fixed_steps]}")
        ms = sorted(s.elapsed_time(e) for s, e in events)
        med = float(np.median(ms))
        medians[batch] = med
        total += launches
        log("19 resnet training", model="resnet18", img=SIZE, batch=batch,
            dtype="bf16", config="REGULARIZED", augment=True, steps=steps,
            k1_launches=launches, bn_launches=json.dumps(bn),
            exit_launches=json.dumps(ex), loss_first=f"{loss[0]:.4f}",
            loss_after_fixed_steps=f"{loss[fixed_steps - 1]:.4f}",
            loss_last=f"{loss[-1]:.4f}", ms_per_step_median=f"{med:.3f}",
            ms_per_step_min=f"{ms[0]:.3f}", ms_per_step_max=f"{ms[-1]:.3f}",
            img_per_s=f"{batch * 1e3 / med:.1f}",
            wall_ms_per_step_fixed=f"{fixed_s * 1e3 / fixed_steps:.3f}",
            peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
        del state, fns
    return total, medians


def phase_resnet_clis(torch, tmp: Path):
    """The train CLI with `--arch resnet10 --stem s2d` on phase 11's JPEG
    tree (subprocess), the predict CLI in batch mode on its artifacts
    (subprocess) and in single mode (in process: the montage, K4 and K5
    counted)."""
    from leaffliction_tpu_torch.cli.predict import main as predict_main
    from leaffliction_tpu_torch.ops.kernels.components import cc_propagate
    from leaffliction_tpu_torch.ops.kernels.edge import edge_nms

    src, manifest = tmp / "tree", tmp / "manifest_split.json"
    models = tmp / "resnet_trained"
    train_s = run_cli(["leaffliction_tpu_torch.cli.train", "--manifest",
                       str(manifest), "--epochs", "1", "--img-size",
                       str(SIZE), "--batch-size", str(TRAIN_BATCH),
                       "--arch", "resnet10", "--stem", "s2d", "--out-dir",
                       str(models)], tmp)
    meta = json.loads((models / "meta.json").read_text())
    history = json.loads((models / "history.json").read_text())
    if (meta["model"]["name"], meta["model"]["stem"]) != ("resnet10", "s2d") \
            or any(len(v) != 1 for v in history.values()):
        raise AssertionError(f"resnet train CLI: {meta['model']} {history}")
    out_json = tmp / "resnet_batch_results.json"
    predict_s = run_cli(["leaffliction_tpu_torch.cli.predict",
                         str(src / "Plant" / "class0"), "--batch-mode",
                         "-learnings", str(models), "-json", str(out_json),
                         "-out", str(tmp / "resnet_predictions")], tmp)
    rows = json.loads(out_json.read_text())["batch_results"]
    if len(rows) != 32:
        raise AssertionError(f"predict CLI served {len(rows)} of 32 images")
    image = src / "Plant" / "class1" / "image (0).JPG"
    single = tmp / "resnet_single"
    # --- the single-mode path: counts from here to the end of the call ---
    cc_propagate.launches = edge_nms.launches = 0
    t0 = time.perf_counter()
    predict_main([str(image), "-learnings", str(models), "-out",
                  str(single)])
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    launches = {"cc_propagate": cc_propagate.launches,
                "edge_nms": edge_nms.launches}
    # --- end of the single-mode path ---
    if not (single / "image (0)_prediction.png").exists():
        raise AssertionError("the predict CLI wrote no montage")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched in single mode")
    log("20 resnet clis", arch="resnet10", stem="s2d", epochs=1,
        train_items=meta["data"]["train_items"],
        val_accuracy=json.dumps(history["val_accuracy"]),
        train_cli_rc=0, train_cli_wall_s=f"{train_s:.2f}",
        predict_cli_rc=0, served=len(rows),
        predict_cli_wall_s=f"{predict_s:.2f}",
        single_mode_s=f"{single_s:.2f}",
        k4_launches=launches["cc_propagate"],
        k5_launches=launches["edge_nms"])
    return launches


# the JAX package's balancer benchmark tree (bench.py:281-297): a big and a
# small class of 224² JPEGs, 200 generated
BENCH_CLASS_IMGS, BENCH_RUNS = (260, 60), 3
# the mixed-size tree: one plant a source shape, so every shape gets its
# own rotate, shear and distortion groups (class names are unique across
# plants: the balancer keys classes by directory name)
MIXED_SHAPES = ((256, 256), (320, 320), (16, 200), (200, 16), (64, 48))


@contextlib.contextmanager
def env_set(**values):
    """Environment variables set (a string) or removed (None) inside the
    block, restored after it."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def held_against_twins(check: bool = True):
    """Each call the balancing ops make to K2, K3 or K6 (as `ops.augment`
    holds them), and each call the segmentation ops make to K4 (as
    `ops.components` holds it) or K5 (through `ops.filters._edge_nms`), is
    recorded, and with `check` also runs the kernel's twin on the same
    inputs: a list of (kernel, (h, w), images, max |diff| or None), read by
    the caller after the block. K4's difference covers its labels and its
    round counts. Each call goes through the kernel's own wrapper, which
    counts its launch; the twins launch no kernel."""
    from leaffliction_tpu_torch.ops import augment, components, filters
    from leaffliction_tpu_torch.ops.kernels.components import (
        cc_propagate_plain,
    )
    from leaffliction_tpu_torch.ops.kernels.distortion import (
        distortion_plain,
    )
    from leaffliction_tpu_torch.ops.kernels.edge import edge_nms_plain
    from leaffliction_tpu_torch.ops.kernels.warp import (
        rotate_expand_plain,
        shear_cubic_plain,
    )

    def diff(name, out, ref):
        if name == "cc_propagate":
            return max(lsb_diff(out[0], ref[0])[0], lsb_diff(out[1],
                                                             ref[1])[0])
        if name == "edge_nms":
            return float((out - ref).abs().max())
        return lsb_diff(out, ref)[0]

    # (the module that calls the kernel, the name it calls, kernel, twin)
    targets = [(augment, "rotate_expand", "rotate_expand",
                rotate_expand_plain),
               (augment, "shear_cubic", "shear_cubic", shear_cubic_plain),
               (augment, "distortion", "distortion", distortion_plain),
               (components, "cc_propagate", "cc_propagate",
                cc_propagate_plain),
               (filters, "_edge_nms", "edge_nms", edge_nms_plain)]
    real, kept = {(m, a): getattr(m, a) for m, a, _, _ in targets}, []

    def held(fn, name, twin):
        def call(x, *args, **kwargs):
            out = fn(x, *args, **kwargs)
            err = (diff(name, out, twin(x, *args, **kwargs)) if check
                   else None)
            kept.append((name, tuple(x.shape[1:3]), int(x.shape[0]), err))
            return out
        return call

    for mod, attr, name, twin in targets:
        setattr(mod, attr, held(real[(mod, attr)], name, twin))
    try:
        yield kept
    finally:
        for (mod, attr), fn in real.items():
            setattr(mod, attr, fn)


def write_bench_tree(root: Path) -> int:
    """`bench.py`'s `_make_synthetic_tree` (seed 7): the generated count."""
    from PIL import Image

    rng = np.random.default_rng(7)
    big, small = BENCH_CLASS_IMGS
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32)
    base = np.stack([xx % 251, yy % 241, (xx + yy) % 253], -1)
    for cls, n in (("healthy", big), ("rust", small)):
        d = root / "Apple" / cls
        d.mkdir(parents=True)
        for i in range(n):
            arr = (base + rng.normal(0, 8, (SIZE, SIZE, 3))).clip(0, 255)
            Image.fromarray(arr.astype(np.uint8)).save(
                d / f"img{i}.jpg", quality=95)
    return big - small


def write_mixed_tree(root: Path, rng) -> None:
    from PIL import Image

    for h, w in MIXED_SHAPES:
        for cls, n in (("big", 12), ("small", 2)):
            d = root / f"Plant{h}x{w}" / f"s{h}x{w}_{cls}"
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(rng.integers(0, 256, (h, w, 3),
                                             dtype=np.uint8)).save(
                    d / f"i{i}.jpg", quality=90)


def materialise(torch, tree: Path, target: Path, seed: int, on_array=None):
    """One `DatasetBalancer` run on the card → (stages, wall seconds)."""
    from leaffliction_tpu_torch.data.balancer import DatasetBalancer

    bal = DatasetBalancer(tree, target, seed=seed,
                          manifest_out_dir=target.with_name(
                              target.name + "_datasets"),
                          device="cuda", on_array=on_array)
    t0 = time.perf_counter()
    stages = bal.run()
    torch.cuda.synchronize()
    return stages, time.perf_counter() - t0


def check_balanced(tree: Path, target: Path) -> dict:
    """Every class of the target holds its source count plus its plan, and
    each plant's classes are equal → the target's counts."""
    from leaffliction_tpu_torch.data.balancer import calculate_plan
    from leaffliction_tpu_torch.data.scan import (
        count_by_plant_class,
        scan_dataset,
    )

    src = count_by_plant_class(scan_dataset(tree))
    plan = calculate_plan(src)
    got = count_by_plant_class(scan_dataset(target))
    for plant, classes in src.items():
        want = {cls: n + sum(plan.get(cls, {}).values())
                for cls, n in classes.items()}
        if got.get(plant) != want or len(set(want.values())) != 1:
            raise AssertionError(f"{plant}: {got.get(plant)} vs the plan's "
                                 f"{want}")
    return got


def file_hashes(target: Path, pattern: str = "*.JPG") -> dict:
    return {p.relative_to(target).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in target.rglob(pattern)}


def phase_materialising(torch, tmp: Path, tree: Path, rng, seed: int):
    """The materialising balancer on the card (in process, K2/K3/K6
    counted), the host backend, a mixed-size tree, and the CLIs."""
    from leaffliction_tpu_torch.data.balancer import task_rngs
    from leaffliction_tpu_torch.ops.augment import DRAWS, pil_expanded_size
    from leaffliction_tpu_torch.ops.kernels.distortion import distortion
    from leaffliction_tpu_torch.ops.kernels.warp import (
        rotate_expand,
        shear_cubic,
    )

    work = tmp / "materialise"
    work.mkdir()
    t_phase = time.perf_counter()

    # (a) the north-star tree at its native 256²
    rotated = []

    def keep_rotated(task, arr):
        if task.transform == "rotate":
            rotated.append((task, arr.shape))

    # --- the materialising path: counts from here to the end of the run ---
    rotate_expand.launches = shear_cubic.launches = distortion.launches = 0
    with held_against_twins(check=False) as a_calls:
        stages, wall = materialise(torch, tree, work / "a", seed,
                                   keep_rotated)
    launches = {"rotate_expand": rotate_expand.launches,
                "shear_cubic": shear_cubic.launches,
                "distortion": distortion.launches}
    # --- end of the materialising path ---
    for name in ("rotate_expand", "shear_cubic"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the "
                                 "materialising path")
    check_balanced(tree, work / "a")
    meta = json.loads((work / "a_datasets" / "manifest_augmented.json")
                      .read_text())["meta"]
    n_src = sum(sum(c) for c in NORTH_STAR.values())
    if (meta["total_images"], meta["original_images"],
            meta["augmented_images"]) != (n_src + 110, n_src, 110) \
            or stages["generated"] != 110 or stages["failed"]:
        raise AssertionError(f"manifest_augmented meta {meta}, {stages}")
    for task, shape in rotated:
        angle = DRAWS["rotate"](task_rngs(seed, [task]), (NATIVE, NATIVE),
                                torch.device("cpu"))["angles"][0]
        ew, eh = pil_expanded_size(float(angle), NATIVE, NATIVE)
        if shape != (eh, ew, 3):
            raise AssertionError(f"{task.output_path.name}: {shape}, PIL's "
                                 f"expanded size {(eh, ew)}")
    log("21a materialise", tree="north-star", originals=n_src,
        generated=stages["generated"], source_size=NATIVE,
        k2_launches=launches["rotate_expand"],
        k3_launches=launches["shear_cubic"], rotate_outputs=len(rotated),
        images_per_call=json.dumps(sorted((name, n) for name, _, n, _
                                          in a_calls)),
        wall_s=f"{wall:.3f}",
        generated_img_per_s=f"{stages['generated'] / wall:.1f}",
        **{k: (f"{v:.4f}" if isinstance(v, float) else v)
           for k, v in stages.items()
           if k not in ("generated", "failed", "wall_s")})

    # (b) the JAX package's balancer benchmark tree, 3 runs
    n_gen = write_bench_tree(work / "bench_src")
    rates, walls = [], []
    for _ in range(BENCH_RUNS):
        st, dt = materialise(torch, work / "bench_src", work / "b", 42)
        if st["generated"] != n_gen:
            raise AssertionError(f"bench tree generated {st['generated']}")
        rates.append(n_gen / dt)
        walls.append(dt)
    rates.sort()
    log("21b bench tree", classes=json.dumps(BENCH_CLASS_IMGS), size=SIZE,
        generated=n_gen, runs=BENCH_RUNS,
        img_per_s_median=f"{rates[len(rates) // 2]:.1f}",
        img_per_s_min=f"{rates[0]:.1f}", img_per_s_max=f"{rates[-1]:.1f}",
        wall_s=json.dumps([round(w, 3) for w in walls]))

    # (c) the host pool against the device backend, strict distortion,
    # both encoding with PIL; the device run, untimed, holds every K2 and
    # K3 call against its twin at the image counts 21a ran
    with env_set(LEAF_STRICT_DISTORTION="1", LEAF_NATIVE_DECODE="0"):
        with env_set(LEAF_BALANCE_BACKEND="device"), \
                held_against_twins() as c_calls:
            dev_st, _ = materialise(torch, tree, work / "c_device", seed)
        with env_set(LEAF_BALANCE_BACKEND="host"):
            host_st, host_wall = materialise(torch, tree, work / "c_host",
                                             seed)
    dev_files, host_files = (file_hashes(work / "c_device"),
                             file_hashes(work / "c_host"))
    if sorted(dev_files) != sorted(host_files):
        raise AssertionError("the host backend wrote other file names")
    dist = sorted(k for k in dev_files if "_aug_distortion_" in k)
    if not dist or any(dev_files[k] != host_files[k] for k in dist):
        raise AssertionError("strict distortion files differ between the "
                             "host and device backends")
    if (host_st["generated"], host_st["failed"]) != (110, 0):
        raise AssertionError(f"host backend: {host_st}")
    a_shapes = sorted(c[:3] for c in a_calls)
    if sorted(c[:3] for c in c_calls) != a_shapes or any(
            c[3] != 0 for c in c_calls):
        raise AssertionError(f"21c's held calls {c_calls} against 21a's "
                             f"{a_shapes}")
    log("21c host pool", files=len(host_files), distortion_files=len(dist),
        distortion_sha256_equal=True,
        host_pool_s=f"{host_st['host_pool_s']:.3f}",
        host_img_per_s=f"{110 / host_st['host_pool_s']:.1f}",
        host_wall_s=f"{host_wall:.3f}", held_calls=len(c_calls),
        held_max_abs_err=0,
        held_images_per_call=json.dumps(sorted((name, n) for name, _, n, _
                                               in c_calls)))

    # (d) the mixed-size tree, K6 opted in: every K2, K3 and K6 call held
    # against its twin
    write_mixed_tree(work / "mixed", rng)
    with env_set(LEAF_PALLAS_DISTORT="1", LEAF_STRICT_DISTORTION=None):
        rotate_expand.launches = shear_cubic.launches = 0
        distortion.launches = 0
        with held_against_twins() as calls:
            mixed_st, mixed_wall = materialise(torch, work / "mixed",
                                               work / "d", seed)
        mixed = {"rotate_expand": rotate_expand.launches,
                 "shear_cubic": shear_cubic.launches,
                 "distortion": distortion.launches}
    check_balanced(work / "mixed", work / "d")
    seen = {(name, hw) for name, hw, _, _ in calls}
    want = {(name, hw) for name in mixed for hw in MIXED_SHAPES}
    bad = [c for c in calls if c[3] != 0]
    if seen != want or bad:
        raise AssertionError(f"mixed tree: missing {sorted(want - seen)}, "
                             f"differing {bad}")
    log("21d mixed sizes", shapes=json.dumps(MIXED_SHAPES),
        generated=mixed_st["generated"], groups=mixed_st["groups"],
        calls=len(calls), max_abs_err=0,
        **{f"{k}_launches": v for k, v in mixed.items()},
        images_per_call=json.dumps(sorted({(n, f"{hw[0]}x{hw[1]}")
                                           for _, hw, n, _ in calls})),
        wall_s=f"{mixed_wall:.3f}")
    for name, n in mixed.items():
        launches[name] += n

    # (e) the CLIs as a user runs them: each augment alone (its wall is a
    # user's wait), then distribution and split side by side
    from concurrent.futures import ThreadPoolExecutor

    cli = work / "cli"
    cli.mkdir()
    image = next((tree / "Apple").glob("*/image (0).JPG"))
    m = "leaffliction_tpu_torch.cli."
    jobs = {"augment_single": [m + "augment", str(image), "--output",
                               str(cli / "example")],
            "augment_tree": [m + "augment", str(tree), "--output",
                             str(cli / "augmented")],
            "distribution": [m + "distribution", str(tree), "--out-dir",
                             str(cli / "plots")],
            "split": [m + "split", "--src", str(tree), "--out",
                      str(cli / "split")]}
    walls = {k: run_cli(jobs[k], cli)
             for k in ("augment_single", "augment_tree")}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        futures = {k: pool.submit(run_cli, jobs[k], cli)
                   for k in ("distribution", "split")}
        walls.update({k: f.result() for k, f in futures.items()})
    walls["distribution_and_split"] = time.perf_counter() - t0
    if len(list((cli / "example").iterdir())) != 7:
        raise AssertionError("single-image augment wrote "
                             f"{sorted((cli / 'example').iterdir())}")

    def csv_total(path: Path, col: str) -> int:
        import csv

        with path.open() as f:
            rows = list(csv.DictReader(f))
        if col == "total":
            return int(rows[-1]["total"])
        return sum(int(r[col]) for r in rows)

    totals = {
        "balanced": csv_total(cli / "artifacts/distribution/"
                              "balanced_distribution.csv", "count"),
        "distribution": csv_total(cli / "plots/distribution.csv", "count"),
        "split": csv_total(cli / "split/split_summary.csv", "total"),
        "split_manifest": len(json.loads(
            (cli / "split/manifest_split.json").read_text())["items"]),
        "augmented_manifest": json.loads(
            (cli / "artifacts/datasets/manifest_augmented.json").read_text()
        )["meta"]["total_images"]}
    want = {"balanced": n_src + 110, "distribution": n_src, "split": n_src,
            "split_manifest": n_src, "augmented_manifest": n_src + 110}
    if totals != want:
        raise AssertionError(f"CLI counts {totals}, want {want}")
    log("21e clis", rc=0, single_files=7,
        **{f"{k}_images": v for k, v in totals.items()},
        **{f"{k}_wall_s": f"{v:.2f}" for k, v in walls.items()})
    log("21 materialising", seconds=f"{time.perf_counter() - t_phase:.1f}")
    return launches


# the transform slice: 64 leaf-like 256² JPEGs with brown spots, in 8
# classes; the folder CLI's device chunk (16) and the default config's
# 1.3× mask upscale (256² → 333²)
TRANSFORM_IMAGES, MASK_CHUNK, UPSCALED = 64, 16, 333


def spotted_leaf(rng, size):
    """`leafish_image` with 2-4 brown spots inside the leaf (the Brown and
    Landmarks filters' disease path)."""
    img = leafish_image(rng, size)
    yy, xx = np.mgrid[0:size, 0:size]
    for _ in range(int(rng.integers(2, 5))):
        cy, cx = size / 2 + rng.normal(0, size / 10, 2)
        r = size * rng.uniform(0.02, 0.05)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = (
            120 + rng.integers(-10, 10), 70, 30)
    return img


def k4_kernel_of(build, h: int, w: int) -> str:
    return "smem" if build.load().leaf_cc_propagate_smem_bytes(h, w) \
        else "global"


def calls_by_shape(build, calls):
    """{"kernel [n,h,w]": [calls, "smem"|"global" for K4]} of the recorded
    K4 and K5 calls."""
    out = {}
    for name, (h, w), n, _ in calls:
        key = f"{name} [{n},{h},{w}]"
        kind = k4_kernel_of(build, h, w) if name == "cc_propagate" else "-"
        out[key] = [out.get(key, [0])[0] + 1, kind]
    return out


def phase_transform(torch, tmp: Path, rng, north_star: Path,
                    manifest: Path):
    """22. The segmentation and analysis slice on the card: the transform
    CLI (single image in a subprocess, card and CPU; folder mode in
    process, timed, then again with every K4 and K5 call held against its
    twin), ms per mask at 333² and 256², K4 per call at the slice's shapes,
    and `train --transform` in manifest mode and with `--balance-from`."""
    from PIL import Image

    from leaffliction_tpu_torch.cli.train import main as train_main
    from leaffliction_tpu_torch.cli.transform import main as transform_main
    from leaffliction_tpu_torch.kernels import build
    from leaffliction_tpu_torch.ops.image import resize
    from leaffliction_tpu_torch.ops.kernels.components import (
        cc_propagate,
        cc_propagate_plain,
    )
    from leaffliction_tpu_torch.ops.kernels.edge import edge_nms
    from leaffliction_tpu_torch.ops.kernels.rotate import train_aug
    from leaffliction_tpu_torch.ops.kernels.warp import (
        rotate_expand,
        shear_cubic,
    )
    from leaffliction_tpu_torch.segment.config import (
        TransformConfig,
        default_config_path,
        load_config,
    )
    from leaffliction_tpu_torch.segment.mask import (
        _candidates_for,
        make_mask,
        make_mask_batch,
    )

    t_phase = time.perf_counter()
    src = tmp / "transform_src"
    leaves = [spotted_leaf(rng, NATIVE) for _ in range(TRANSFORM_IMAGES)]
    for i, leaf in enumerate(leaves):
        d = src / "Plant" / f"class{i % CLASSES}"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(leaf).save(d / f"image ({i}).JPG", quality=90)
    one = src / "Plant" / "class0" / "image (0).JPG"
    types = ["Blur", "Mask", "ROI", "Analyze", "Landmarks", "Brown"]
    try:
        import matplotlib  # noqa: F401
        types.append("Hist")
    except ImportError:
        pass
    want = sorted([f"image (0)__T_{t}.jpg" for t in types]
                  + ["image0_mosaic.jpg"])

    # (a) the single-image CLI with the default types, card and CPU
    walls = {}
    for dev in ("cuda", "cpu"):
        out = tmp / f"transform_one_{dev}"
        walls[dev] = run_cli(["leaffliction_tpu_torch.cli.transform",
                              str(one), "--out-dir", str(out),
                              "--device", dev], tmp)
        got = sorted(p.name for p in out.iterdir())
        if got != want:
            raise AssertionError(f"single-image CLI on {dev} wrote {got}")
    cfg = load_config(default_config_path())
    try:
        import cv2
    except ImportError:
        cv2 = None
    agree = []
    for leaf in leaves[:4]:
        masks = []
        for dev in ("cuda", "cpu"):
            if cv2 is not None:
                cv2.setRNGSeed(0)
            masks.append(make_mask(leaf, cfg, dev)[0])
        agree.append(float((masks[0] == masks[1]).mean()))
    if not min(agree) >= 0.999:
        raise AssertionError(f"single-image masks card vs CPU {agree}")
    log("22a transform single", size=NATIVE, mask_size=UPSCALED,
        types=len(types), files=len(want),
        hist="written" if "Hist" in types else "skipped (no matplotlib)",
        grabcut="cv2" if cv2 is not None else "device",
        card_cli_wall_s=f"{walls['cuda']:.2f}",
        cpu_cli_wall_s=f"{walls['cpu']:.2f}",
        min_mask_agreement_card_vs_cpu=min(agree))

    # (b) folder mode, the main path: counts from here to its end
    cc_propagate.launches = edge_nms.launches = 0
    with held_against_twins(check=False) as calls:
        run = transform_main(["-src", str(src), "-dst",
                              str(tmp / "transform_out"), "--device",
                              "cuda"])
        torch.cuda.synchronize()
    launches = {"cc_propagate": cc_propagate.launches,
                "edge_nms": edge_nms.launches}
    # --- end of the folder path ---
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched in folder mode")
    files = len(list((tmp / "transform_out").iterdir()))
    if files != TRANSFORM_IMAGES * (len(types) + 1):
        raise AssertionError(f"folder mode wrote {files} files")
    shapes = calls_by_shape(build, calls)
    log("22b transform folder", images=run["images"], files=files,
        wall_s=f"{run['wall_s']:.3f}",
        img_per_s=f"{run['images'] / run['wall_s']:.2f}",
        **{f"{k}_s": f"{v:.3f}" for k, v in run["stages"].items()},
        k4_launches=launches["cc_propagate"],
        k5_launches=launches["edge_nms"],
        k4_launches_per_image=launches["cc_propagate"] / TRANSFORM_IMAGES,
        k5_launches_per_image=launches["edge_nms"] / TRANSFORM_IMAGES,
        calls_by_shape=json.dumps(shapes))

    # (c) the same run, every K4 and K5 call held against its twin
    with held_against_twins() as held:
        transform_main(["-src", str(src), "-dst",
                        str(tmp / "transform_held"), "--device", "cuda"])
    bad = [c for c in held if c[3] != 0]
    if sorted(c[:3] for c in held) != sorted(c[:3] for c in calls) or bad:
        raise AssertionError(f"22c: {len(bad)} calls differ from their "
                             f"twins: {bad[:5]}")
    log("22c transform held", calls=len(held), max_abs_err=0,
        shapes=json.dumps(sorted(set(f"{c[0]} [{c[2]},{c[1][0]},"
                                     f"{c[1][1]}]" for c in held))))

    # (d) ms per mask (the batched pipeline, its fallback check included)
    # at the folder's 333² and the training transform's stored size, and
    # K4 per call at the slice's shapes
    chunk = torch.from_numpy(np.stack(leaves[:MASK_CHUNK])).cuda()
    big = resize(chunk, (MASK_CHUNK, UPSCALED, UPSCALED, 3), "cubic")
    no_upscale = TransformConfig(mask_upscale_factor=1.0,
                                 mask_upscale_long_side=0,
                                 grabcut_refine=False)
    per_mask = {}
    for label, x, c in (("333", big, cfg), ("256", chunk, no_upscale)):
        for n in (MASK_CHUNK, 1):
            ms = cuda_ms(torch, lambda: make_mask_batch(x[:n], c), 3)
            per_mask[f"{label}_n{n}"] = ms / n
    log("22d ms per mask", **{k: f"{v:.3f}" for k, v in per_mask.items()})
    k4 = {}
    for label, x in (("16x333", big), ("1x256", chunk[:1].float())):
        cand = _candidates_for(x.float(), cfg)[0]
        h, w = cand.shape[-2:]
        flat = torch.arange(1, h * w + 1, dtype=torch.int32,
                            device=cand.device).reshape(h, w)
        lab = torch.where(cand, flat, 0).contiguous()
        mask = cand.contiguous()
        rounds = cc_propagate(lab, mask, h + w)[1].tolist()
        kms = kernel_ms(torch, lambda: cc_propagate(lab, mask, h + w),
                        "cc_propagate", 10)
        call_ms = cuda_ms(torch, lambda: cc_propagate(lab, mask, h + w), 10)
        twin_ms = cuda_ms(torch, lambda: cc_propagate_plain(lab, mask,
                                                            h + w), 2)
        k4[label] = {"ms": kms[0], "call_ms": call_ms, "plain_ms": twin_ms,
                     "rounds": rounds, "shape": list(lab.shape),
                     "kernel": k4_kernel_of(build, h, w)}
        log("22d k4", shape=list(lab.shape), input="inclusive candidate",
            kernel=k4[label]["kernel"], k4_kernel_ms=f"{kms[0]:.4f}",
            k4_launches_per_call=kms[1], k4_call_ms=f"{call_ms:.4f}",
            k4_twin_ms=f"{twin_ms:.4f}", k4_rounds=json.dumps(rounds))

    # (e) train --transform: manifest mode and --balance-from, 1 epoch;
    # the main path's counts from here to its end
    cc_propagate.launches = edge_nms.launches = train_aug.launches = 0
    rotate_expand.launches = shear_cubic.launches = 0
    common = ["--transform", "--epochs", "1", "--img-size", str(SIZE),
              "--batch-size", str(TRAIN_BATCH), "--device", "cuda"]
    tf = {}
    for mode, source in (("manifest", ["--manifest", str(manifest)]),
                         ("balance_from", ["--balance-from",
                                           str(north_star)])):
        t0 = time.perf_counter()
        res = train_main(source + common + [
            "--out-dir", str(tmp / f"transform_models_{mode}")])
        torch.cuda.synchronize()
        tf[mode] = (res["transform_s"], time.perf_counter() - t0,
                    res["fit"].steps_ran)
    train_launches = {"cc_propagate": cc_propagate.launches,
                      "edge_nms": edge_nms.launches,
                      "train_aug": train_aug.launches,
                      "rotate_expand": rotate_expand.launches,
                      "shear_cubic": shear_cubic.launches}
    # --- end of the train --transform path ---
    for name in ("cc_propagate", "edge_nms", "train_aug"):
        if train_launches[name] <= 0:
            raise AssertionError(f"{name} never launched in train "
                                 "--transform")
    log("22e train transform",
        **{f"{m}_transform_s": f"{v[0]:.3f}" for m, v in tf.items()},
        **{f"{m}_wall_s": f"{v[1]:.2f}" for m, v in tf.items()},
        **{f"{m}_steps": v[2] for m, v in tf.items()},
        **{f"{k}_launches": v for k, v in train_launches.items()})
    log("22 transform", seconds=f"{time.perf_counter() - t_phase:.1f}")
    return {k: launches.get(k, 0) + train_launches.get(k, 0)
            for k in train_launches}


# phase 23: the resumed run and the uninterrupted one, 3 epochs each; the
# killed run stops after this many steps of epoch 2
RESUME_EPOCHS, KILL_AT_STEP, SAVE_EVERY = 3, 4, 2
AB_BLOCKS, AB_STEPS = 4, 6  # step timing with and without the checkpointer


@contextlib.contextmanager
def k1_recorded():
    """Every K1 call of the train step (`ops.train_augment.train_aug`):
    its inputs and output kept (clones, no sync) in a list, for the caller
    to hold against the twin after the block. The call goes through K1's
    own wrapper, which counts its launch."""
    from leaffliction_tpu_torch.ops import train_augment

    real, kept = train_augment.train_aug, []

    def recording(imgs, angles, factors=None, out_dtype=None):
        out = real(imgs, angles, factors, out_dtype)
        kept.append((imgs.clone(), angles.clone(), factors.clone(),
                     out_dtype, out.clone()))
        return out

    train_augment.train_aug = recording
    try:
        yield kept
    finally:
        train_augment.train_aug = real


def k1_held(torch, kept):
    """Each recorded K1 call against the twin on its own inputs: the call's
    own output (bf16, phase 5's 2^-8 gate) and the same inputs in f32
    (phase 5's 2^-23 gate; that replay's launch is not counted) → the
    largest differences."""
    from leaffliction_tpu_torch.ops.kernels.rotate import (
        train_aug,
        train_aug_plain,
    )

    gates = {torch.bfloat16: 2.0 ** -8, torch.float32: 2.0 ** -23}
    err = {"bf16": 0.0, "f32": 0.0}
    for imgs, angles, factors, dtype, out in kept:
        ref = train_aug_plain(imgs, angles, factors, dtype)
        e = float((out.float() - ref.float()).abs().max())
        if not e <= gates[dtype]:
            raise AssertionError(f"K1 ({dtype}) differs from its twin on "
                                 f"the resume path: {e}")
        err["bf16" if dtype == torch.bfloat16 else "f32"] = max(
            err["bf16" if dtype == torch.bfloat16 else "f32"], e)
        before = train_aug.launches
        got = train_aug(imgs, angles, factors, torch.float32)
        train_aug.launches = before
        e32 = float((got - train_aug_plain(imgs, angles, factors,
                                           torch.float32)).abs().max())
        if not e32 <= gates[torch.float32]:
            raise AssertionError(f"K1 (f32 replay) differs from its twin "
                                 f"on the resume path: {e32}")
        err["f32"] = max(err["f32"], e32)
    return err


def state_tensors(result):
    st = result.state
    out = {f"model.{k}": v for k, v in st.model.state_dict().items()}
    for name in ("mu", "nu", "ema_params", "ema_batch_stats"):
        out.update({f"{name}.{k}": v for k, v in getattr(st, name).items()})
    return out


def resumed_against(torch, got, ref):
    """(bit-equal tensors, tensors, worst relative L2 over the state) of
    two fit results; raises past trouble spot 5's tolerance (weights 1e-3
    relative L2) or when the step, lr_scale or generator state differ."""
    a, b = state_tensors(got), state_tensors(ref)
    if a.keys() != b.keys():
        raise AssertionError("resumed state has other tensors")
    same = sum(torch.equal(a[k], b[k]) for k in a)
    worst = max(float((a[k].double() - b[k].double()).norm()
                      / b[k].double().norm().clamp_min(1e-30)) for k in a)
    if not worst <= 1e-3:
        raise AssertionError(f"resumed run's state differs: worst rel L2 "
                             f"{worst}")
    if (got.state.step, got.state.lr_scale) != (ref.state.step,
                                                ref.state.lr_scale) or \
            not torch.equal(got.generator_state, ref.generator_state):
        raise AssertionError("resumed run's step, lr_scale or generator "
                             "state differ")
    return same, len(a), worst


def trace_kernels(path: Path):
    """(K1 kernel events, convolution kernel events and their first names,
    `aten::cudnn_convolution` ops) in a Chrome trace of torch.profiler."""
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    k1 = [n for n in kernels if any(f in n for f in
                                    KERNEL_NAMES["train_aug"])]
    conv = [n for n in kernels if any(f in n.lower() for f in (
        "conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit_gemm"))]
    cudnn_ops = sum(e.get("name") == "aten::cudnn_convolution"
                    for e in events)
    return len(kernels), len(k1), conv, cudnn_ops


def step_times_with_saver(torch, tmp: Path, seed: int, rng):
    """leafcnn-base 224 b32 bf16 steps (phase 10's), in alternating blocks
    without and with `maybe_save` every step at cadence SAVE_EVERY (a block
    without starts once the last save has committed): CUDA event and host
    ms per step (the call included), maybe_save's host µs per call (saves
    and skips apart) and each save's wall in the worker, with its copy to
    the host and its write."""
    from leaffliction_tpu_torch.models.leafcnn import build_leafcnn
    from leaffliction_tpu_torch.ops.image import compute_norm_stats
    from leaffliction_tpu_torch.train import checkpoint as ck
    from leaffliction_tpu_torch.train.config import TrainConfig
    from leaffliction_tpu_torch.train.steps import (
        build_step_fns,
        create_train_state,
    )

    n_data = 4 * TRAIN_BATCH
    data = torch.from_numpy(np.stack([leafish_image(rng, SIZE)
                                      for _ in range(n_data)])).cuda()
    labels = torch.from_numpy(rng.integers(0, CLASSES, n_data)).cuda()
    state = create_train_state(build_leafcnn(CLASSES, "base",
                                             dtype=torch.bfloat16), seed,
                               "cuda")
    mean, var = compute_norm_stats(data)
    with torch.no_grad():
        state.model.norm_mean.copy_(mean)
        state.model.norm_var.copy_(var)
    fns = build_step_fns(TrainConfig.regularized(), CLASSES, 1000)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mask = torch.ones(TRAIN_BATCH, device="cuda")
    saver = ck.AsyncStepCheckpointer(tmp / "step_ab", SAVE_EVERY)
    real = {"_save": ck.AsyncStepCheckpointer._save,
            "_host_copy": ck._host_copy, "_write": ck._write}
    save_s = {name: [] for name in real}

    def timed(name):
        def call(*args):
            t0 = time.perf_counter()
            out = real[name](*args)
            save_s[name].append(time.perf_counter() - t0)
            return out
        return call

    ck.AsyncStepCheckpointer._save = timed("_save")
    ck._host_copy, ck._write = timed("_host_copy"), timed("_write")
    ms = {"without": [], "with": []}
    wall = {"without": [], "with": []}
    host = {"save": [], "skip": []}
    history = {"loss": [], "accuracy": [], "val_loss": [],
               "val_accuracy": []}
    step = 0
    try:
        fns.train_step_gather(state, data, labels,
                              torch.arange(TRAIN_BATCH, device="cuda"),
                              mask, gen)  # warm-up
        for block in range(2 * AB_BLOCKS):
            kind = "with" if block % 2 else "without"
            while saver.busy():  # no save of the last block runs in this one
                time.sleep(0.001)
            for _ in range(AB_STEPS):
                sel = torch.from_numpy(rng.choice(
                    n_data, TRAIN_BATCH, replace=False)).cuda()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t_step = time.perf_counter()
                start.record()
                fns.train_step_gather(state, data, labels, sel, mask, gen)
                step += 1
                if kind == "with":
                    t0 = time.perf_counter()
                    saved = saver.maybe_save(step, state, {
                        "epoch": 0, "step_in_epoch": step,
                        "history": history}, gen)
                    host["save" if saved else "skip"].append(
                        (time.perf_counter() - t0) * 1e6)
                end.record()
                wall[kind].append((time.perf_counter() - t_step) * 1e3)
                ms[kind].append((start, end))
        torch.cuda.synchronize()
        saver.close()
    finally:
        ck.AsyncStepCheckpointer._save = real["_save"]
        ck._host_copy, ck._write = real["_host_copy"], real["_write"]
    step_ms = {k: float(np.median([s.elapsed_time(e) for s, e in v]))
               for k, v in ms.items()}
    step_ms.update({f"host_{k}": float(np.median(v))
                    for k, v in wall.items()})
    return step_ms, host, save_s


def phase_resume(torch, tmp: Path, seed: int, rng):
    """23. Resume on the card's train path (K1 on every step), in process:
    (a) an uninterrupted 3-epoch train CLI run under --profile-dir, (b) the
    same with --checkpoint-every-steps, killed by an exception in epoch 2,
    (c) --resume to the end: equal to (a); then a subprocess run SIGKILLed
    once a step meta of epoch 2 appears, resumed in process; every K1 call
    held against its twin; the checkpointer's host and step costs."""
    import signal

    from leaffliction_tpu_torch.cli.train import main as train_main
    from leaffliction_tpu_torch.ops.kernels.rotate import train_aug
    from leaffliction_tpu_torch.train import checkpoint as ck

    t_phase = time.perf_counter()
    manifest = tmp / "manifest_split.json"

    def flags(name, *extra):
        # one step a dispatch: the kill lands at step 4 through the step
        # callback, and every K1 call is recorded as it launches
        return ["--manifest", str(manifest), "--epochs", str(RESUME_EPOCHS),
                "--img-size", str(SIZE), "--batch-size", str(TRAIN_BATCH),
                "--seed", str(seed), "--out-dir", str(tmp / name),
                "--steps-per-dispatch", "1", *extra]

    real_maybe, calls = ck.AsyncStepCheckpointer.maybe_save, []

    def timed_maybe(self, global_step, state, meta, *rest):
        t0 = time.perf_counter()
        saved = real_maybe(self, global_step, state, meta, *rest)
        calls.append((global_step, saved, (time.perf_counter() - t0) * 1e6))
        if kill is not None and (meta["epoch"], meta["step_in_epoch"]) == \
                kill:
            raise RuntimeError("simulated kill")
        return saved

    # --- the resume path: counts from here to the end of the last resume
    train_aug.launches = 0
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    ck.AsyncStepCheckpointer.maybe_save = timed_maybe
    try:
        with k1_recorded() as k1_calls:
            kill = None
            t0 = time.perf_counter()
            ref = train_main(flags("resume_a", "--profile-dir",
                                   str(tmp / "resume_a" / "profile")))
            wall_a = time.perf_counter() - t0
            kill = (1, KILL_AT_STEP)
            try:
                train_main(flags("resume_b", "--checkpoint-every-steps",
                                 str(SAVE_EVERY)))
            except RuntimeError as exc:
                if str(exc) != "simulated kill":
                    raise
            else:
                raise AssertionError("run (b) was not killed")
            ckpt = tmp / "resume_b" / "checkpoints"
            latest = ck.latest_resume_step(ckpt)
            meta = ck.read_step_meta(ckpt, latest) if latest else None
            killed_at = calls[-1][0]
            if meta is None or killed_at - latest > 2 * SAVE_EVERY:
                raise AssertionError(f"run (b): latest checkpoint {latest} "
                                     f"for a kill at step {killed_at}")
            kill = None
            t0 = time.perf_counter()
            res = train_main(flags("resume_b", "--checkpoint-every-steps",
                                   str(SAVE_EVERY), "--resume"))
            wall_c = time.perf_counter() - t0
            same, n_tensors, worst = resumed_against(torch, res["fit"],
                                                     ref["fit"])
            got_h = json.loads((tmp / "resume_b" / "history.json")
                               .read_text())
            ref_h = json.loads((tmp / "resume_a" / "history.json")
                               .read_text())
            loss_rel = abs(got_h["loss"][-1] - ref_h["loss"][-1]) / abs(
                ref_h["loss"][-1])
            if not (loss_rel <= 1e-4 and len(got_h["val_loss"])
                    == len(ref_h["val_loss"]) == RESUME_EPOCHS):
                raise AssertionError(f"resumed history {got_h} against "
                                     f"{ref_h}")
            torch.backends.cudnn.deterministic = deterministic

            # one real kill: a subprocess SIGKILLed once a step meta of
            # epoch 2 has committed, resumed here
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                [str(ROOT)] + [q for q in [os.environ.get("PYTHONPATH")]
                               if q]))
            proc = subprocess.Popen(
                [sys.executable, "-m", "leaffliction_tpu_torch.cli.train",
                 *flags("resume_kill", "--checkpoint-every-steps",
                        str(SAVE_EVERY))], cwd=tmp, env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
            kill_dir = tmp / "resume_kill" / "checkpoints"
            deadline = time.perf_counter() + 300
            killed_meta = None
            try:
                while killed_meta is None and proc.poll() is None:
                    if time.perf_counter() > deadline:
                        raise AssertionError("no step meta of epoch 2 "
                                             "within 300 s")
                    for p in kill_dir.glob("step_meta_*.json"):
                        try:  # the pruning of old metas races the glob
                            m = json.loads(p.read_text())
                        except FileNotFoundError:
                            continue
                        if m["epoch"] >= 1:
                            killed_meta = (p.name, m["epoch"],
                                           m["step_in_epoch"])
                            proc.send_signal(signal.SIGKILL)
                            break
                    time.sleep(0.01)
            finally:
                if proc.poll() is None and killed_meta is None:
                    proc.kill()
                err = proc.communicate(timeout=60)[1].decode()[-2000:]
            if proc.returncode != -signal.SIGKILL or \
                    (tmp / "resume_kill" / "leaf_cnn.msgpack").exists():
                raise AssertionError(f"the subprocess was not killed mid-"
                                     f"run: rc {proc.returncode}\n{err}")
            t0 = time.perf_counter()
            after_kill = train_main(flags("resume_kill",
                                          "--checkpoint-every-steps",
                                          str(SAVE_EVERY), "--resume"))
            wall_kill = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = train_aug.launches
        # --- end of the resume path ---
    finally:
        ck.AsyncStepCheckpointer.maybe_save = real_maybe
        torch.backends.cudnn.deterministic = deterministic
    kill_h = json.loads((tmp / "resume_kill" / "history.json").read_text())
    if len(kill_h["loss"]) != RESUME_EPOCHS or not all(
            (tmp / "resume_kill" / n).exists() for n in (
                "leaf_cnn.msgpack", "meta.json", "labels.json")):
        raise AssertionError(f"the resumed killed run: {kill_h}")
    steps = (ref["fit"].steps_ran + res["fit"].steps_ran
             + after_kill["fit"].steps_ran + killed_at)
    if launches != steps or len(k1_calls) != launches:
        raise AssertionError(f"K1 launched {launches} times in {steps} "
                             f"steps ({len(k1_calls)} recorded)")
    k1_err = k1_held(torch, k1_calls)
    n_kernels, n_k1, conv, cudnn_ops = trace_kernels(
        tmp / "resume_a" / "profile" / "train_trace.json")
    if not (n_k1 >= 1 and conv and cudnn_ops >= 1):
        raise AssertionError(f"trace: {n_kernels} kernels, {n_k1} K1, "
                             f"{len(conv)} convolution kernels, "
                             f"{cudnn_ops} cudnn_convolution ops")
    held = len(k1_calls)
    del k1_calls
    step_ms, host, save_s = step_times_with_saver(torch, tmp, seed, rng)
    cli_us = [us for _, _, us in calls]
    log("23 resume", model="leafcnn-base", img=SIZE, batch=TRAIN_BATCH,
        dtype="bf16", epochs=RESUME_EPOCHS,
        steps_per_epoch=ref["fit"].steps_ran // RESUME_EPOCHS,
        killed_at_step=killed_at, resumed_from_step=latest,
        resumed_from=json.dumps([meta["epoch"], meta["step_in_epoch"]]),
        resumed_steps=res["fit"].steps_ran,
        state_tensors_bit_equal=f"{same}/{n_tensors}",
        worst_state_rel_l2=f"{worst:.3e}", tol_state_rel_l2=1e-3,
        last_epoch_loss_rel_err=f"{loss_rel:.3e}", tol_loss=1e-4,
        cudnn_deterministic=True, wall_a_profiled_s=f"{wall_a:.2f}",
        wall_c_resume_s=f"{wall_c:.2f}",
        trace_kernel_events=n_kernels, trace_k1_events=n_k1,
        trace_conv_kernel_events=len(conv),
        trace_conv_kernel=json.dumps(conv[0][:60]),
        trace_cudnn_convolution_ops=cudnn_ops,
        sigkill_at=json.dumps(killed_meta), sigkill_rc=proc.returncode,
        resume_after_sigkill_steps=after_kill["fit"].steps_ran,
        resume_after_sigkill_wall_s=f"{wall_kill:.2f}",
        k1_launches=launches, k1_held=held,
        k1_max_abs_err_bf16=k1_err["bf16"], k1_max_abs_err_f32=k1_err["f32"],
        k1_tols=json.dumps({"bf16": 2.0 ** -8, "f32": 2.0 ** -23}))
    log("23 checkpointer", every_steps=SAVE_EVERY,
        step_ms_median_without=f"{step_ms['without']:.3f}",
        step_ms_median_with=f"{step_ms['with']:.3f}",
        step_host_ms_median_without=f"{step_ms['host_without']:.3f}",
        step_host_ms_median_with=f"{step_ms['host_with']:.3f}",
        steps_each=AB_BLOCKS * AB_STEPS,
        maybe_save_host_us_median_save=f"{np.median(host['save']):.1f}",
        maybe_save_host_us_max_save=f"{max(host['save']):.1f}",
        maybe_save_host_us_median_skip=f"{np.median(host['skip']):.2f}",
        saves=len(host["save"]), skips=len(host["skip"]),
        save_wall_ms_median=f"{np.median(save_s['_save']) * 1e3:.1f}",
        save_wall_ms_max=f"{max(save_s['_save']) * 1e3:.1f}",
        save_copy_ms_median=f"{np.median(save_s['_host_copy']) * 1e3:.1f}",
        save_write_ms_median=f"{np.median(save_s['_write']) * 1e3:.1f}",
        cli_maybe_save_host_us_median=f"{np.median(cli_us):.1f}",
        cli_maybe_save_calls=len(cli_us),
        cli_saves=sum(s for _, s, _ in calls))
    log("23 resume phase", seconds=f"{time.perf_counter() - t_phase:.1f}")
    return launches, k1_err


def phase_library(torch, tmp: Path, rng):
    """24. The library functions no CLI calls, on the card: the
    homography warp at [8,224,224,3] and the morphology helper against the
    CPU, and `evaluate_from_manifest` with phase 11's trained model."""
    from leaffliction_tpu_torch.ops import geometry as G
    from leaffliction_tpu_torch.predict.evaluation import (
        evaluate_from_manifest,
    )
    from leaffliction_tpu_torch.predict.predictor import Predictor
    from leaffliction_tpu_torch.utils.mask_utils import (
        apply_morphological_operations,
    )

    t_phase = time.perf_counter()
    x = torch.from_numpy(np.stack([leafish_image(rng, SIZE)
                                   for _ in range(BATCH)]).astype(
        np.float32))
    mats = torch.stack(
        [G.rotation_matrix(float(a), (SIZE, SIZE))
         for a in rng.uniform(-30, 30, 3)]
        + [G.rotation_matrix(25.0, (SIZE, SIZE), out_hw=(SIZE, SIZE)),
           G.shear_matrix(0.15, True, (SIZE, SIZE)),
           G.shear_matrix(-0.2, False, (SIZE, SIZE)),
           G.solve_perspective_coeffs(
               [(5, 3), (220, 9), (218, 221), (2, 215)],
               [(0, 0), (SIZE, 0), (SIZE, SIZE), (0, SIZE)]),
           torch.eye(3)])
    warp_err = {}
    xc, mc = x.cuda(), mats.cuda()
    for fill in (None, 255.0):
        got = G.homography_warp(xc, mc, (SIZE, SIZE), fill)
        ref = G.homography_warp(x, mats, (SIZE, SIZE), fill)
        warp_err[str(fill)] = float((got.cpu() - ref).abs().max())
    if not max(warp_err.values()) <= 1e-3:
        raise AssertionError(f"homography_warp card vs CPU: {warp_err}")
    warp_ms = cuda_ms(torch, lambda: G.homography_warp(xc, mc, (SIZE, SIZE)),
                      10)
    leaves = [leafish_image(rng, SIZE).astype(int) for _ in range(2)]
    masks = [((a[..., 1] - a[..., 0]) > 40).astype(np.uint8) * 255
             for a in leaves]
    masks.append((rng.random((SIZE, SIZE)) < 0.3).astype(np.uint8) * 255)
    morph = 0
    for m in masks:
        for op in ("open", "close", "erode", "dilate"):
            for k, it in ((3, 1), (5, 2)):
                got = apply_morphological_operations(m, op, k, it, "cuda")
                ref = apply_morphological_operations(m, op, k, it, "cpu")
                if not np.array_equal(got, ref):
                    raise AssertionError(f"morphology {op} k{k} x{it}: "
                                         "card differs from the CPU")
                morph += 1
    manifest = tmp / "manifest_split.json"
    out = tmp / "library_eval"
    metrics = evaluate_from_manifest(
        Predictor(tmp / "trained", device="cuda").load(), manifest, "val",
        out)
    results = json.loads((out / "evaluation_results.json").read_text())
    n_val = sum(it["split"] == "val"
                for it in json.loads(manifest.read_text())["items"])
    labels = results["evaluation_info"]["class_labels"]
    if not (0.0 <= metrics["accuracy"] <= 1.0 and len(labels) == CLASSES
            and results["evaluation_info"]["valid_predictions"] == n_val
            and all(f"f1_{lab}" in metrics for lab in labels)):
        raise AssertionError(f"evaluate_from_manifest: {metrics}")
    log("24 library", warp_shape=[BATCH, SIZE, SIZE, 3],
        warp_max_abs_err_card_vs_cpu=json.dumps(warp_err), warp_tol=1e-3,
        warp_ms=f"{warp_ms:.3f}", morphology_cases=morph,
        morphology_exact=True, eval_split="val", eval_images=n_val,
        eval_accuracy=f"{metrics['accuracy']:.4f}",
        eval_macro_f1=f"{metrics['macro_f1']:.4f}",
        seconds=f"{time.perf_counter() - t_phase:.1f}")


# phase 25: data parallelism on the one card, two ranks sharing cuda:0
# over gloo (NCCL refuses two ranks on one GPU)
DP_RANKS, DP_EQ_STEPS, DP_EQ_BATCH, DP_EQ_SIZE = 2, 5, 8, 64
DP_TIMEOUT_S = 420  # a rank's whole run; its collectives give up sooner
DP_DRIFT_FACTOR = 3  # steps 2-5 against the cuDNN-off control's drift


def state_digest_tensor(torch, state, full: bool = True):
    """Every tensor of a TrainState (model, moments, EMA) in one flat f32
    vector, in a fixed order: a sharded state's gathered to full tensors
    (every rank of its model group calls this), or with `full` false this
    rank's own blocks."""
    from leaffliction_tpu_torch.parallel.tensor import full_sections

    sections = full_sections(state) if full else {
        "model": state.model.state_dict(), "mu": state.mu, "nu": state.nu,
        "ema_params": state.ema_params,
        "ema_batch_stats": state.ema_batch_stats}
    parts = []
    for name in ("model", "mu", "nu", "ema_params", "ema_batch_stats"):
        parts += [v for _, v in sorted(sections[name].items())]
    return torch.cat([p.detach().reshape(-1).float() for p in parts])


def dp_equivalence_steps(torch, images, labels, seed: int, mesh=None,
                         cudnn: bool = True, arch: str = "leafcnn",
                         first_step=None):
    """leafcnn-base (or `arch`, a ResNet preset), f32, REGULARIZED,
    augmentation and dropout on, one step a batch of `images` (this rank's
    rows with a mesh; with a `model` axis, the state sharded at JAX's
    `min_size`) from `seed`'s weights, TF32 off, cuDNN deterministic (or
    off) → (losses, the state, the first step's gradients as the optimizer
    got them: global, after the all-reduce, on the host in f64, gathered
    to full tensors when sharded). `first_step`, when given, returns the
    context the first step runs in (`Decisions.recording` or
    `.replaying`)."""
    from leaffliction_tpu_torch.parallel.mesh import TP_MIN_SIZE
    from leaffliction_tpu_torch.parallel.tensor import (
        gather_tensors,
        shard_train_state,
    )
    from leaffliction_tpu_torch.train import steps
    from leaffliction_tpu_torch.train.config import TrainConfig

    device = "cuda:0"
    state = steps.create_train_state(
        smoke_model(torch, arch, "conv", torch.float32), seed, device)
    if mesh is not None and mesh.model > 1:
        shard_train_state(state, mesh, TP_MIN_SIZE)
    fns = steps.build_step_fns(TrainConfig.regularized(), CLASSES, 100,
                               mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = slice(None) if mesh is None else mesh.rows(images.shape[1])
    mask = torch.ones(images.shape[1], device=device)[rows]
    losses, first = [], []
    real = steps.apply_updates

    def recording(params, grads, *args, **kwargs):
        if not first:
            first.extend(g.detach().double().cpu() for g in grads)
        return real(params, grads, *args, **kwargs)

    steps.apply_updates = recording
    try:
        with torch.backends.cudnn.flags(enabled=cudnn, deterministic=True,
                                        benchmark=False, allow_tf32=False):
            for i in range(images.shape[0]):
                with (first_step() if first_step is not None and i == 0
                      else contextlib.nullcontext()):
                    m = fns.train_step(
                        state, torch.from_numpy(images[i][rows]).to(device),
                        torch.from_numpy(labels[i][rows]).to(device), mask,
                        gen)
                losses.append(float(m["loss"]))
    finally:
        steps.apply_updates = real
    if state.tp is not None:
        names = list(state.params)
        full = gather_tensors(dict(zip(names, first)), state.sharded,
                              state.tp)
        first = [full[k] for k in names]
    return losses, state, first


def rank_main(rank: int, job: dict) -> None:
    """One rank of phase 25 or 26 (a spawned process, one of
    `job["world"]`): joins the gloo group on cuda:0 through `parallel/`,
    runs its phase's rank function (`dp_rank_run`, `tp_rank_run`) and
    writes its results to `rank<r>.pt` (or its traceback to
    `rank<r>.err`)."""
    import traceback

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(job["world"]),
                      LOCAL_WORLD_SIZE=str(job["world"]),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(job["port"]))
    sys.path.insert(0, str(ROOT))
    out = Path(job["out"])
    try:
        import torch

        run = dp_rank_run if job["run"] == "dp" else tp_rank_run
        torch.save(run(torch, job), out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def spawn_ranks(torch, job: dict, tag: str):
    """`job["world"]` ranks of `rank_main` (spawned, each killed if the
    ranks outlive DP_TIMEOUT_S) → (each rank's results, their seconds);
    raises with the ranks' tracebacks if any failed."""
    import torch.multiprocessing as tmp_mp

    job = {**job, "port": free_port()}
    out = Path(job["out"])
    ctx = tmp_mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, job))
             for r in range(job["world"])]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + DP_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
    seconds = time.perf_counter() - t0
    errs = [out / f"rank{r}.err" for r in range(job["world"])]
    if alive or any(p.exitcode != 0 for p in procs):
        detail = "\n".join(e.read_text()[-3000:] for e in errs if e.exists())
        raise AssertionError(f"{tag} ranks: exit codes "
                             f"{[p.exitcode for p in procs]}, "
                             f"{len(alive)} killed after {DP_TIMEOUT_S} s\n"
                             f"{detail}")
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(job["world"])]
    if any(r["backend"] != "gloo" for r in ranks):
        raise AssertionError(f"{tag}: backends "
                             f"{[r['backend'] for r in ranks]}")
    return ranks, seconds


@contextlib.contextmanager
def cli_recorders(torch, mesh):
    """Recorders for a rank's train CLI runs → `run(argv, cwd)`: the
    artifact writers, the fused balance's flags, the replication checks,
    the step times (CUDA events and host clock) and the host time and
    bytes of the collectives inside the steps (`all_reduce`, and
    `all_gather` of the model group's activations); each run's kernel
    calls are held against their twins, and the launch counts are reset
    just before the run and read just after it."""
    import torch.distributed as dist

    from leaffliction_tpu_torch.cli.train import main as train_main
    from leaffliction_tpu_torch.data import fused_balance
    from leaffliction_tpu_torch.ops.kernels.rotate import train_aug
    from leaffliction_tpu_torch.ops.kernels.warp import (
        rotate_expand,
        shear_cubic,
    )
    from leaffliction_tpu_torch.parallel import mesh as mesh_mod
    from leaffliction_tpu_torch.train import artifacts
    from leaffliction_tpu_torch.train.steps import StepFns

    wrote, flags, digests, steps = [], [], [], []
    coll = {"in_step": False}
    real = {"save": artifacts.save_training_artifacts,
            "check": mesh_mod.check_replicated,
            "step": StepFns._step, "all_reduce": dist.all_reduce,
            "all_gather": dist.all_gather,
            **{n: getattr(fused_balance, n)
               for n in ("balance_to_device", "split_fused_result")}}

    def save(out_dir, *args, **kwargs):
        wrote.append(str(out_dir))
        return real["save"](out_dir, *args, **kwargs)

    def check(t, m, what="tensor"):
        digests.append((what, real["check"](t, m, what)))
        return digests[-1][1]

    def step(self, *args, **kwargs):
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        coll["in_step"] = True
        try:
            m = real["step"](self, *args, **kwargs)
        finally:
            coll["in_step"] = False
        end.record()
        steps.append((start, end, t0, time.perf_counter()))
        return m

    def timed(name, nbytes):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real[name](*args, **kwargs)
            finally:
                if coll["in_step"]:
                    coll[f"{name}_s"] += time.perf_counter() - t0
                    coll[f"{name}_bytes"] += nbytes(*args)
        return call

    def flagged(name):
        def call(*args, **kwargs):
            flags.append((name, kwargs.get("write_artifacts")))
            return real[name](*args, **kwargs)
        return call

    def run(argv, cwd):
        wrote.clear()
        flags.clear()
        digests.clear()
        steps.clear()
        for name in ("all_reduce", "all_gather"):
            coll[f"{name}_s"] = coll[f"{name}_bytes"] = 0
        here = os.getcwd()
        os.chdir(cwd)
        try:
            # --- a rank's main path: counts from here to the run's end ---
            train_aug.launches = rotate_expand.launches = 0
            shear_cubic.launches = 0
            with held_against_twins() as held, k1_recorded() as k1_calls:
                t0 = time.perf_counter()
                run = train_main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches = {"train_aug": train_aug.launches,
                        "rotate_expand": rotate_expand.launches,
                        "shear_cubic": shear_cubic.launches}
            # --- end of the rank's main path ---
        finally:
            os.chdir(here)
        if run is None:
            raise AssertionError(f"rank {mesh.rank}: train CLI stopped early")
        k1_err = k1_held(torch, k1_calls)
        bad = [h for h in held if h[3] != 0]
        if bad:
            raise AssertionError(f"rank {mesh.rank}: kernel calls differ "
                                 f"from their twins: {bad[:4]}")
        torch.cuda.synchronize()
        dev_ms = [s.elapsed_time(e) for s, e, _, _ in steps][1:] or [0.0]
        host_s = sum(b - a for _, _, a, b in steps)
        fit = run["fit"]
        flat = state_digest_tensor(torch, fit.state)
        return {"launches": launches, "k1_calls": len(k1_calls),
                "k1_err": k1_err,
                "held": [(h[0], h[1], h[2]) for h in held],
                "steps": fit.steps_ran, "history": fit.history,
                "wrote": list(wrote), "flags": list(flags),
                "replicated": list(digests),
                "state_digest": real["check"](flat, mesh,
                                              "the trained state"),
                "step_ms_median": float(np.median(dev_ms)),
                "step_ms_min": min(dev_ms), "step_host_s": host_s,
                "all_reduce_host_s": coll["all_reduce_s"],
                "all_gather_host_s": coll["all_gather_s"],
                "all_reduce_bytes": coll["all_reduce_bytes"],
                "all_gather_bytes": coll["all_gather_bytes"],
                "wall_s": wall, "train_s": fit.train_time_s,
                "img_per_s": fit.images_per_sec}

    def reduced_bytes(t, *args):
        return t.numel() * t.element_size()

    def gathered_bytes(out, *args):
        return sum(t.numel() * t.element_size() for t in out)

    artifacts.save_training_artifacts = save
    mesh_mod.check_replicated = check
    StepFns._step = step  # each step, alone or in a chunk
    dist.all_reduce = timed("all_reduce", reduced_bytes)
    dist.all_gather = timed("all_gather", gathered_bytes)
    for name in ("balance_to_device", "split_fused_result"):
        setattr(fused_balance, name, flagged(name))
    try:
        yield run
    finally:
        artifacts.save_training_artifacts = real["save"]
        mesh_mod.check_replicated = real["check"]
        StepFns._step = real["step"]
        dist.all_reduce = real["all_reduce"]
        dist.all_gather = real["all_gather"]
        for name in ("balance_to_device", "split_fused_result"):
            setattr(fused_balance, name, real[name])


def dp_rank_run(torch, job: dict) -> dict:
    from leaffliction_tpu_torch.core.device import resolve_device
    from leaffliction_tpu_torch.parallel import distributed
    from leaffliction_tpu_torch.parallel import mesh as mesh_mod

    device = resolve_device("cuda:0")
    backend = distributed.maybe_initialize("cuda:0", timeout_s=300)
    mesh = mesh_mod.make_mesh(mesh_mod.MeshSpec(), device)
    res = {"backend": backend}

    # (a) the f32 equivalence steps on this rank's rows
    eq = np.load(job["eq"])
    decisions = Decisions(torch)
    losses, state, grads = dp_equivalence_steps(
        torch, eq["images"], eq["labels"], job["seed"], mesh,
        first_step=decisions.recording)
    flat = state_digest_tensor(torch, state)
    res["a"] = {"decisions": decisions.seen, "losses": losses,
                "grads": grads,
                "digest": mesh_mod.check_replicated(
                    flat, mesh, "the equivalence run's state"),
                "state": flat.cpu()}
    del state

    common = ["--epochs", "2", "--img-size", str(job["size"]),
              "--batch-size", str(job["batch"]), "--seed", str(job["seed"]),
              "--device", "cuda:0", "--mesh-data", str(DP_RANKS)]
    with cli_recorders(torch, mesh) as cli_run:
        if job.get("manifest"):
            res["b"] = cli_run(["--manifest", job["manifest"],
                                "--out-dir", str(Path(job["out"]) / "b"),
                                *common], job["out"])
        if job.get("tree"):
            res["c"] = cli_run(["--balance-from", job["tree"],
                                "--out-dir", str(Path(job["out"]) / "c"),
                                *common], str(Path(job["out"]) / "c_cwd"))
    mesh.barrier()
    distributed.shutdown()
    return res


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ranks_decisions(torch, ranks_seen: list, mesh_shape, shapes) -> list:
    """The first-step decisions of the ranks of a (data, model) mesh as one
    process's, each of `shapes` (rank r is data index r // model and model
    index r % model): rows by data index; channels by model index where a
    rank held a block of them."""
    d, t = mesh_shape
    out = []
    for k, shape in enumerate(shapes):
        blocks = []
        for di in range(d):
            parts = [ranks_seen[di * t + mi][k] for mi in range(t)]
            blocks.append(torch.cat(parts, dim=1) if len(shape) > 1
                          and parts[0].shape[1] != shape[1] else parts[0])
        out.append(torch.cat(blocks, dim=0))
        if tuple(out[-1].shape) != tuple(shape):
            raise AssertionError(f"decision {k}: the ranks' make "
                                 f"{tuple(out[-1].shape)}, one process "
                                 f"{tuple(shape)}")
    return out


def one_process_reference(torch, images, labels, seed: int,
                          arch: str = "leafcnn", ranks_seen=None,
                          mesh_shape=None) -> dict:
    """The one-process f32 run on the global batch (`dp_equivalence_steps`,
    cuDNN deterministic), its first step on the ranks' ReLU and max-pool
    decisions (`ranks_seen`, each rank's `Decisions.seen` of a
    `mesh_shape` mesh: without them a value within rounding of 0 or of a
    tie, where the ranks' sums ran in another order, sends a gradient
    elsewhere), and its control with cuDNN off: the losses, the first
    step's gradients, the final params (flat f64, in the params' order),
    the state_dict's shapes and the control's drift."""
    def flat_params(state):
        return torch.cat([v.detach().double().cpu().ravel()
                          for v in state.params.values()])

    own = Decisions(torch)
    dp_equivalence_steps(torch, images[:1], labels[:1], seed, arch=arch,
                         first_step=own.recording)
    shared = ranks_decisions(torch, ranks_seen, mesh_shape,
                             [t.shape for t in own.seen])
    flips = sum(int((a != b).sum()) for a, b in zip(shared, own.seen))
    losses, state, grads = dp_equivalence_steps(
        torch, images, labels, seed, arch=arch,
        first_step=lambda: Decisions(torch).replaying(shared))
    ctl_losses, ctl_state, _ = dp_equivalence_steps(
        torch, images, labels, seed, cudnn=False, arch=arch)
    params = flat_params(state)
    return {"losses": losses, "grads": grads, "params": params,
            "names": list(state.params),
            "shapes": {k: tuple(v.shape)
                       for k, v in state.model.state_dict().items()},
            "ctl_loss_rel": [abs(g - w) / abs(w)
                             for g, w in zip(ctl_losses, losses)],
            "ctl_params_rel": rel_l2(flat_params(ctl_state), params),
            "flips": flips, "decisions": sum(t.numel() for t in shared)}


def rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def held_to_reference(torch, tag: str, losses, grads, params, ref) -> dict:
    """A multi-rank run against `one_process_reference`: the first step at
    phase 9's cuDNN bars (loss 1e-4 relative, the gradients together 1e-3
    relative L2 and each 1e-2); every step's loss and the final params
    within max(phase 9's bar, DP_DRIFT_FACTOR × the control's drift),
    since Adam's first updates of near-zero gradients turn any summation
    order's rounding into ±lr flips → the log fields; raises otherwise."""
    loss_rel = [abs(g - w) / abs(w) for g, w in zip(losses, ref["losses"])]
    grads_all = rel_l2(torch.cat([g.ravel() for g in grads]),
                       torch.cat([g.ravel() for g in ref["grads"]]))
    grads_worst = max((rel_l2(g, w), n) for g, w, n in zip(
        grads, ref["grads"], ref["names"]))
    if not (loss_rel[0] <= 1e-4 and grads_all <= 1e-3
            and grads_worst[0] <= 1e-2):
        raise AssertionError(f"{tag}: first step loss rel {loss_rel[0]}, "
                             f"gradients all {grads_all}, worst "
                             f"{grads_worst}")
    params_rel = rel_l2(params, ref["params"])
    loss_bars = [max(1e-4, DP_DRIFT_FACTOR * c) for c in ref["ctl_loss_rel"]]
    params_bar = max(1e-3, DP_DRIFT_FACTOR * ref["ctl_params_rel"])
    if not (all(g <= b for g, b in zip(loss_rel, loss_bars))
            and params_rel <= params_bar):
        raise AssertionError(f"{tag}: loss rel by step {loss_rel} against "
                             f"bars {loss_bars} (control "
                             f"{ref['ctl_loss_rel']}); params rel L2 "
                             f"{params_rel} against {params_bar} (control "
                             f"{ref['ctl_params_rel']})")
    return dict(
        step1_loss_rel_err=f"{loss_rel[0]:.3e}",
        step1_grads_rel_l2=f"{grads_all:.3e}",
        step1_worst_grad_rel_l2=f"{grads_worst[0]:.3e}",
        step1_worst_grad=grads_worst[1], tol_loss=1e-4, tol_grads=1e-3,
        tol_worst=1e-2,
        step1_on_the_ranks_decisions=f"{ref['flips']} of {ref['decisions']} "
                                     "differed from the one process's own",
        loss_rel_err_by_step=json.dumps([f"{v:.2e}" for v in loss_rel]),
        params_rel_l2_after=f"{params_rel:.3e}",
        control_cudnn_off_loss_rel_by_step=json.dumps(
            [f"{v:.2e}" for v in ref["ctl_loss_rel"]]),
        control_cudnn_off_params_rel_l2_after=f"{ref['ctl_params_rel']:.3e}",
        tol_loss_by_step=json.dumps([f"{v:.2e}" for v in loss_bars]),
        tol_params_after=f"{params_bar:.3e}",
        drift_factor=DP_DRIFT_FACTOR)


def phase_data_parallel(torch, tmp: Path, seed: int, rng, tree, train_ms,
                        learn: Path, images: np.ndarray):
    """25. Data parallelism on the one card (two ranks on cuda:0, gloo):
    (a) f32 equivalence against one process at the global batch, (b) the
    train CLI at full width on phase 11's manifest, (c) `--balance-from` on
    phase 14's tree, each rank's kernel calls held against their twins, and
    (d) the serving mesh against the one-device predictor → (the ranks'
    kernel launches, K1's largest error, (a)'s inputs and one-process
    reference and (b)'s ms a step, for phase 26)."""
    t_phase = time.perf_counter()
    work = tmp / "dp"
    (work / "c_cwd").mkdir(parents=True)
    eq_images = rng.integers(0, 256, (DP_EQ_STEPS, DP_RANKS * DP_EQ_BATCH,
                                      DP_EQ_SIZE, DP_EQ_SIZE, 3), np.uint8)
    eq_labels = rng.integers(0, CLASSES, eq_images.shape[:2])
    np.savez(work / "eq.npz", images=eq_images, labels=eq_labels)
    manifest = tmp / "manifest_split.json"
    job = {"run": "dp", "world": DP_RANKS, "out": str(work),
           "eq": str(work / "eq.npz"), "seed": seed, "size": SIZE,
           "batch": TRAIN_BATCH,
           "manifest": str(manifest) if manifest.exists() else None,
           "tree": str(tree) if tree is not None else None}

    ranks, ranks_s = spawn_ranks(torch, job, "phase 25")

    # (a) against one process at the global batch (`one_process_reference`
    # and `held_to_reference`)
    a0, a1 = ranks[0]["a"], ranks[1]["a"]
    if a0["digest"] != a1["digest"] or not torch.equal(a0["state"],
                                                       a1["state"]):
        raise AssertionError("phase 25a: the ranks' states differ")
    ref = one_process_reference(torch, eq_images, eq_labels, seed,
                                ranks_seen=[a0["decisions"], a1["decisions"]],
                                mesh_shape=(DP_RANKS, 1))
    # the flat state starts with the model's state_dict in sorted order
    keys = sorted(ref["shapes"])
    sizes = [int(np.prod(ref["shapes"][k])) for k in keys]
    parts = a0["state"][:sum(sizes)].double().split(sizes)
    got_sd = {k: p.view(ref["shapes"][k]) for k, p in zip(keys, parts)}
    held = held_to_reference(
        torch, "phase 25a", a0["losses"], a0["grads"],
        torch.cat([got_sd[k].ravel() for k in ref["names"]]), ref)
    log("25a dp equivalence", model="leafcnn-base", img=DP_EQ_SIZE,
        dtype="f32", tf32=False, cudnn="deterministic", ranks=DP_RANKS,
        backend="gloo", per_rank_batch=DP_EQ_BATCH,
        global_batch=DP_RANKS * DP_EQ_BATCH, steps=DP_EQ_STEPS,
        ranks_bit_equal=True, **held)

    launches = {"train_aug": 0, "rotate_expand": 0, "shear_cubic": 0}
    k1_err, b_ms = 0.0, None
    for part, name in (("b", "25b dp train cli"), ("c", "25c dp balance")):
        if part not in ranks[0]:
            log(name, skipped="PIL is not installed")
            continue
        r0, r1 = ranks[0][part], ranks[1][part]
        for r in (r0, r1):
            for k, n in r["launches"].items():
                launches[k] += n
            k1_err = max(k1_err, r["k1_err"]["f32"])
        out = work / part
        if (r0["wrote"], r1["wrote"]) != ([str(out)], []):
            raise AssertionError(f"phase 25{part}: artifacts written by "
                                 f"{r0['wrote']} / {r1['wrote']}")
        if r0["state_digest"] != r1["state_digest"] \
                or r0["history"] != r1["history"] \
                or r0["steps"] != r1["steps"]:
            raise AssertionError(f"phase 25{part}: the ranks differ")
        if (r0["launches"]["train_aug"] != r0["steps"]
                or r1["launches"]["train_aug"] != r1["steps"]):
            raise AssertionError(f"phase 25{part}: K1 launches "
                                 f"{r0['launches']} for {r0['steps']} steps")
        meta = json.loads((out / "meta.json").read_text())
        if meta["system"]["mesh"] != {"data": DP_RANKS, "model": 1} \
                or meta["system"]["collective_backend"] != "gloo":
            raise AssertionError(f"phase 25{part}: meta system "
                                 f"{meta['system']}")
        loss = np.asarray(r0["history"]["loss"] + r0["history"]["val_loss"])
        if not np.isfinite(loss).all():
            raise AssertionError(f"phase 25{part}: history {r0['history']}")
        fields = {}
        if part == "b":
            if not r0["history"]["loss"][-1] < r0["history"]["loss"][0]:
                raise AssertionError(f"phase 25b: train loss did not fall: "
                                     f"{r0['history']['loss']}")
            ms = b_ms = max(r0["step_ms_median"], r1["step_ms_median"])
            one_rank_ips = TRAIN_BATCH * 1e3 / train_ms
            share = r0["all_reduce_host_s"] / max(r0["step_host_s"], 1e-9)
            fields = dict(
                per_rank_batch=TRAIN_BATCH, global_batch=2 * TRAIN_BATCH,
                ms_per_step_median=f"{ms:.3f}",
                global_img_per_s=f"{2 * TRAIN_BATCH * 1e3 / ms:.1f}",
                one_rank_ms_per_step_phase10=f"{train_ms:.3f}",
                one_rank_img_per_s_phase10=f"{one_rank_ips:.1f}",
                all_reduce_host_share=f"{share:.3f}",
                step_host_s_rank0=f"{r0['step_host_s']:.3f}",
                all_reduce_host_s_rank0=f"{r0['all_reduce_host_s']:.3f}",
                note="two ranks time-share one card and reduce through the "
                     "host (gloo)")
        else:
            datasets = work / "c_cwd" / "artifacts" / "datasets"
            if r0["flags"] != [("balance_to_device", True),
                               ("split_fused_result", True)] or \
                    r1["flags"] != [("balance_to_device", False),
                                    ("split_fused_result", False)]:
                raise AssertionError(f"phase 25c: artifact flags "
                                     f"{r0['flags']} / {r1['flags']}")
            if len(r0["replicated"]) != 4 \
                    or r0["replicated"] != r1["replicated"]:
                raise AssertionError(f"phase 25c: replication checks "
                                     f"{r0['replicated']}")
            if not (datasets / "manifest_split.json").exists():
                raise AssertionError("phase 25c wrote no manifests")
            for kernel in ("rotate_expand", "shear_cubic"):
                if r0["launches"][kernel] <= 0:
                    raise AssertionError(f"phase 25c: {kernel} never "
                                         "launched")
            fields = dict(replicated=len(r0["replicated"]),
                          k2_launches=r0["launches"]["rotate_expand"],
                          k3_launches=r0["launches"]["shear_cubic"],
                          k2_k3_calls_held=len(r0["held"]),
                          ms_per_step_median=f"{r0['step_ms_median']:.3f}")
        log(name, ranks=DP_RANKS, backend="gloo", model="leafcnn-base",
            img=SIZE, dtype="bf16", epochs=2, steps=r0["steps"],
            k1_launches_per_rank=r0["launches"]["train_aug"],
            k1_err_bf16=r0["k1_err"]["bf16"], k1_err_f32=r0["k1_err"]["f32"],
            artifacts_by="rank 0", ranks_bit_equal=True,
            loss=json.dumps([round(v, 5) for v in r0["history"]["loss"]]),
            val_accuracy=json.dumps(r0["history"]["val_accuracy"]),
            wall_s=f"{r0['wall_s']:.2f}", **fields)

    phase_serving_mesh(torch, tmp, seed, learn, images)
    log("25 data parallel", seconds=f"{time.perf_counter() - t_phase:.1f}",
        ranks_seconds=f"{ranks_s:.1f}")
    return launches, k1_err, {"images": eq_images, "labels": eq_labels,
                              "b_ms": b_ms}


# phase 26: tensor parallelism on the one card, the ranks sharing cuda:0
# over gloo: (a) four ranks on data 2 x model 2, (b) and (c) two on 1 x 2
TP_A_MESH, TP_B_MESH = (2, 2), (1, 2)
TP_B_STEPS, TP_B_BATCH = 3, 8


def tp_rank_run(torch, job: dict) -> dict:
    """One rank of phase 26: the f32 equivalence steps of `job["arch"]` on
    the job's mesh (the state sharded at JAX's `min_size` 64) → the
    losses, the first step's gradients and the final params gathered to
    full tensors, the gathered and the rank's own state digests; with a
    manifest, then the train CLI with `--mesh-model` (`cli_recorders`)."""
    from leaffliction_tpu_torch.core.device import resolve_device
    from leaffliction_tpu_torch.parallel import distributed
    from leaffliction_tpu_torch.parallel import mesh as mesh_mod
    from leaffliction_tpu_torch.parallel.tensor import full_sections

    device = resolve_device("cuda:0")
    backend = distributed.maybe_initialize("cuda:0", timeout_s=300)
    d, t = job["mesh"]
    mesh = mesh_mod.make_mesh(mesh_mod.MeshSpec(data=d, model=t), device)
    eq = np.load(job["eq"])
    decisions = Decisions(torch)
    losses, state, grads = dp_equivalence_steps(
        torch, eq["images"], eq["labels"], job["seed"], mesh,
        arch=job["arch"], first_step=decisions.recording)
    model = full_sections(state)["model"]
    res = {"backend": backend, "model_rank": mesh.model_rank,
           "eq": {"decisions": decisions.seen, "losses": losses,
                  "grads": grads,
                  "params": torch.cat([model[k].detach().double().cpu()
                                       .ravel() for k in state.params]),
                  "full": state_digest_tensor(torch, state).cpu(),
                  "local": state_digest_tensor(torch, state,
                                               full=False).cpu(),
                  "sharded": sum(state.sharded.values())}}
    del state, model
    if job.get("manifest"):
        argv = ["--manifest", job["manifest"], "--out-dir",
                str(Path(job["out"]) / "c"), "--epochs", "2", "--img-size",
                str(SIZE), "--batch-size", str(TRAIN_BATCH), "--seed",
                str(job["seed"]), "--device", "cuda:0", "--mesh-data",
                str(d), "--mesh-model", str(t)]
        with cli_recorders(torch, mesh) as cli_run:
            res["c"] = cli_run(argv, job["out"])
    mesh.barrier()
    distributed.shutdown()
    return res


def tp_held(torch, tag: str, ranks, ref) -> dict:
    """The ranks of a TP equivalence run alike (every rank's gathered
    state bit-equal, which holds every rank's replicated tensors equal
    and each block equal across its data group; each rank's own blocks
    bit-equal across its data group; the losses equal), then rank 0's run
    `held_to_reference`."""
    first = ranks[0]["eq"]
    blocks = {}
    for r in ranks:
        if not torch.equal(r["eq"]["full"], first["full"]) \
                or r["eq"]["losses"] != first["losses"]:
            raise AssertionError(f"{tag}: the ranks' gathered states or "
                                 "losses differ")
        mine = blocks.setdefault(r["model_rank"], r["eq"]["local"])
        if not torch.equal(mine, r["eq"]["local"]):
            raise AssertionError(f"{tag}: model index {r['model_rank']}'s "
                                 "blocks differ across its data group")
    if first["sharded"] <= 0:
        raise AssertionError(f"{tag}: no tensor was sharded")
    return held_to_reference(torch, tag, first["losses"], first["grads"],
                             first["params"], ref)


def phase_tensor_parallel(torch, tmp: Path, seed: int, train_ms, dp_eq,
                          learn: Path, images: np.ndarray) -> dict:
    """26. Tensor parallelism on the one card (ranks on cuda:0, gloo;
    correctness and the collectives' cost, not scaling): (a) leafcnn-base
    f32 on data 2 x model 2 against one process on 25a's inputs and its
    control;
    (b) resnet10 f32 on 1 x 2 against one process; (c) the train CLI with
    `--mesh-model 2` on phase 11's manifest, every K1 call held against its
    twin, the saved model served by the one-device predictor → the ranks'
    kernel launches in (c)."""
    from leaffliction_tpu_torch.predict.predictor import Predictor

    t_phase = time.perf_counter()
    work_a, work_b = tmp / "tp_a", tmp / "tp_b"
    work_a.mkdir(parents=True)
    work_b.mkdir(parents=True)
    np.savez(work_a / "eq.npz", images=dp_eq["images"],
             labels=dp_eq["labels"])
    rng = np.random.default_rng([seed, 26])
    b_images = rng.integers(0, 256, (TP_B_STEPS, TP_B_BATCH, DP_EQ_SIZE,
                                     DP_EQ_SIZE, 3), np.uint8)
    b_labels = rng.integers(0, CLASSES, b_images.shape[:2])
    np.savez(work_b / "eq.npz", images=b_images, labels=b_labels)
    manifest = tmp / "manifest_split.json"

    ranks, a_s = spawn_ranks(torch, {
        "run": "tp", "world": TP_A_MESH[0] * TP_A_MESH[1], "mesh": TP_A_MESH,
        "arch": "leafcnn", "out": str(work_a), "eq": str(work_a / "eq.npz"),
        "seed": seed}, "phase 26a")
    ref = one_process_reference(
        torch, dp_eq["images"], dp_eq["labels"], seed,
        ranks_seen=[r["eq"]["decisions"] for r in ranks],
        mesh_shape=TP_A_MESH)
    held = tp_held(torch, "phase 26a", ranks, ref)
    log("26a tp equivalence", model="leafcnn-base", img=DP_EQ_SIZE,
        dtype="f32", tf32=False, cudnn="deterministic",
        mesh=json.dumps(dict(zip(("data", "model"), TP_A_MESH))),
        ranks=len(ranks), backend="gloo", min_size=64,
        sharded_keys=ranks[0]["eq"]["sharded"],
        per_data_rank_batch=DP_EQ_BATCH,
        global_batch=TP_A_MESH[0] * DP_EQ_BATCH, steps=DP_EQ_STEPS,
        reference="one process on phase 25a's inputs and its control",
        ranks_alike=True, **held)

    ranks, b_s = spawn_ranks(torch, {
        "run": "tp", "world": TP_B_MESH[0] * TP_B_MESH[1], "mesh": TP_B_MESH,
        "arch": "resnet10", "out": str(work_b),
        "eq": str(work_b / "eq.npz"), "seed": seed,
        "manifest": str(manifest) if manifest.exists() else None},
        "phase 26b")
    ref = one_process_reference(
        torch, b_images, b_labels, seed, arch="resnet10",
        ranks_seen=[r["eq"]["decisions"] for r in ranks],
        mesh_shape=TP_B_MESH)
    held = tp_held(torch, "phase 26b", ranks, ref)
    log("26b tp resnet10", model="resnet10", img=DP_EQ_SIZE, dtype="f32",
        tf32=False, cudnn="deterministic",
        mesh=json.dumps(dict(zip(("data", "model"), TP_B_MESH))),
        ranks=len(ranks), backend="gloo", min_size=64,
        sharded_keys=ranks[0]["eq"]["sharded"], batch=TP_B_BATCH,
        steps=TP_B_STEPS,
        reference="one process and its cuDNN-off control",
        ranks_alike=True, **held)

    launches = {"train_aug": 0}
    if "c" not in ranks[0]:
        log("26c tp train cli", skipped="PIL is not installed")
    else:
        r0, r1 = ranks[0]["c"], ranks[1]["c"]
        out = work_b / "c"
        if (r0["wrote"], r1["wrote"]) != ([str(out)], []):
            raise AssertionError(f"phase 26c: artifacts written by "
                                 f"{r0['wrote']} / {r1['wrote']}")
        if r0["state_digest"] != r1["state_digest"] \
                or r0["history"] != r1["history"] \
                or r0["steps"] != r1["steps"]:
            raise AssertionError("phase 26c: the ranks differ")
        for r in (r0, r1):
            if r["launches"]["train_aug"] != r["steps"]:
                raise AssertionError(f"phase 26c: K1 launches "
                                     f"{r['launches']} for {r['steps']} "
                                     "steps")
            launches["train_aug"] += r["launches"]["train_aug"]
        meta = json.loads((out / "meta.json").read_text())
        if meta["system"]["mesh"] != {"data": 1, "model": 2} \
                or meta["system"]["collective_backend"] != "gloo":
            raise AssertionError(f"phase 26c: meta system {meta['system']}")
        hist = r0["history"]
        loss = np.asarray(hist["loss"] + hist["val_loss"])
        if not np.isfinite(loss).all() \
                or not hist["loss"][-1] < hist["loss"][0]:
            raise AssertionError(f"phase 26c: history {hist}")
        # the saved (gathered) model on the one-device predictor, at phase
        # 6's gates
        probs = Predictor(out, device="cuda:0").load()._probs_for_arrays(
            images[:64])
        row_err = float(np.abs(probs.sum(-1) - 1.0).max())
        prob_err = float(np.abs(probs[:BATCH] - cpu_f32_forward(
            torch, out, images[:BATCH])).max())
        if probs.shape != (64, CLASSES) or not np.isfinite(probs).all() \
                or not row_err <= 1e-3 or not prob_err <= 2e-2:
            raise AssertionError(f"phase 26c: served {probs.shape}, rows "
                                 f"off by {row_err}, |dprob| vs CPU f32 "
                                 f"{prob_err}")
        ms = max(r0["step_ms_median"], r1["step_ms_median"])
        steps = r0["steps"]
        coll_s = r0["all_gather_host_s"] + r0["all_reduce_host_s"]
        log("26c tp train cli", model="leafcnn-base", img=SIZE,
            dtype="bf16", mesh=json.dumps({"data": 1, "model": 2}),
            ranks=2, backend="gloo", batch=TRAIN_BATCH, epochs=2,
            steps=steps, k1_launches_per_rank=r0["launches"]["train_aug"],
            k1_err_bf16=max(r0["k1_err"]["bf16"], r1["k1_err"]["bf16"]),
            k1_err_f32=max(r0["k1_err"]["f32"], r1["k1_err"]["f32"]),
            artifacts_by="rank 0", ranks_bit_equal=True,
            loss=json.dumps([round(v, 5) for v in hist["loss"]]),
            val_accuracy=json.dumps(hist["val_accuracy"]),
            served_max_dprob_vs_cpu_f32=f"{prob_err:.3e}",
            served_row_sum_err=f"{row_err:.2e}",
            ms_per_step_median=f"{ms:.3f}",
            img_per_s=f"{TRAIN_BATCH * 1e3 / ms:.1f}",
            one_rank_ms_per_step_phase10=f"{train_ms:.3f}",
            one_rank_img_per_s_phase10=f"{TRAIN_BATCH * 1e3 / train_ms:.1f}",
            dp_ms_per_step_phase25b=(f"{dp_eq['b_ms']:.3f}"
                                     if dp_eq["b_ms"] else None),
            dp_global_img_per_s_phase25b=(
                f"{2 * TRAIN_BATCH * 1e3 / dp_eq['b_ms']:.1f}"
                if dp_eq["b_ms"] else None),
            gathered_bytes_per_step=int(r0["all_gather_bytes"] / steps),
            all_reduced_bytes_per_step=int(r0["all_reduce_bytes"] / steps),
            model_group_collectives_host_share=(
                f"{coll_s / max(r0['step_host_s'], 1e-9):.3f}"),
            all_gather_host_s_rank0=f"{r0['all_gather_host_s']:.3f}",
            all_reduce_host_s_rank0=f"{r0['all_reduce_host_s']:.3f}",
            step_host_s_rank0=f"{r0['step_host_s']:.3f}",
            wall_s=f"{r0['wall_s']:.2f}",
            note="two ranks time-share one card and gather through the "
                 "host (gloo)")
    log("26 tensor parallel",
        seconds=f"{time.perf_counter() - t_phase:.1f}",
        ranks_a_seconds=f"{a_s:.1f}", ranks_bc_seconds=f"{b_s:.1f}")
    return launches


def phase_serving_mesh(torch, tmp: Path, seed: int, learn: Path,
                       images: np.ndarray):
    """25d. `Predictor(devices=[cuda:0, cuda:0])` against the one-device
    predictor on 256 images, leafcnn-base and resnet18, f32 and bf16; the
    predict CLI's `--mesh-data 2` on the one card exits 1."""
    from leaffliction_tpu_torch.predict.predictor import Predictor

    for arch in ("leafcnn", "resnet18"):
        rng = np.random.default_rng([seed, 25])
        for dtype in (torch.float32, torch.bfloat16):
            model = smoke_model(torch, arch, "conv", dtype)
            model.load_state_dict(seeded_state_dict(torch, model, rng))
            one = Predictor.from_model(model, LABELS, SIZE, device="cuda:0")
            mesh = Predictor.from_model(model, LABELS, SIZE,
                                        devices=["cuda:0", "cuda:0"])
            t0 = time.perf_counter()
            p_one = one._probs_for_arrays(images)
            p_mesh = mesh._probs_for_arrays(images)
            wall = time.perf_counter() - t0
            d = float(np.abs(p_mesh - p_one).max())
            flips = int((p_mesh.argmax(-1) != p_one.argmax(-1)).sum())
            if dtype == torch.float32 and not d <= 1e-4:
                raise AssertionError(f"serving mesh {arch} f32: |dp| {d}")
            if dtype == torch.bfloat16 and flips:
                raise AssertionError(f"serving mesh {arch} bf16: top-1 "
                                     f"differs on {flips} images, |dp| {d}")
            log("25d serving mesh", arch=arch,
                dtype="f32" if dtype == torch.float32 else "bf16",
                devices="cuda:0,cuda:0", images=len(images),
                max_abs_dprob=f"{d:.3e}", top1_flips=flips,
                both_wall_s=f"{wall:.3f}")
    try:
        from PIL import Image
    except ImportError:
        log("25d predict cli mesh", skipped="PIL is not installed")
        return
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [q for q in [os.environ.get("PYTHONPATH")] if q]))
    img = tmp / "dp" / "one.jpg"
    Image.fromarray(images[0]).save(img)
    proc = subprocess.run(
        [sys.executable, "-m", "leaffliction_tpu_torch.cli.predict",
         str(img), "--mesh-data", "2", "-learnings", str(learn)],
        cwd=tmp / "dp", env=env, capture_output=True, text=True, timeout=300)
    said = proc.stdout + proc.stderr
    if proc.returncode != 1 or "does not cover 1 devices" not in said:
        raise AssertionError(f"predict --mesh-data 2 on one card: rc "
                             f"{proc.returncode}\n{said[-2000:]}")
    log("25d predict cli mesh", mesh_data=2, rc=proc.returncode,
        error=json.dumps("mesh 2x1 does not cover 1 devices"))


# phase 27: multi-step dispatch, K train steps a CUDA graph replay
CHAIN_K, CHAIN_STEPS = 8, 16  # (a): two replays of K against K eager steps
CHAIN_TIMED, CHAIN_EAGER = 5, 16  # (b): replays and eager steps timed
CHAIN_MODELS = {  # (arch, config, batch) of (a) and of (b)
    "a": (("leafcnn-base", "regularized", TRAIN_BATCH),
          ("resnet18", "fast", TRAIN_BATCH)),
    "b": (("leafcnn-base", "regularized", TRAIN_BATCH),
          ("resnet18", "regularized", 128))}
# (c)'s epochs; (d) runs phase 23's 3 and dies at epoch 2, step 4, so its
# last epoch is whole in the resumed run too
CHAIN_EPOCHS, CHAIN_KILL = 2, (1, 4)


def chain_setup(torch, arch: str, cfg_name: str, seed: int, data,
                stem: str = "conv", device: str = "cuda"):
    """A bf16 state of `arch` with `stem` (norm statistics from `data`),
    its step functions (REGULARIZED or FAST) and a seeded generator, on
    `device` (the card unless asked)."""
    from leaffliction_tpu_torch.models.leafcnn import build_leafcnn
    from leaffliction_tpu_torch.models.resnet import build_resnet
    from leaffliction_tpu_torch.ops.image import compute_norm_stats
    from leaffliction_tpu_torch.train.config import TrainConfig
    from leaffliction_tpu_torch.train.steps import (
        build_step_fns,
        create_train_state,
    )

    model = (build_leafcnn(CLASSES, "base", stem=stem, dtype=torch.bfloat16)
             if arch == "leafcnn-base"
             else build_resnet(CLASSES, arch, stem=stem,
                               dtype=torch.bfloat16))
    state = create_train_state(model, seed, device)
    mean, var = compute_norm_stats(data)
    with torch.no_grad():
        state.model.norm_mean.copy_(mean)
        state.model.norm_var.copy_(var)
    cfg = getattr(TrainConfig, cfg_name)()
    return (state, build_step_fns(cfg, CLASSES, 1000),
            torch.Generator(device=device).manual_seed(seed))


def chunk_of(sels: np.ndarray, lo: int, k: int):
    """The host batch `StepGraphs.train` takes on the gather path: rows
    `sels[lo:lo + k]`, all kept."""
    from leaffliction_tpu_torch.data.loader import Batch

    sel = sels[lo:lo + k]
    return Batch(images=None, labels=None,
                 mask=np.ones(sel.shape, np.float32), indices=sel)


def busy_share(torch, fn, reps: int, k1_want: int, trace: Path) -> dict:
    """torch.profiler over `reps` calls of `fn` (then a synchronise) in the
    active step of a schedule whose warm-up step runs them too, traced and
    discarded (device tracing can start late, see `kernel_ms`), its Chrome
    trace written to `trace`: the kernels' summed durations there over the
    active step's host wall, and its kernel events, K1's among them. A
    profile whose K1 events are not `k1_want` is taken again, up to three
    times (each 2 × `reps` calls)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                time.sleep(0.05)
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
                prof.step()
        prof.export_chrome_trace(str(trace))
        kernels = [e for e in json.loads(trace.read_text())["traceEvents"]
                   if e.get("cat") == "kernel"]
        k1 = sum(any(f in e.get("name", "") for f in
                     KERNEL_NAMES["train_aug"]) for e in kernels)
        if k1 == k1_want:
            break
        log("profiler", kernel="train_aug", attempt=attempt,
            launches_recorded=k1, launches_counted=k1_want)
    busy_ms = sum(e["dur"] for e in kernels) / 1e3
    return {"busy": busy_ms / wall_ms if kernels else None,
            "kernel_events": len(kernels), "wall_ms": wall_ms,
            "k1_events": k1, "attempts": attempt}


def replay_ms(torch, graphs, sels: np.ndarray, lo: int, k: int, reps: int,
              data):
    """`reps` replays of the K-step graph of `graphs` on the rows
    `sels[lo:lo + reps * k]` of the device-resident `data` (images,
    labels), CUDA events around each → the ms a step of each replay
    (sorted) and the host's ms a step over them."""
    events, t0 = [], time.perf_counter()
    for i in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graphs.train(chunk_of(sels, lo + i * k, k), data)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / (reps * k)
    return sorted(s.elapsed_time(e) / k for s, e in events), host


def graph_warmups(epochs_steps, k: int) -> int:
    """The warm-up steps of a chained `fit` (`StepGraphs.warmup_steps`):
    one a train graph, and a graph for each chunk size dispatched (k, and 1
    for an epoch's remainder), given the steps each epoch ran; none when k
    is 1 (eager steps)."""
    if k <= 1:
        return 0
    sizes = set()
    for n in epochs_steps:
        sizes |= ({k} if n >= k else set()) | ({1} if n % k else set())
    return len(sizes)


def phase_chain(torch, tmp: Path, seed: int, rng):
    """27. Multi-step dispatch on the card (`train/graph.py`): (a) a K = 8
    graph against K eager steps from one state and generator, cuDNN
    deterministic; (b) ms a step chained and eager; (c) the train CLI at
    its defaults (chained) against `--steps-per-dispatch 1`; (d) a chained
    run killed after a chunk of epoch 2 and resumed → K1's launches on the
    phase's main paths (each part's counts reset before it and read after
    it), and (b)'s ms a step, chained and eager (sorted), by (arch,
    batch)."""
    import io
    from types import SimpleNamespace

    from leaffliction_tpu_torch.cli.train import main as train_main
    from leaffliction_tpu_torch.core import trace
    from leaffliction_tpu_torch.core.logging import setup_logging
    from leaffliction_tpu_torch.ops.kernels.rotate import train_aug
    from leaffliction_tpu_torch.train import checkpoint as ck
    from leaffliction_tpu_torch.train.graph import StepGraphs

    t_phase = time.perf_counter()
    n_data = 4 * TRAIN_BATCH
    data = torch.from_numpy(np.stack([leafish_image(rng, SIZE)
                                      for _ in range(n_data)])).cuda()
    labels = torch.from_numpy(rng.integers(0, CLASSES, n_data)).cuda()
    k1_total, part_s = 0, {}

    # (a) K = 8 graph against K eager steps
    for arch, cfg_name, batch in CHAIN_MODELS["a"]:
        sels = np.stack([rng.choice(n_data, batch, replace=False)
                         for _ in range(CHAIN_STEPS)]).astype(np.int64)
        with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                        benchmark=False):
            ref, fns, gen_e = chain_setup(torch, arch, cfg_name, seed, data)
            state, _, gen_g = chain_setup(torch, arch, cfg_name, seed, data)
            mask = torch.ones(batch, device="cuda")
            # --- the main path: counts from here to the end of (a) ---
            train_aug.launches = 0
            step_kernels_zeroed()
            for i in range(CHAIN_STEPS):
                fns.train_step_gather(ref, data, labels,
                                      torch.from_numpy(sels[i]).cuda(), mask,
                                      gen_e)
            eager_k1 = train_aug.launches
            eager_bn = dict(batch_norm_launches())
            eager_ex = dict(exit_launches())
            train_aug.launches = 0
            step_kernels_zeroed()
            trace.clear()  # graphs.capture_s below: this part's captures
            graphs = StepGraphs(fns, state, gen_g)
            try:
                for lo in range(0, CHAIN_STEPS, CHAIN_K):
                    graphs.train(chunk_of(sels, lo, CHAIN_K),
                                 (data, labels))
                torch.cuda.synchronize()
            finally:
                graphs.close()
            graph_k1 = train_aug.launches
            graph_bn = dict(batch_norm_launches())
            graph_ex = dict(exit_launches())
            # --- end of the main path ---
        k1_total += eager_k1 + graph_k1
        layers = bn_layers(ref.model)
        bn_held(f"27a {arch} eager", eager_bn, layers, CHAIN_STEPS)
        bn_held(f"27a {arch} graphs", graph_bn, layers,
                CHAIN_STEPS + graphs.warmup_steps)
        exit_held(f"27a {arch} eager", eager_ex, ref.model, CHAIN_STEPS)
        exit_held(f"27a {arch} graphs", graph_ex, ref.model,
                  CHAIN_STEPS + graphs.warmup_steps)
        if eager_k1 != CHAIN_STEPS \
                or graph_k1 != CHAIN_STEPS + graphs.warmup_steps:
            raise AssertionError(f"27a {arch}: K1 launched {eager_k1} times "
                                 f"eagerly and {graph_k1} times in the "
                                 f"replays of {CHAIN_STEPS} steps and "
                                 f"{graphs.warmup_steps} warm-up steps")
        same, n_tensors, worst = resumed_against(
            torch, SimpleNamespace(state=state,
                                   generator_state=gen_g.get_state()),
            SimpleNamespace(state=ref, generator_state=gen_e.get_state()))
        log("27a chain equivalence", model=arch, img=SIZE, batch=batch,
            dtype="bf16", config=cfg_name.upper(), k=CHAIN_K,
            steps=CHAIN_STEPS, cudnn_deterministic=True,
            state_tensors_bit_equal=f"{same}/{n_tensors}",
            worst_state_rel_l2=f"{worst:.3e}", tol_state_rel_l2=1e-3,
            step=state.step, generator_state_equal=True,
            k1_launches_eager=eager_k1, k1_launches_graphs=graph_k1,
            k1_warmup_steps=graphs.warmup_steps,
            bn_launches_eager=json.dumps(eager_bn),
            bn_launches_graphs=json.dumps(graph_bn),
            capture_s=f"{trace.counters()['graphs.capture_s']:.3f}")
        del ref, state, fns, graphs
    part_s["a"] = time.perf_counter() - t_phase

    # (b) ms a step: K = 8 replays against eager steps, in one run
    step_ms = {}
    for arch, cfg_name, batch in CHAIN_MODELS["b"]:
        state, fns, gen = chain_setup(torch, arch, cfg_name, seed, data)
        # the capture's chunk, the timed replays, 2 a profile (3 at most)
        steps_b = CHAIN_K * (CHAIN_TIMED + 7) + CHAIN_EAGER + 2
        sels = np.stack([rng.choice(n_data, batch, replace=False)
                         for _ in range(steps_b)]).astype(np.int64)
        mask = torch.ones(batch, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        trace.clear()  # graphs.capture_s below: this part's capture
        graphs = StepGraphs(fns, state, gen)
        lo = 0
        # --- the main path: counts from here to the end of (b) ---
        train_aug.launches = 0
        try:
            graphs.train(chunk_of(sels, lo, CHAIN_K), (data, labels))
            lo += CHAIN_K
            torch.cuda.synchronize()
            pool_gb = (torch.cuda.memory_reserved() - reserved0) / 1e9
            chain_ms, host_chain = replay_ms(torch, graphs, sels, lo,
                                             CHAIN_K, CHAIN_TIMED,
                                             (data, labels))
            lo += CHAIN_TIMED * CHAIN_K

            def replay():
                nonlocal lo
                graphs.train(chunk_of(sels, lo, CHAIN_K), (data, labels))
                lo += CHAIN_K

            chain_busy = busy_share(torch, replay, 1, CHAIN_K,
                                    tmp / f"chain_{arch}_trace.json")
        finally:
            graphs.close()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        events = []
        for i in range(CHAIN_EAGER + 2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns.train_step_gather(state, data, labels,
                                  torch.from_numpy(sels[lo]).cuda(), mask,
                                  gen)
            end.record()
            lo += 1
            if i >= 2:  # the first two warm the eager path again
                events.append((start, end))
        torch.cuda.synchronize()
        b_k1 = train_aug.launches
        # --- end of the main path ---
        k1_total += b_k1
        if b_k1 != lo + graphs.warmup_steps \
                or chain_busy["k1_events"] != CHAIN_K:
            raise AssertionError(
                f"27b {arch}: K1 launched {b_k1} times in {lo} steps and "
                f"{graphs.warmup_steps} warm-up steps; the profiled replay "
                f"of {CHAIN_K} steps holds {chain_busy['k1_events']} K1 "
                "kernel events")
        eager_ms = sorted(s.elapsed_time(e) for s, e in events)
        step_ms[(arch, batch)] = {"chained": chain_ms, "eager": eager_ms}
        log("27b chain timing", model=arch, img=SIZE, batch=batch,
            dtype="bf16", config=cfg_name.upper(), k=CHAIN_K,
            chained_ms_per_step_median=f"{np.median(chain_ms):.3f}",
            chained_ms_min=f"{chain_ms[0]:.3f}",
            chained_ms_max=f"{chain_ms[-1]:.3f}",
            chained_host_ms_per_step=f"{host_chain:.3f}",
            eager_ms_per_step_median=f"{np.median(eager_ms):.3f}",
            eager_ms_min=f"{eager_ms[0]:.3f}",
            eager_ms_max=f"{eager_ms[-1]:.3f}",
            capture_s=f"{trace.counters()['graphs.capture_s']:.3f}",
            graph_pool_gb=f"{pool_gb:.3f}", peak_gb=f"{peak_gb:.2f}",
            chained_busy_share=(None if chain_busy["busy"] is None
                                else f"{chain_busy['busy']:.3f}"),
            profiled_kernel_events=chain_busy["kernel_events"],
            profiled_k1_events=chain_busy["k1_events"],
            profiles=chain_busy["attempts"],
            k1_launches=b_k1, k1_warmup_steps=graphs.warmup_steps)
        del state, fns, graphs
    part_s["b"] = time.perf_counter() - t_phase - sum(part_s.values())

    manifest = tmp / "manifest_split.json"

    def flags(name, *extra, epochs=CHAIN_EPOCHS):
        return ["--manifest", str(manifest), "--epochs", str(epochs),
                "--img-size", str(SIZE), "--batch-size", str(TRAIN_BATCH),
                "--seed", str(seed), "--out-dir", str(tmp / name), *extra]

    # (c) the train CLI at its defaults against --steps-per-dispatch 1
    cli, bn_cli = {}, {}
    for name, extra in (("chained", ()), ("eager",
                                          ("--steps-per-dispatch", "1"))):
        out = io.StringIO()
        # --- the main path: counts from here to the end of the run ---
        train_aug.launches = 0
        step_kernels_zeroed()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                run = train_main(flags(f"chain_cli_{name}", *extra))
        finally:
            setup_logging()  # the log's handler back on this stdout
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = train_aug.launches
        bn = dict(batch_norm_launches())
        ex = dict(exit_launches())
        # --- end of the main path ---
        k1_total += launches
        fit = run["fit"]
        said = [ln for ln in out.getvalue().splitlines()
                if "Chaining" in ln]
        per_epoch = fit.steps_ran // CHAIN_EPOCHS
        k = min(CHAIN_K, per_epoch) if name == "chained" else 1
        warm = graph_warmups([per_epoch] * CHAIN_EPOCHS, k)
        if launches != fit.steps_ran + warm:
            raise AssertionError(f"27c {name}: K1 launched {launches} "
                                 f"times in {fit.steps_ran} steps and "
                                 f"{warm} warm-up steps")
        bn_cli[name] = bn_held(f"27c {name}", bn, bn_layers(fit.state.model),
                               fit.steps_ran + warm, None)
        exit_held(f"27c {name}", ex, fit.state.model, fit.steps_ran + warm,
                  None)
        if not np.isfinite(fit.history["loss"]).all():
            raise AssertionError(f"27c {name}: history {fit.history}")
        cli[name] = (wall, fit, said, launches)
    k = min(CHAIN_K, per_epoch)
    said = cli["chained"][2]
    if len(said) != 1 or f"Chaining {k} train steps per dispatch" \
            not in said[0] or cli["eager"][2]:
        raise AssertionError(f"27c: the chaining log lines {said} / "
                             f"{cli['eager'][2]}")
    log("27c train cli", epochs=CHAIN_EPOCHS, steps_per_epoch=per_epoch,
        chained_k=k,
        **{f"{n}_wall_s": f"{w:.2f}" for n, (w, _, _, _) in cli.items()},
        **{f"{n}_train_s": f"{f.train_time_s:.3f}"
           for n, (_, f, _, _) in cli.items()},
        **{f"{n}_ms_per_step": f"{f.train_time_s * 1e3 / f.steps_ran:.3f}"
           for n, (_, f, _, _) in cli.items()},
        **{f"{n}_val_accuracy": json.dumps(f.history["val_accuracy"])
           for n, (_, f, _, _) in cli.items()},
        **{f"{n}_k1_launches": n1 for n, (_, _, _, n1) in cli.items()},
        **{f"{n}_bn_launches": json.dumps(c) for n, c in bn_cli.items()})

    part_s["c"] = time.perf_counter() - t_phase - sum(part_s.values())

    # (d) a chained run killed after a chunk of epoch 2, resumed
    real_maybe, calls = ck.AsyncStepCheckpointer.maybe_save, []

    def killing_maybe(self, global_step, state, meta, *rest):
        saved = real_maybe(self, global_step, state, meta, *rest)
        calls.append((global_step, meta["epoch"], meta["step_in_epoch"]))
        if (meta["epoch"], meta["step_in_epoch"]) == CHAIN_KILL:
            raise RuntimeError("simulated kill")
        return saved

    chained = ("--steps-per-dispatch", "2", "--checkpoint-every-steps", "2")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    # --- the main path: counts from here to the end of the resume ---
    train_aug.launches = 0
    try:
        ref = train_main(flags("chain_a", "--steps-per-dispatch", "2",
                               "--profile-dir",
                               str(tmp / "chain_a" / "profile"),
                               epochs=RESUME_EPOCHS))
        torch.cuda.synchronize()
        ref_k1 = train_aug.launches
        ck.AsyncStepCheckpointer.maybe_save = killing_maybe
        try:
            train_main(flags("chain_b", *chained, epochs=RESUME_EPOCHS))
        except RuntimeError as exc:
            if str(exc) != "simulated kill":
                raise
        else:
            raise AssertionError("27d: the chained run was not killed")
        ck.AsyncStepCheckpointer.maybe_save = real_maybe
        ckpt = tmp / "chain_b" / "checkpoints"
        latest = ck.latest_resume_step(ckpt)
        meta = ck.read_step_meta(ckpt, latest) if latest else None
        res = train_main(flags("chain_b", *chained, "--resume",
                               epochs=RESUME_EPOCHS))
        torch.cuda.synchronize()
    finally:
        ck.AsyncStepCheckpointer.maybe_save = real_maybe
        torch.backends.cudnn.deterministic = deterministic
    launches = train_aug.launches
    # --- end of the main path ---
    k1_total += launches
    killed_at = calls[-1][0]
    # one callback a dispatch: chunks of 2, then the epoch's remainder
    ends = sorted({*range(2, per_epoch + 1, 2), per_epoch})
    want = [(0, e) for e in ends] + [(1, e) for e in ends
                                     if e <= CHAIN_KILL[1]]
    if meta is None or [c[1:] for c in calls] != want:
        raise AssertionError(f"27d: step callbacks {calls} (want {want}), "
                             f"latest checkpoint meta {meta}")
    same, n_tensors, worst = resumed_against(torch, res["fit"], ref["fit"])
    got_h = json.loads((tmp / "chain_b" / "history.json").read_text())
    ref_h = json.loads((tmp / "chain_a" / "history.json").read_text())
    loss_rel = abs(got_h["loss"][-1] - ref_h["loss"][-1]) / abs(
        ref_h["loss"][-1])
    if not (loss_rel <= 1e-4 and len(got_h["val_loss"])
            == len(ref_h["val_loss"]) == RESUME_EPOCHS):
        raise AssertionError(f"27d: resumed history {got_h} against "
                             f"{ref_h}")
    steps = ref["fit"].steps_ran + killed_at + res["fit"].steps_ran
    # warm-ups: the uninterrupted run's, the killed run's (its first epoch
    # and the chunks of the second before the kill) and the resumed run's
    resumed = [per_epoch - meta["step_in_epoch"]] + [per_epoch] * (
        RESUME_EPOCHS - 1 - meta["epoch"])
    warm = (graph_warmups([per_epoch] * RESUME_EPOCHS, 2)
            + graph_warmups([per_epoch, CHAIN_KILL[1]], 2)
            + graph_warmups(resumed, 2))
    n_kernels, n_k1, conv, _ = trace_kernels(
        tmp / "chain_a" / "profile" / "train_trace.json")
    if launches != steps + warm or ref_k1 != n_k1:
        raise AssertionError(f"27d: K1 launched {launches} times in {steps} "
                             f"steps and {warm} warm-up steps; the "
                             f"uninterrupted run {ref_k1} times against "
                             f"{n_k1} K1 kernel events in its trace")
    log("27d chained resume", k=2, every_steps=2, epochs=RESUME_EPOCHS,
        callbacks=json.dumps([c[1:] for c in calls]),
        killed_at_step=killed_at, resumed_from=json.dumps(
            [meta["epoch"], meta["step_in_epoch"]]),
        resumed_steps=res["fit"].steps_ran,
        state_tensors_bit_equal=f"{same}/{n_tensors}",
        worst_state_rel_l2=f"{worst:.3e}", tol_state_rel_l2=1e-3,
        last_epoch_loss_rel_err=f"{loss_rel:.3e}", tol_loss=1e-4,
        cudnn_deterministic=True, trace_kernel_events=n_kernels,
        trace_k1_events=n_k1, trace_conv_kernel_events=len(conv),
        uninterrupted_k1_launches=ref_k1, k1_launches=launches,
        k1_warmup_steps=warm)
    part_s["d"] = time.perf_counter() - t_phase - sum(part_s.values())
    log("27 chain phase", seconds=f"{time.perf_counter() - t_phase:.1f}",
        **{f"seconds_{k}": f"{v:.1f}" for k, v in part_s.items()},
        k1_launches=k1_total)
    return k1_total, step_ms

# phase 28: FLOPs a step and a forward, and MFU against the card's peak
FLOPS_TRAIN = (  # bench.py's six (arch, stem, batch), 224 px REGULARIZED
    ("leafcnn-base", "conv", TRAIN_BATCH),
    ("leafcnn-base", "s2d", TRAIN_BATCH),
    ("leafcnn-base", "conv", 128),
    ("resnet18", "conv", 128),
    ("resnet18", "s2d", 128),
    ("resnet18", "conv", TRAIN_BATCH))
# the configurations 27b does not time: a K = 5 graph, its first chunk
# (warm-up, capture, replay) untimed, then 2 replays timed (10 steps)
FLOPS_K, FLOPS_TIMED = 5, 2
FLOPS_BASIS = "conv+matmul fwd+bwd (torch.utils.flop_counter)"


def counted(fn, *args) -> float:
    """`compiled_flops` of one call, which must count something; a count
    of None calls `fn` again outside the counter to raise what it hid."""
    from leaffliction_tpu_torch.train.flops import compiled_flops

    flops = compiled_flops(fn, *args)
    if flops is None:
        fn(*args)
        raise AssertionError(f"28: {fn} counted no FLOPs")
    return flops


def mfu_of(flops: float, ms) -> dict:
    """MFU (%) at the median, min and max of the sorted ms `ms`, each in
    (0, 1] as a fraction."""
    from leaffliction_tpu_torch.train.flops import mfu

    out = {"mfu_pct_median": mfu(flops, float(np.median(ms)) / 1e3),
           "mfu_pct_min": mfu(flops, ms[-1] / 1e3),
           "mfu_pct_max": mfu(flops, ms[0] / 1e3)}
    if not all(m is not None and 0 < m <= 1 for m in out.values()):
        raise AssertionError(f"28: MFU {out} outside (0, 1]")
    return {k: f"{100 * m:.3f}" for k, m in out.items()}


def phase_flops(torch, seed: int, rng, step_ms, served) -> int:
    """28. FLOPs and MFU (`train/flops.py`): (a) the count of one eager
    train step on a fresh state for each of `bench.py`'s six
    configurations (`FLOPS_TRAIN`, bf16 REGULARIZED, 224 px), each equal
    to batch / 2 × the CPU's count of the same function at batch 2; (b)
    MFU of 27b's chained and eager ms a step (`step_ms`, by (arch,
    batch)) and of the other four chained, timed here; (c) the count of
    the served forward (`Predictor._infer` on 64 images) of each model in
    `served` ({arch: (artifact dir, forward ms on the card)}), equal to 32
    × the CPU's count at 2 images, and its MFU → K1's launches in (a)'s
    steps (held against its twin) and (b)'s graphs (each part's counts
    reset before it and read after it)."""
    from leaffliction_tpu_torch.ops.kernels.rotate import train_aug
    from leaffliction_tpu_torch.predict.predictor import (
        SERVING_BATCH,
        Predictor,
    )
    from leaffliction_tpu_torch.train.flops import device_peak_flops
    from leaffliction_tpu_torch.train.graph import StepGraphs

    t_phase = time.perf_counter()
    peak = device_peak_flops()
    if peak is None:
        raise AssertionError(f"28: no bf16 peak for "
                             f"{torch.cuda.get_device_name(0)!r}")
    n_data = max(batch for _, _, batch in FLOPS_TRAIN)
    data = torch.from_numpy(np.stack([leafish_image(rng, SIZE)
                                      for _ in range(n_data)])).cuda()
    labels = torch.from_numpy(rng.integers(0, CLASSES, n_data)).cuda()

    # (a) one eager step a configuration, each on a fresh state
    per_step = {}
    with k1_recorded() as k1_calls:
        # --- the main path: counts from here to the end of (a) ---
        train_aug.launches = 0
        for arch, stem, batch in FLOPS_TRAIN:
            state, fns, gen = chain_setup(torch, arch, "regularized", seed,
                                          data, stem)
            sel = torch.from_numpy(rng.choice(n_data, batch,
                                              replace=False)).cuda()
            per_step[(arch, stem, batch)] = counted(
                fns.train_step, state, data.index_select(0, sel),
                labels.index_select(0, sel),
                torch.ones(batch, device="cuda"), gen)
            del state, fns
        torch.cuda.synchronize()
        k1_a = train_aug.launches
        # --- end of the main path ---
    k1_err = k1_held(torch, k1_calls)
    if k1_a != len(FLOPS_TRAIN):
        raise AssertionError(f"28a: K1 launched {k1_a} times in "
                             f"{len(FLOPS_TRAIN)} steps")
    cpu = {}
    for (arch, stem, batch), flops in per_step.items():
        if (arch, stem) not in cpu:
            state, fns, gen = chain_setup(torch, arch, "regularized", seed,
                                          data[:2].cpu(), stem, "cpu")
            cpu[(arch, stem)] = counted(
                fns.train_step, state, data[:2].cpu(), labels[:2].cpu(),
                torch.ones(2), gen)
        if flops != batch // 2 * cpu[(arch, stem)]:
            raise AssertionError(f"28a {arch} {stem} b{batch}: the card "
                                 f"counted {flops}, the CPU "
                                 f"{cpu[(arch, stem)]} at batch 2")
        log("28a train flops", model=arch, stem=stem, img=SIZE, batch=batch,
            dtype="bf16", config="REGULARIZED",
            gflops_per_step=f"{flops / 1e9:.4f}",
            gflops_per_image=f"{flops / batch / 1e9:.4f}",
            cpu_gflops_per_step_b2=f"{cpu[(arch, stem)] / 1e9:.4f}",
            card_equals_cpu_by_batch=True, basis=json.dumps(FLOPS_BASIS))
    torch.cuda.empty_cache()

    # (b) MFU: 27b's steps, then chained steps of the other four
    ran = warm = 0
    # --- the main path: counts from here to the end of (b) ---
    train_aug.launches = 0
    for arch, stem, batch in FLOPS_TRAIN:
        flops = per_step[(arch, stem, batch)]
        timed, source = step_ms.get((arch, batch) if stem == "conv"
                                    else None), "27b"
        if timed is None:
            source = "28b"
            state, fns, gen = chain_setup(torch, arch, "regularized", seed,
                                          data, stem)
            sels = np.stack([rng.choice(n_data, batch, replace=False)
                             for _ in range(FLOPS_K * (1 + FLOPS_TIMED))]
                            ).astype(np.int64)
            graphs = StepGraphs(fns, state, gen)
            try:
                graphs.train(chunk_of(sels, 0, FLOPS_K), (data, labels))
                timed = {"chained": replay_ms(
                    torch, graphs, sels, FLOPS_K, FLOPS_K, FLOPS_TIMED,
                    (data, labels))[0]}
            finally:
                graphs.close()
            ran += len(sels)
            warm += graphs.warmup_steps
            del state, fns, graphs
        for mode, ms in timed.items():
            log("28b train mfu", model=arch, stem=stem, img=SIZE,
                batch=batch, dtype="bf16", config="REGULARIZED", mode=mode,
                timed_in=source,
                ms_per_step_median=f"{np.median(ms):.3f}",
                ms_min=f"{ms[0]:.3f}", ms_max=f"{ms[-1]:.3f}",
                gflops_per_step=f"{flops / 1e9:.4f}",
                peak_tflops=f"{peak / 1e12:.1f}", **mfu_of(flops, ms))
    torch.cuda.synchronize()
    k1_b = train_aug.launches
    # --- end of the main path ---
    if k1_b != ran + warm:
        raise AssertionError(f"28b: K1 launched {k1_b} times in {ran} "
                             f"steps and {warm} warm-up steps")

    # (c) the served forward of each model
    images = rng.integers(0, 256, (SERVING_BATCH, SIZE, SIZE, 3),
                          dtype=np.uint8)
    for arch, (learn, ms) in served.items():
        card = Predictor(learn, device=torch.device("cuda")).load()
        host = Predictor(learn, device=torch.device("cpu")).load()
        flops = counted(card._infer, images)
        flops_cpu = counted(host._infer, images[:2])
        if flops != SERVING_BATCH // 2 * flops_cpu:
            raise AssertionError(f"28c {arch}: the card counted {flops}, "
                                 f"the CPU {flops_cpu} at 2 images")
        log("28c serving flops", model=arch, img=SIZE, dtype="bf16",
            images=SERVING_BATCH,
            gflops_per_64_batch_forward=f"{flops / 1e9:.4f}",
            gflops_per_image=f"{flops / SERVING_BATCH / 1e9:.4f}",
            cpu_gflops_per_2_images=f"{flops_cpu / 1e9:.4f}",
            card_equals_cpu_by_batch=True,
            ms_per_64_batch_forward_on_device=f"{ms:.3f}",
            mfu_pct=mfu_of(flops, [ms])["mfu_pct_median"],
            peak_tflops=f"{peak / 1e12:.1f}",
            basis=json.dumps("conv+matmul fwd (torch.utils.flop_counter)"))
    log("28 flops phase", seconds=f"{time.perf_counter() - t_phase:.1f}",
        k1_launches=k1_a + k1_b,
        k1_max_err_bf16=f"{k1_err['bf16']:.3e}",
        k1_max_err_f32=f"{k1_err['f32']:.3e}")
    return k1_a + k1_b


# phase 29: the streamed train path (`trainer.prefetch_to_device`) against
# the gather path, leafcnn-base 224 b32 bf16 REGULARIZED: 16 steps for the
# bit-equality, then timed K = 8 replays (the first of each graph untimed)
# and eager steps, and the profiled replays of the busy share (2 an
# attempt, 3 attempts at most)
STREAM_K, STREAM_STEPS = 8, 16
STREAM_REPLAYS, STREAM_EAGER = 4, 10  # (eager: 2 blocks a path)


def host_train_store(rng, n: int):
    """A `DeviceImageStore` holding `n` leaf-like 224² images on the host
    too (the streamed path reads them there, the gather path on the card),
    with labels drawn from `rng`."""
    from leaffliction_tpu_torch.data.loader import DeviceImageStore

    store = DeviceImageStore(rng.integers(0, CLASSES, n), SIZE)
    store.images = np.stack([leafish_image(rng, SIZE) for _ in range(n)])
    store.host_pixels = True
    return store


def host_batches(it, n: int):
    """The first `n` batches of the iterator's epochs 0, 1, ... (each epoch
    shuffled anew), made one at a time as `fit` makes them."""
    import itertools

    return itertools.islice(itertools.chain.from_iterable(
        it.epoch(e) for e in itertools.count()), n)


def h2d_ms(torch, nbytes: int, pinned: bool, reps: int = 10) -> float:
    """Median ms of one host-to-device copy of `nbytes` from pinned or
    pageable memory (CUDA events)."""
    src = torch.full((nbytes,), 7, dtype=torch.uint8, pin_memory=pinned)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dst.copy_(src, non_blocking=pinned)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src, non_blocking=pinned)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def dispatch_ms(torch, dispatches, k: int) -> list:
    """Run each dispatch of `dispatches` (callables of k steps), a CUDA
    event after each → the ms a step of every interval between two
    consecutive events, sorted: the card's time a dispatch, its waits for
    the uploads and for the host included."""
    ends = []
    for fn in dispatches:
        fn()
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) / k for a, b in zip(ends, ends[1:]))


def fmt_ms(prefix: str, ms: list) -> dict:
    return {f"{prefix}_ms_per_step_median": f"{np.median(ms):.3f}",
            f"{prefix}_ms_min": f"{ms[0]:.3f}",
            f"{prefix}_ms_max": f"{ms[-1]:.3f}"}


def phase_keras(torch, tmp: Path, learn: Path, images) -> None:
    """29a. Whether keras is importable here. Without it, phase 11's train
    CLI wrote neither `leaf_cnn.keras` nor `keras_file` and logged no
    warning about it; with it, phase 11's model exported to `.keras` and
    served through the port's loader at phase 6's gates."""
    from leaffliction_tpu_torch.predict.model_loader import ModelLoader
    from leaffliction_tpu_torch.predict.predictor import Predictor
    from leaffliction_tpu_torch.train.keras_export import (
        export_keras,
        keras_available,
    )

    trained = tmp / "trained"
    meta = json.loads((trained / "meta.json").read_text())
    if not keras_available():
        said = [ln for ln in (tmp / "trained_cli.log").read_text()
                .splitlines() if "WARNING" in ln and "keras" in ln.lower()]
        if (trained / "leaf_cnn.keras").exists() or "keras_file" in meta \
                or said:
            raise AssertionError(f"29a: keras is not importable, yet the "
                                 f"train CLI wrote a .keras artifact or "
                                 f"warned: {said}")
        log("29a keras", keras_importable=False, keras_file=False,
            keras_warnings=0)
        return
    loader = ModelLoader(trained, device="cpu").load()
    kdir = tmp / "trained_keras"
    kdir.mkdir()
    export_keras(loader.model, loader.model.state_dict(), SIZE,
                 kdir / "leaf_cnn.keras")
    (kdir / "meta.json").write_text(json.dumps(
        {**meta, "model_file": str(kdir / "leaf_cnn.keras")}))
    probs = Predictor(kdir, device=torch.device("cuda")).load(
        )._probs_for_arrays(images)
    served = Predictor(trained, device=torch.device("cuda")).load(
        )._probs_for_arrays(images)
    row_err = float(np.abs(probs.sum(-1) - 1.0).max())
    err = float(np.abs(probs - served).max())
    if not (np.isfinite(probs).all() and row_err <= 1e-3 and err <= 2e-2):
        raise AssertionError(f"29a: the .keras model served off: rows "
                             f"{row_err}, against the msgpack {err}")
    log("29a keras", keras_importable=True, images=len(images),
        row_sum_err=f"{row_err:.2e}", max_dprob_vs_msgpack=err)


def phase_streamed(torch, tmp: Path, seed: int, rng, cli11_s: float):
    """29. The streamed train path: (a) `phase_keras`; (b) leafcnn-base 224
    b32 bf16 REGULARIZED in one process, the batches uploaded by
    `prefetch_to_device` against the gather path from a device-resident
    copy of the same images, cuDNN deterministic: 16 steps eagerly and as
    two K = 8 replays on either path, every state bit-equal to the eager
    gather steps', every eager K1 call held against its twin (the chained
    steps' K1 is inside the replays, held through the bit-equal state);
    then ms a step of either path in one run, eager in turns (gather,
    streamed, streamed, gather) and chained; the pinned (and pageable)
    host-to-device rate of a batch and of a chunk; the replays' busy share
    on either path; (c) the train CLI with
    `--no-device-dataset` on phase 11's manifest, 2 epochs, in process →
    K1's launches on the phase's main paths, each part's counts reset
    before it and read after it."""
    import io
    from types import SimpleNamespace

    from leaffliction_tpu_torch.cli.train import main as train_main
    from leaffliction_tpu_torch.core.logging import setup_logging
    from leaffliction_tpu_torch.data.loader import BatchIterator
    from leaffliction_tpu_torch.ops.kernels.rotate import train_aug
    from leaffliction_tpu_torch.train.graph import StepGraphs
    from leaffliction_tpu_torch.train.trainer import (
        chain_batches,
        prefetch_to_device,
    )

    t_phase = time.perf_counter()
    device = torch.device("cuda")
    store = host_train_store(rng, 4 * TRAIN_BATCH)
    data = torch.from_numpy(store.images).cuda()
    labels = torch.from_numpy(store.labels.astype(np.int64)).cuda()
    it = BatchIterator(store, TRAIN_BATCH, shuffle=True, seed=seed)
    phase_keras(torch, tmp, tmp / "trained", store.images[:BATCH])

    def setup():
        return chain_setup(torch, "leafcnn-base", "regularized", seed, data)

    def gather_step(state, fns, gen, b):
        fns.train_step_gather(state, data, labels,
                              torch.from_numpy(b.indices.astype(np.int64))
                              .to(device, non_blocking=True),
                              torch.from_numpy(b.mask).to(
                                  device, non_blocking=True), gen)

    def gather_chunk(b):
        return chunk_of(np.asarray(b.indices, np.int64), 0, STREAM_K)

    # (b) bit-equality: eager and chained, streamed and gather
    k1_total, part_s = 0, {}
    with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                    benchmark=False):
        runs = {}
        # --- the main path: counts from here to the end of the 4 runs ---
        train_aug.launches = 0
        with k1_recorded() as kept:
            ref, fns, gen = setup()
            for b in host_batches(it, STREAM_STEPS):
                gather_step(ref, fns, gen, b)
            runs["eager_gather"] = (ref, gen)
            state, _, gen = setup()
            for b in prefetch_to_device(host_batches(it, STREAM_STEPS),
                                        device):
                fns.train_step_chain(state, b.images[None], b.labels[None],
                                     b.mask[None], gen)
            runs["eager_streamed"] = (state, gen)
        eager_k1 = train_aug.launches
        warmups = 0
        for path in ("gather", "streamed"):
            state, _, gen = setup()
            graphs = StepGraphs(fns, state, gen)
            chunks = chain_batches(host_batches(it, STREAM_STEPS), STREAM_K)
            try:
                if path == "gather":
                    for b in chunks:
                        graphs.train(gather_chunk(b), (data, labels))
                else:
                    for b in prefetch_to_device(chunks, device):
                        graphs.train(b, None)
                torch.cuda.synchronize()
            finally:
                graphs.close()
            warmups += graphs.warmup_steps
            runs[f"chained_{path}"] = (state, gen)
        launches = train_aug.launches
        # --- end of the main path ---
    k1_total += launches
    if eager_k1 != 2 * STREAM_STEPS \
            or launches != 4 * STREAM_STEPS + warmups:
        raise AssertionError(f"29b: K1 launched {eager_k1} times in "
                             f"{2 * STREAM_STEPS} eager steps, {launches} "
                             f"in all ({4 * STREAM_STEPS} steps and "
                             f"{warmups} warm-up steps)")
    held = k1_held(torch, kept)
    ref = SimpleNamespace(state=runs["eager_gather"][0],
                          generator_state=runs["eager_gather"][1].get_state())
    equal = {}
    for name, (state, gen) in runs.items():
        same, n_tensors, worst = resumed_against(
            torch, SimpleNamespace(state=state,
                                   generator_state=gen.get_state()), ref)
        if same != n_tensors:
            raise AssertionError(f"29b {name}: {same}/{n_tensors} state "
                                 f"tensors bit-equal to the eager gather "
                                 f"steps (worst rel L2 {worst:.3e})")
        equal[name] = f"{same}/{n_tensors}"
    log("29b streamed equivalence", model="leafcnn-base", img=SIZE,
        batch=TRAIN_BATCH, dtype="bf16", config="REGULARIZED", k=STREAM_K,
        steps=STREAM_STEPS, cudnn_deterministic=True,
        state_tensors_bit_equal=json.dumps(equal),
        k1_calls_held=len(kept), k1_max_err_bf16=held["bf16"],
        k1_max_err_f32=held["f32"], k1_launches=launches,
        k1_warmup_steps=warmups)
    del kept, runs, ref
    part_s["b_equal"] = time.perf_counter() - t_phase

    # (b) timing: the two paths in one run, eager (in turns: the host's
    # noise is the eager step's) then chained
    batch_bytes = store.images[:TRAIN_BATCH].nbytes + 12 * TRAIN_BATCH
    rates = {"batch_pinned": h2d_ms(torch, batch_bytes, True),
             "chunk_pinned": h2d_ms(torch, STREAM_K * batch_bytes, True),
             "chunk_pageable": h2d_ms(torch, STREAM_K * batch_bytes, False)}
    timing = {"eager_gather": [], "eager_streamed": []}
    busy = {}
    # --- the main path: counts from here to the end of the timing ---
    train_aug.launches = 0
    warmups = steps = 0
    for path in ("gather", "streamed", "streamed", "gather"):
        state, fns, gen = setup()
        batches = host_batches(it, 2 + STREAM_EAGER)
        if path == "gather":
            def step():
                gather_step(state, fns, gen, next(batches))
        else:
            batches = prefetch_to_device(batches, device)

            def step():
                b = next(batches)
                fns.train_step_chain(state, b.images[None], b.labels[None],
                                     b.mask[None], gen)
        step()  # warms the eager path
        timing[f"eager_{path}"] = sorted(timing[f"eager_{path}"] + dispatch_ms(
            torch, [step] * (1 + STREAM_EAGER), 1))
        steps += 2 + STREAM_EAGER
    for path in ("gather", "streamed"):
        state, fns, gen = setup()
        graphs = StepGraphs(fns, state, gen)
        n = STREAM_K * (1 + STREAM_REPLAYS + 6)
        chunks = chain_batches(host_batches(it, n), STREAM_K)
        chunks = (map(gather_chunk, chunks) if path == "gather"
                  else prefetch_to_device(chunks, device))
        dd = (data, labels) if path == "gather" else None

        def replay():
            graphs.train(next(chunks), dd)

        try:
            timing[f"chained_{path}"] = dispatch_ms(
                torch, [replay] * (1 + STREAM_REPLAYS), STREAM_K)
            busy[path] = busy_share(torch, replay, 1, STREAM_K,
                                    tmp / f"streamed_{path}_trace.json")
            torch.cuda.synchronize()
        finally:
            graphs.close()
        warmups += graphs.warmup_steps
        steps += STREAM_K * (1 + STREAM_REPLAYS + 2 * busy[path]["attempts"])
    launches = train_aug.launches
    # --- end of the main path ---
    k1_total += launches
    if launches != steps + warmups or any(
            b["k1_events"] != STREAM_K for b in busy.values()):
        raise AssertionError(f"29b timing: K1 launched {launches} times in "
                             f"{steps} steps and {warmups} warm-up steps; "
                             f"K1 events in the profiled replays "
                             f"{[b['k1_events'] for b in busy.values()]}")
    sizes = {"batch_pinned": batch_bytes, "chunk_pinned":
             STREAM_K * batch_bytes, "chunk_pageable": STREAM_K * batch_bytes}
    med = {name: float(np.median(ms)) for name, ms in timing.items()}
    log("29b streamed timing", model="leafcnn-base", img=SIZE,
        batch=TRAIN_BATCH, dtype="bf16", config="REGULARIZED", k=STREAM_K,
        bytes_per_step=batch_bytes,
        **{f"h2d_gbps_{name}": f"{sizes[name] / ms / 1e6:.2f}"
           for name, ms in rates.items()},
        pinned_h2d_ms_per_step=f"{rates['chunk_pinned'] / STREAM_K:.4f}",
        **{k: v for name, ms in timing.items()
           for k, v in fmt_ms(name, ms).items()},
        **{f"chained_busy_share_{path}": (None if b["busy"] is None
                                          else f"{b['busy']:.3f}")
           for path, b in busy.items()},
        **{f"streamed_over_gather_{mode}":
           f"{med[mode + '_streamed'] / med[mode + '_gather']:.4f}"
           for mode in ("chained", "eager")},
        streamed_over_gather_eager_min=(
            f"{timing['eager_streamed'][0] / timing['eager_gather'][0]:.4f}"),
        k1_launches=launches, k1_warmup_steps=warmups)
    part_s["b_timing"] = time.perf_counter() - t_phase - sum(part_s.values())

    # (c) the train CLI on the streamed path
    out = io.StringIO()
    # --- the main path: counts from here to the end of the run ---
    train_aug.launches = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            run = train_main([
                "--manifest", str(tmp / "manifest_split.json"), "--epochs",
                "2", "--img-size", str(SIZE), "--batch-size",
                str(TRAIN_BATCH), "--seed", str(seed), "--no-device-dataset",
                "--out-dir", str(tmp / "streamed_cli")])
    finally:
        setup_logging()  # the log's handler back on this stdout
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = train_aug.launches
    # --- end of the main path ---
    k1_total += launches
    fit = run["fit"]
    per_epoch = fit.steps_ran // 2
    warm = graph_warmups([per_epoch] * 2, min(STREAM_K, per_epoch))
    text = out.getvalue()
    if launches != fit.steps_ran + warm \
            or "Device-resident dataset enabled" in text \
            or not np.isfinite(fit.history["loss"]).all() \
            or not (tmp / "streamed_cli" / "leaf_cnn.msgpack").exists():
        raise AssertionError(f"29c: K1 launched {launches} times in "
                             f"{fit.steps_ran} steps and {warm} warm-up "
                             f"steps; history {fit.history}")
    log("29c streamed train cli", epochs=2, steps_per_epoch=per_epoch,
        chained_k=min(STREAM_K, per_epoch), wall_s=f"{wall:.2f}",
        train_s=f"{fit.train_time_s:.3f}",
        ms_per_step=f"{fit.train_time_s * 1e3 / fit.steps_ran:.3f}",
        phase11_subprocess_wall_s=f"{cli11_s:.2f}",
        val_accuracy=json.dumps(fit.history["val_accuracy"]),
        k1_launches=launches, k1_warmup_steps=warm)
    part_s["c"] = time.perf_counter() - t_phase - sum(part_s.values())
    log("29 streamed phase", seconds=f"{time.perf_counter() - t_phase:.1f}",
        **{f"seconds_{k}": f"{v:.1f}" for k, v in part_s.items()},
        k1_launches=k1_total)
    return k1_total


# phase 30: the BatchNorm (+ReLU) kernels at the train cells' shapes
# every BatchNorm shape of leafcnn-base b32, then of resnet18 b128
BN_CELL_SHAPES = ((32, 32, 224, 224), (32, 64, 112, 112), (32, 128, 56, 56),
                  (32, 256, 28, 28), (128, 64, 112, 112), (128, 64, 56, 56),
                  (128, 128, 28, 28), (128, 256, 14, 14), (128, 512, 7, 7))
BN_SHAPES = ((32, 32, 224, 224), (128, 64, 112, 112))  # the timed ones
BN_EPS, BN_MOMENTUM = 1e-5, 0.9


def bn_inputs(torch, shape, seed: int):
    """x (≈ N(0.5, 2²)) and dy (N(0, 1)) in bf16 channels-last; f32 scale,
    bias, running mean and var [C] (`tests/test_torch_gpu.py`'s draws)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(scale, shift):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                + shift).to(torch.bfloat16).contiguous(
                    memory_format=torch.channels_last)

    x, dy = draw(2.0, 0.5), draw(1.0, 0.0)
    params = [torch.rand(shape[1], generator=g, device="cuda") * a + b
              for a, b in ((0.5, 0.75), (0.4, -0.2), (0.2, -0.1),
                           (1.0, 0.5))]
    return x, dy, params


def bn_held_to_twin(torch, shape, relu: bool, seed: int) -> dict:
    """The module on the card's kernels (training forward with the running
    update, backward) against the plain twin on the card, on the same bf16
    channels-last inputs, at `tests/test_torch_gpu.py`'s tolerances: the
    running mean and var within 1e-5 relative; y within one bf16 step
    (2^-7 relative); dβ and dγ within 1e-5 of the sum of their terms'
    magnitudes (+1e-6); dx within 2^-7 relative + 1e-4 where both ReLU
    masks agree, and they differ on at most 1e-5 of the elements. Raises
    on a mismatch → the worst of each, as a share of its tolerance."""
    from leaffliction_tpu_torch.ops.fused_bn import BatchNorm, bn_train_plain

    x, dy, (scale, bias, rm, rv) = bn_inputs(torch, shape, seed)
    bn = BatchNorm(shape[1], BN_EPS, torch.bfloat16, BN_MOMENTUM).cuda()
    with torch.no_grad():
        for t, v in ((bn.scale, scale), (bn.bias, bias), (bn.mean, rm),
                     (bn.var, rv)):
            t.copy_(v)
    xk = x.clone().requires_grad_()
    yk = bn(xk, train=True, relu=relu)
    yk.backward(dy)
    xt = x.clone().requires_grad_()
    st, bt = scale.clone().requires_grad_(), bias.clone().requires_grad_()
    yt, mean, var = bn_train_plain(xt, st, bt, BN_EPS, relu=relu)
    yt.backward(dy)
    m = BN_MOMENTUM

    def share(got, want, rtol, atol):
        got, want = got.float(), want.float()
        return ((got - want).abs() / (atol + rtol * want.abs())).max().item()

    worst = {"mean": share(bn.mean, m * rm + (1 - m) * mean, 1e-5, 1e-6),
             "var": share(bn.var, m * rv + (1 - m) * var, 1e-5, 1e-6),
             "y": share(yk, yt, 2.0 ** -7, 1e-5)}
    dims = (0, 2, 3)
    kept = yt > 0 if relu else torch.ones_like(x, dtype=torch.bool)
    dyk = torch.where(kept, dy.float(), 0.0)
    xhat = ((x.float() - mean.view(1, -1, 1, 1))
            * torch.rsqrt(var + BN_EPS).view(1, -1, 1, 1))
    for name, got, want, terms in (("db", bn.bias.grad, bt.grad, dyk),
                                   ("dg", bn.scale.grad, st.grad,
                                    dyk * xhat)):
        bound_ = 1e-5 * terms.abs().sum(dim=dims) + 1e-6
        worst[name] = ((got - want).abs() / bound_).max().item()
    agree = (yk > 0) == kept if relu else kept
    flipped = (~agree).sum().item()
    worst["dx"] = share(xk.grad[agree], xt.grad[agree], 2.0 ** -7, 1e-4)
    worst["mask"] = flipped / (1e-5 * x.numel())
    bad = {k: v for k, v in worst.items() if not v <= 1.0}
    if bad:
        raise AssertionError(f"30a {list(shape)} relu={relu}: the kernels "
                             f"left the twin's tolerance: {bad} (shares of "
                             "the tolerance)")
    return worst


def bn_twin_passes(torch, x, dy, scale, bias, mean, var):
    """The twin's four passes in plain PyTorch (`ops/fused_bn._BNTrain`
    with `torch.relu` after it), as callables."""
    from leaffliction_tpu_torch.ops.fused_bn import bn_eval_plain

    dims, c4 = (0, 2, 3), (lambda v: v.view(1, -1, 1, 1))
    m = float(x.numel() // x.shape[1])
    y = bn_eval_plain(x, mean, var, scale, bias, BN_EPS, x.dtype, True)
    inv = torch.rsqrt(var + BN_EPS)

    def stats():
        xf = x.float()
        s1, s2 = xf.sum(dim=dims), (xf * xf).sum(dim=dims)
        mu = s1 / m
        return mu, torch.clamp_min(s2 / m - mu * mu, 0.0)

    def grad_reduce():
        dyf = torch.ops.aten.threshold_backward(dy, y, 0).float()
        xhat = (x.float() - c4(mean)) * c4(inv)
        return dyf.sum(dim=dims), (dyf * xhat).sum(dim=dims)

    db, dg = grad_reduce()

    def dx():
        dyf = torch.ops.aten.threshold_backward(dy, y, 0).float()
        xhat = (x.float() - c4(mean)) * c4(inv)
        return (c4(scale * inv) * (dyf - c4(db / m) - xhat * c4(dg / m))
                ).to(x.dtype)

    return {"bn_stats": stats,
            "bn_apply": lambda: bn_eval_plain(x, mean, var, scale, bias,
                                              BN_EPS, x.dtype, True),
            "bn_grad_reduce": grad_reduce, "bn_dx": dx}


def phase_batch_norm(torch, seed: int) -> list:
    """30. The BatchNorm kernels: (a) held against the twin at every
    BatchNorm shape of the train cells; (b) times against bounds and twin
    at BN_SHAPES (module docstring) → the JSON rows of (b), one per kernel
    and shape."""
    from leaffliction_tpu_torch.ops import fused_bn
    from leaffliction_tpu_torch.ops.kernels import batch_norm as bnk

    for shape in BN_CELL_SHAPES:
        for relu in (True, False):
            worst = bn_held_to_twin(torch, shape, relu, seed)
            log("30a batch norm vs twin", shape=json.dumps(list(shape)),
                dtype="bf16", layout="channels-last", relu=relu,
                **{f"{k}_of_tol": f"{v:.3f}" for k, v in worst.items()})
        torch.cuda.empty_cache()
    rows = []
    for shape in BN_SHAPES:
        n, c, h, w = shape
        x, dy, (scale, bias, _, _) = bn_inputs(torch, shape, seed)
        mean, var = bnk.moments(x)
        sums = bnk.grad_sums(x, dy, mean, var, scale, bias, BN_EPS, True)
        count = float(n * h * w)
        calls = {
            "bn_stats": lambda: bnk.moments(x),
            "bn_apply": lambda: bnk.normalize(x, mean, var, scale, bias,
                                              BN_EPS, True),
            "bn_grad_reduce": lambda: bnk.grad_sums(x, dy, mean, var, scale,
                                                    bias, BN_EPS, True),
            "bn_dx": lambda: bnk.grad_input(x, dy, mean, var, scale, bias,
                                            sums, BN_EPS, count, True)}
        twins = bn_twin_passes(torch, x, dy, scale, bias, mean, var)
        # bytes each pass must move: x (and dy) read once, y or dx written
        nbytes = {"bn_stats": 1, "bn_apply": 2, "bn_grad_reduce": 2,
                  "bn_dx": 3}
        for name, fn in calls.items():
            t = timed(torch, name, fn, twins[name], 20, 5)
            bound_ms, by = bound(nbytes[name] * 2 * x.numel(), 0)
            row = {"name": name, "shape": list(shape), "ms": t["ms"],
                   "launches": t["launches"], "call_ms": t["call_ms"],
                   "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
                   "bound_by": by, "roofline_pct": 100 * bound_ms / t["ms"]}
            if name in ("bn_stats", "bn_grad_reduce"):
                row["finalize_ms"] = kernel_ms(torch, fn, "bn_finalize",
                                               20)[0]
            rows.append(row)
            log("30b batch norm", kernel=name, shape=json.dumps(shape),
                dtype="bf16", layout="channels-last", relu=True,
                **{k: (f"{v:.5f}" if isinstance(v, float) else v)
                   for k, v in row.items() if k not in ("name", "shape")})
        xk = x.clone().requires_grad_()
        xt = x.clone().requires_grad_()
        sk, bk = scale.clone().requires_grad_(), bias.clone().requires_grad_()
        st, bt = scale.clone().requires_grad_(), bias.clone().requires_grad_()
        fwd = {"kernels": lambda: fused_bn.bn_train(xk, sk, bk, BN_EPS,
                                                    relu=True)[0],
               "twin": lambda: fused_bn.bn_train_plain(xt, st, bt, BN_EPS,
                                                       relu=True)[0]}
        whole = {}
        for side, f in fwd.items():
            y = f()
            whole[f"{side}_forward_ms"] = cuda_ms(torch, f, 10)
            whole[f"{side}_backward_ms"] = cuda_ms(
                torch, lambda: torch.autograd.grad(
                    y, (xk, sk, bk) if side == "kernels" else (xt, st, bt),
                    dy, retain_graph=True), 10)
        log("30b batch norm whole", shape=json.dumps(shape),
            forward_bound_ms=f"{bound(4 * x.numel(), 0)[0]:.5f}",
            backward_bound_ms=f"{bound(6 * x.numel(), 0)[0]:.5f}",
            **{k: f"{v:.5f}" for k, v in whole.items()})
        torch.cuda.empty_cache()
    return rows


# phase 31: the residual blocks' exit at the train cells' exit shapes
# every exit of leafcnn-base b32, then of resnet18 b128 (its stem pool first)
EXIT_CELL_SHAPES = (((32, 32, 224, 224), "leaf"), ((32, 64, 112, 112), "leaf"),
                    ((32, 128, 56, 56), "leaf"), ((32, 256, 28, 28), "leaf"),
                    ((128, 64, 112, 112), "stem"),
                    ((128, 64, 56, 56), "block"),
                    ((128, 128, 28, 28), "block"),
                    ((128, 256, 14, 14), "block"), ((128, 512, 7, 7), "block"))
EXIT_SHAPES = (((32, 32, 224, 224), "leaf"), ((128, 64, 112, 112), "stem"),
               ((128, 64, 56, 56), "block"))  # the timed ones


def exit_inputs(torch, shape, kind: str, seed: int):
    """y and the shortcut (N(0, 1), bf16 channels-last), se (a sigmoid,
    bf16 [N, C, 1, 1]), the dropout (kept with probability 0.85, keep
    0.85), relu and the pool of an exit `kind` (`tests/test_torch_gpu.py`'s
    draws): "leaf" has all five, "block" no dropout or pool, "stem" the
    SAME 3x3/2 pool alone."""
    from leaffliction_tpu_torch.ops.block_exit import Drop, Pool

    has_se, has_sc, relu, has_drop, pool = {
        "leaf": (True, True, True, True, Pool(2, 2)),
        "block": (True, True, True, False, None),
        "stem": (False, False, False, False, Pool(3, 2, same=True))}[kind]
    g = torch.Generator(device="cuda").manual_seed(seed)
    n, c = shape[:2]

    def act():
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)

    y, sc = act(), act() if has_sc else None
    se = torch.sigmoid(torch.randn((n, c, 1, 1), generator=g, device="cuda")
                       ).to(torch.bfloat16) if has_se else None
    drop = Drop(torch.rand((n, c, 1, 1), generator=g, device="cuda") < 0.85,
                0.85) if has_drop else None
    return y, se, sc, relu, drop, pool


def exit_held_to_twin(torch, shape, kind: str, seed: int) -> dict:
    """The exit's kernels (forward with the picks, backward) against the
    plain twin on the card, on the same inputs and output gradient, at the
    `gpu` tests' tolerances: the output and the pool's picks bit-equal; dy
    and d_shortcut within one bf16 step (2^-7 relative); the SE gate's
    gradient within 2^-8 of its terms' magnitudes and of itself. Raises on
    a mismatch → the worst of each as a share of its tolerance, and the
    share of dy and d_shortcut elements bit-equal to the twin's."""
    from leaffliction_tpu_torch.ops.layout import same_pads
    from leaffliction_tpu_torch.ops import block_exit as exits
    from leaffliction_tpu_torch.ops.kernels import block_exit as kexit

    y, se, sc, relu, drop, pool = exit_inputs(torch, shape, kind, seed)
    runs = []
    for fn in (exits.block_exit, exits.block_exit_plain):
        leaves = [None if t is None else t.clone().requires_grad_()
                  for t in (y, se, sc)]
        out = fn(*leaves, relu, drop, pool)
        g = torch.randn(out.shape, generator=torch.Generator(
            device="cuda").manual_seed(seed + 1), device="cuda").to(
                out.dtype).contiguous(memory_format=torch.channels_last)
        named = [(n, t) for n, t in zip(("dy", "dse", "dsc"), leaves)
                 if t is not None]
        grads = torch.autograd.grad(out, [t for _, t in named], g)
        runs.append({"out": out.detach(),
                     **{n: d for (n, _), d in zip(named, grads)}})
    k, t = runs
    worst = {"out_differ": int((k["out"] != t["out"]).sum())}
    if pool is not None:
        geo = kexit.geometry(y, pool)
        _, code = kexit.forward(y, se, sc, relu, drop, pool, True)
        ky, kx = code.long() // geo.k, code.long() % geo.k
        oy = torch.arange(geo.oh, device="cuda").view(1, 1, -1, 1)
        ox = torch.arange(geo.ow, device="cuda").view(1, 1, 1, -1)
        picks = (oy * geo.s - geo.pad_h + ky) * geo.w \
            + (ox * geo.s - geo.pad_w + kx)
        pre = exits.block_exit_plain(y, se, sc, relu, drop)
        (top, bottom), (left, right) = (
            same_pads(geo.h, geo.k, geo.s), same_pads(geo.w, geo.k, geo.s)
        ) if pool.same else ((0, 0), (0, 0))
        padded = torch.nn.functional.pad(pre, (left, right, top, bottom),
                                         value=float("-inf"))
        idx = torch.nn.functional.max_pool2d(padded, geo.k, geo.s,
                                             return_indices=True)[1]
        wide = geo.w + left + right
        want = (idx // wide - top) * geo.w + (idx % wide - left)
        worst["picks_differ"] = int((picks != want).sum())
    for name in ("dy", "dsc"):
        if name in t:
            a, b = k[name].float(), t[name].float()
            worst[f"{name}_of_tol"] = ((a - b).abs()
                                       / (2.0 ** -7 * b.abs())
                                       ).nan_to_num(0.0, posinf=1e30).max(
                                           ).item()
            worst[f"{name}_bit_equal_share"] = (a == b).float().mean().item()
    if "dse" in t:
        terms = (t["dsc"].float() * y.float()).abs().sum(dim=(2, 3),
                                                        keepdim=True)
        worst["dse_of_tol"] = ((k["dse"].float() - t["dse"].float()).abs()
                               / (2.0 ** -8 * (terms + t["dse"].float().abs())
                                  + 1e-30)).max().item()
    bad = {key: v for key, v in worst.items()
           if (key.endswith("_differ") and v != 0)
           or (key.endswith("_of_tol") and not v <= 1.0)}
    if bad:
        raise AssertionError(f"31a {list(shape)} {kind}: the exit kernels "
                             f"left the twin: {bad}")
    return worst


def exit_bytes(shape, kind: str, geo) -> tuple:
    """(forward, backward) bytes an exit must move in bf16: its inputs read
    once and its outputs written once (forward: y and the shortcut in; out
    and one byte of code a pooled element out. Backward: the output's
    gradient and the codes, y where the ReLU or se reads it and the
    shortcut where the ReLU does, in; dy and d_shortcut out)."""
    full = int(np.prod(shape))
    pooled = geo.n * geo.c * geo.oh * geo.ow
    reads_y = has_sc = kind != "stem"  # the stem: no ReLU, se or shortcut
    code = pooled if kind != "block" else 0
    fwd = 2 * full * (1 + has_sc) + 2 * pooled + code
    bwd = 2 * pooled + code + 2 * full * (reads_y + has_sc) \
        + 2 * full * (1 + has_sc)
    return fwd, bwd


def phase_block_exit(torch, seed: int) -> list:
    """31. The exit kernels: (a) held against the twin at every exit of
    the train cells; (b) times against bounds and the twin's eager chain
    at EXIT_SHAPES (module docstring) → the JSON rows of (b), one per
    kernel and shape."""
    from leaffliction_tpu_torch.ops import block_exit as exits
    from leaffliction_tpu_torch.ops.kernels import block_exit as kexit

    for shape, kind in EXIT_CELL_SHAPES:
        worst = exit_held_to_twin(torch, shape, kind, seed)
        log("31a block exit vs twin", shape=json.dumps(list(shape)),
            kind=kind, dtype="bf16", layout="channels-last",
            **{k: (f"{v:.4f}" if isinstance(v, float) else v)
               for k, v in worst.items()})
        torch.cuda.empty_cache()
    rows = []
    for shape, kind in EXIT_SHAPES:
        y, se, sc, relu, drop, pool = exit_inputs(torch, shape, kind, seed)
        geo = kexit.geometry(y, pool)
        out, code = kexit.forward(y, se, sc, relu, drop, pool, True)
        grad = torch.randn(out.shape, device="cuda").to(out.dtype).contiguous(
            memory_format=torch.channels_last)
        fwd_bytes, bwd_bytes = exit_bytes(shape, kind, geo)
        calls = {
            "exit_forward": (lambda: kexit.forward(y, se, sc, relu, drop,
                                                   pool, True), fwd_bytes),
            "exit_backward": (lambda: kexit.backward(
                grad, code, geo, y if relu or se is not None else None, se,
                sc if relu else None, sc is not None, relu, drop), bwd_bytes)}
        for name, (fn, nbytes) in calls.items():
            ms, launches = kernel_ms(torch, fn, name, 20)
            bound_ms, by = bound(nbytes, 0)
            row = {"name": name, "shape": list(shape), "kind": kind,
                   "ms": ms, "launches": launches,
                   "call_ms": cuda_ms(torch, fn, 20), "bound_ms": bound_ms,
                   "bound_by": by, "roofline_pct": 100 * bound_ms / ms}
            if name == "exit_backward" and se is not None:
                row["finalize_ms"] = kernel_ms(torch, fn, "exit_finalize",
                                               20)[0]
            rows.append(row)
            log("31b block exit", kernel=name, shape=json.dumps(shape),
                kind=kind, dtype="bf16", layout="channels-last",
                **{k: (f"{v:.5f}" if isinstance(v, float) else v)
                   for k, v in row.items()
                   if k not in ("name", "shape", "kind")})
        whole = {}
        for side, fn in (("kernels", exits.block_exit),
                         ("twin", exits.block_exit_plain)):
            leaves = [None if t is None else t.clone().requires_grad_()
                      for t in (y, se, sc)]
            want = [t for t in leaves if t is not None]

            def forward(fn=fn, leaves=leaves):
                return fn(*leaves, relu, drop, pool)

            res = forward()
            whole[f"{side}_forward_ms"] = cuda_ms(torch, forward, 10)
            whole[f"{side}_backward_ms"] = cuda_ms(
                torch, lambda res=res, want=want: torch.autograd.grad(
                    res, want, grad, retain_graph=True), 10)
        log("31b block exit whole", shape=json.dumps(shape), kind=kind,
            forward_bound_ms=f"{bound(fwd_bytes, 0)[0]:.5f}",
            backward_bound_ms=f"{bound(bwd_bytes, 0)[0]:.5f}",
            **{k: f"{v:.5f}" for k, v in whole.items()})
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    t_start = time.perf_counter()

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
    from leaffliction_tpu_torch.ops.kernels.components import cc_propagate
    from leaffliction_tpu_torch.ops.kernels.edge import edge_nms
    from leaffliction_tpu_torch.ops.kernels.rotate import train_aug
    from leaffliction_tpu_torch.ops.kernels.warp import rotate_expand
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
        cc_propagate.launches = edge_nms.launches = train_aug.launches = 0

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
        with k4_rounds_recorded() as k4_rounds:
            montages = [predictor.generate_mask_visualization(a)
                        for a in leaves]
            torch.cuda.synchronize()
        launches = {"cc_propagate": cc_propagate.launches,
                    "edge_nms": edge_nms.launches}
        # --- end of the serving path ---
        rounds_per_mask = sum(int(r.sum()) for r in k4_rounds) / BATCH
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
            k4_launches=launches["cc_propagate"],
            k4_launches_per_mask=launches["cc_propagate"] / BATCH,
            k4_rounds_per_mask=rounds_per_mask,
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
        k1_launches, train_ms = phase_training(torch, args.seed, rng)
        try:
            import PIL  # noqa: F401
        except ImportError:
            log("11 train cli", skipped="PIL is not installed")
        else:
            cli11_s = phase_train_cli(tmp, rng, kind)

        # 12. timings (CUDA events; host clock around synchronised work)
        x64 = predictor._upload(images[:SERVING_BATCH])
        fwd_ms = cuda_ms(torch, lambda: predictor._infer(images[:64]), 10)
        dev_ms = forward_ms(torch, predictor.model_loader.model, x64)
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
        log("12 montage",
            ms_per_224_mask_median=f"{np.median(mask_s) * 1e3:.3f}",
            ms_min=f"{min(mask_s) * 1e3:.3f}",
            ms_max=f"{max(mask_s) * 1e3:.3f}",
            k4_launches_per_mask=launches["cc_propagate"] / BATCH,
            k4_rounds_per_mask=rounds_per_mask)

        from leaffliction_tpu_torch.ops.kernels.components import (
            cc_propagate_plain,
        )
        from leaffliction_tpu_torch.ops.kernels.edge import edge_nms_plain

        # K4 per `_propagate` at the montage's size (the shared-memory
        # kernel) and at 291² (the global one); images run side by side, so
        # a round costs the call's time over its longest image's rounds
        k4 = {}
        for n, size in ((1, SIZE), (BATCH, SIZE), (1, 291)):
            mask = torch.from_numpy(rng.random((n, size, size)) < 0.5).cuda()
            lab = seeded_labels(torch, mask)
            rounds = cc_propagate(lab, mask, 2 * size)[1].tolist()
            ms = cuda_ms(torch, lambda: cc_propagate(lab, mask, 2 * size), 20)
            twin_ms = cuda_ms(torch, lambda: cc_propagate_plain(
                lab, mask, 2 * size), 3)
            kms = kernel_ms(torch, lambda: cc_propagate(lab, mask, 2 * size),
                            "cc_propagate", 20)
            k4[f"{n}x{size}"] = [ms, twin_ms, rounds, kms]
            log("12 k4", shape=[n, size, size], density=0.5, limit=2 * size,
                k4_kernel_ms=f"{kms[0]:.4f}", k4_launches_per_call=kms[1],
                k4_propagate_ms=f"{ms:.4f}", k4_twin_ms=f"{twin_ms:.4f}",
                k4_rounds=json.dumps(rounds),
                k4_us_per_round=f"{ms * 1e3 / max(rounds):.2f}")
        k5 = {}
        for n in (BATCH, 1):
            g = gray[:n].contiguous()
            k5[n] = timed(torch, "edge_nms", lambda: edge_nms(g),
                          lambda: edge_nms_plain(g), 50, 50)
            log("12 k5", shape=[n, SIZE, SIZE],
                blocks_per_image=build.load().leaf_edge_nms_tiles(SIZE,
                                                                  SIZE),
                **fmt_timed("k5", k5[n]))
        log("12 wrapper pieces", unit="us", tensor=[1, SIZE, SIZE],
            **wrapper_pieces(torch, gray[:1].contiguous()))

        from leaffliction_tpu_torch.ops.kernels.rotate import train_aug_plain

        k1 = {}
        for n in (TRAIN_BATCH, 4 * TRAIN_BATCH):
            reps = -(-n // TRAIN_BATCH)
            imgs = k1_imgs.repeat(reps, 1, 1, 1)[:n]
            ang = k1_angles.repeat(reps)[:n]
            fac = k1_factors.repeat(reps)[:n]
            k1[n] = timed(torch, "train_aug", lambda: train_aug(
                              imgs, ang, fac, torch.bfloat16),
                          lambda: train_aug_plain(
                              imgs, ang, fac, torch.bfloat16), 20, 20)
            log("12 k1", shape=[n, SIZE, SIZE, 3], out="bf16",
                blocks_per_image=build.load().leaf_train_aug_blocks_per_image(
                    n, SIZE, SIZE, 3, 1),
                **fmt_timed("k1", k1[n]))
        x32 = k1_imgs.float() / 255.0
        k1c = timed(torch, "train_aug_f32", lambda: train_aug(x32, k1_angles),
                    lambda: train_aug_plain(x32, k1_angles), 20, 20)
        k1c_bound = bound(8 * x32.numel(), 21 * x32.numel())
        log("12 k1c", shape=list(x32.shape), mode="f32 rotation",
            bound_us=f"{k1c_bound[0] * 1e3:.3f}", bound_by=k1c_bound[1],
            **fmt_timed("k1c", k1c))

        # K1 (bf16 out) and K2 by batch size: the blocks per image each
        # launch takes (K1's cluster, K2's bands) and the kernel-only time
        from leaffliction_tpu_torch.ops.augment import rotate_canvas_hw

        lib, canvas = build.load(), rotate_canvas_hw(SIZE, SIZE)
        k2_angles = torch.from_numpy(np.random.default_rng(
            [args.seed, 12]).uniform(-30, 30, 128).astype(np.float32)).cuda()
        by_n = {"k1": {}, "k2": {}}
        for n in (8, 16, 28, 32, 64, 96, 128):
            reps = -(-n // TRAIN_BATCH)
            imgs = k1_imgs.repeat(reps, 1, 1, 1)[:n]
            ang, fac = k1_angles.repeat(reps)[:n], k1_factors.repeat(reps)[:n]
            by_n["k1"][n] = [
                lib.leaf_train_aug_blocks_per_image(n, SIZE, SIZE, 3, 1),
                round(kernel_ms(torch, lambda: train_aug(
                    imgs, ang, fac, torch.bfloat16), "train_aug", 20)[0], 5)]
            if n in (16, 32, 64, 128):
                by_n["k2"][n] = [
                    lib.leaf_rotate_expand_blocks_per_image(
                        n, SIZE, SIZE, *canvas),
                    round(kernel_ms(torch, lambda: rotate_expand(
                        imgs, k2_angles[:n], canvas), "rotate_expand",
                        20)[0], 5)]
        for k, v in by_n.items():
            log(f"12 {k} by batch", out="bf16" if k == "k1" else "uint8",
                blocks_per_image=json.dumps({n: b for n, (b, _) in v.items()}),
                kernel_ms=json.dumps({n: ms for n, (_, ms) in v.items()}))

        # 13-16. the balancing kernels against their twins, the fused
        # balance -> train path, the opt-in K6, timings
        balance_calls, balance_err = phase_kernels_balance(torch, rng)
        tree, fused_launches, k3_images = phase_fused_cli(torch, tmp, rng,
                                                          args.seed)
        k6_launches, k6_images = phase_optin_k6(torch, tree, args.seed)
        balance_ms = phase_balance_timings(
            torch, balance_calls, rng,
            {"shear_cubic": sorted(set(k3_images)),
             "distortion": sorted(set(k6_images))})

        # 17-20. the ResNet backbone: serving, the f32 step check, training
        # at full width, the CLIs
        t_resnet = time.perf_counter()
        resnet_ms = phase_resnet_serving(torch, tmp, args.seed, rng,
                                         device)
        phase_step_check(torch, "resnet10")
        resnet_k1, _ = phase_resnet_training(torch, args.seed, rng)
        resnet_launches = {"cc_propagate": 0, "edge_nms": 0}
        try:
            import PIL  # noqa: F401
        except ImportError:
            log("20 resnet clis", skipped="PIL is not installed")
        else:
            resnet_launches = phase_resnet_clis(torch, tmp)
        log("17-20 resnet", seconds=f"{time.perf_counter() - t_resnet:.1f}")

        # 21. the materialising balancer, its host pool and the host CLIs
        material = phase_materialising(torch, tmp, tree, rng, args.seed)

        # 22. the segmentation and analysis slice: the transform CLI and
        # train --transform (phase 11's manifest, phase 14's tree)
        transform_launches = phase_transform(
            torch, tmp, rng, tree, tmp / "manifest_split.json")

        # 23-24. resume, step checkpoints and the profiler hook on the
        # train path (phase 11's manifest); the library functions
        resume_k1, _ = phase_resume(torch, tmp, args.seed, rng)
        phase_library(torch, tmp, rng)

        # 25. data parallelism: two ranks on the one card (gloo), the
        # train CLI and --balance-from on phase 11's and 14's inputs, the
        # serving mesh
        dp_launches, _, dp_eq = phase_data_parallel(
            torch, tmp, args.seed, rng, tree, train_ms, learn, images)

        # 26. tensor parallelism: four ranks (data 2 x model 2) and two
        # (data 1 x model 2) on the one card (gloo), against phase 25a's
        # one process, resnet10, and the train CLI on phase 11's manifest
        tp_launches = phase_tensor_parallel(torch, tmp, args.seed, train_ms,
                                            dp_eq, learn, images)

        # 27. multi-step dispatch: K steps a CUDA graph replay against
        # eager steps, the train CLI's chained default on phase 11's
        # manifest, a chained run killed and resumed
        chain_k1, step_ms = phase_chain(torch, tmp, args.seed, rng)

        # 28. FLOPs a step and a forward (`train/flops.py`), MFU of 27b's
        # steps, of the other four of bench.py's six and of the forwards
        flops_k1 = phase_flops(torch, args.seed, rng, step_ms, {
            "leafcnn-base": (learn, dev_ms),
            "resnet18": (tmp / "resnet18_conv", resnet_ms["resnet18"])})

        # 29. the streamed train path (prefetch_to_device) against the
        # gather path, and the .keras artifact where keras is importable
        stream_k1 = phase_streamed(torch, tmp, args.seed, rng, cli11_s)

    # 30. the BatchNorm kernels: held against the twin at the train cells'
    # shapes, and timed at the largest
    bn_rows = phase_batch_norm(torch, args.seed)

    # 31. the residual blocks' exit: held against the twin at the train
    # cells' exits, and timed at three of them
    exit_rows = phase_block_exit(torch, args.seed)

    # bounds from this run's inputs: bytes each input read once and each
    # output written once; 32-bit operations per element counted from each
    # kernel's arithmetic (K4 per pixel and round run: 3x3 max 8, mask 1,
    # row and column scans 4, compare 1; K5 per pixel: separable 5-tap blur
    # 20, separable Sobel pair 24, magnitude 3, sector and NMS 10; K1 per
    # value: three linear shear passes 7 each, contrast 4; K2 per canvas
    # value: three passes 7 each; K3 per value: 4 Keys weights and taps 20;
    # K6 per value: the function's own work, 3 Philox4x32-10 calls (the 12
    # words a value's noise sums) of 64 each, plus noise sum, clip and
    # remap 30. A round is 8 operations a stream (two 32 x 32 -> 64-bit
    # products at 2 each, two three-way xors at 2 each); the round keys
    # depend only on the plane's seed, so they are per plane, not per
    # value. Rounds 1-3 start from the counter (pixel, j, 0, 0): their
    # products take the pixel index, zero or the seed and j, so a pixel's
    # nine streams (3 channels x 3 calls) or a plane's pixels share them,
    # which leaves about 8 operations a stream for the three together;
    # rounds 4-10 are 56. A kernel that draws the noise again for the
    # remap does more work, not a larger bound. OPS_PER_S counts an
    # integer multiply at the f32 rate; the 32 x 32 -> 64-bit products
    # (IMAD.WIDE) issue slower, so K6's true floor is higher than this
    # bound.)
    from leaffliction_tpu_torch.ops.augment import rotate_canvas_hw

    px4 = BATCH * SIZE * SIZE
    val64 = FUSED_BATCH * SIZE * SIZE * 3
    canvas_h, canvas_w = rotate_canvas_hw(SIZE, SIZE)
    canvas_vals = FUSED_BATCH * canvas_h * canvas_w * 3
    bounds = {
        "cc_propagate": bound(9 * px4 + 4 * BATCH,
                              14 * sum(k4[f"{BATCH}x{SIZE}"][2]) * SIZE
                              * SIZE),
        "edge_nms": bound(8 * px4, 57 * px4),
        "train_aug": bound(3 * TRAIN_BATCH * SIZE * SIZE * 3
                           + 8 * TRAIN_BATCH,
                           25 * TRAIN_BATCH * SIZE * SIZE * 3),
        "rotate_expand": bound(val64 + canvas_vals + 4 * FUSED_BATCH,
                               21 * canvas_vals),
        "shear_cubic": k3_bound(FUSED_BATCH),
        "distortion": k6_bound(FUSED_BATCH),
    }
    k4_row = k4[f"{BATCH}x{SIZE}"]
    tl = transform_launches
    rows = [
        ("cc_propagate", ["components.py:98"],
         launches["cc_propagate"] + resnet_launches["cc_propagate"]
         + tl["cc_propagate"],
         k4_err, {"ms": k4_row[3][0], "call_ms": k4_row[0],
                  "plain_ms": k4_row[1]}),
        ("edge_nms", ["edge.py:108"],
         launches["edge_nms"] + resnet_launches["edge_nms"]
         + tl["edge_nms"], k5_err, k5[BATCH]),
        ("train_aug", ["rotate.py:752", "rotate.py:583", "rotate.py:801"],
         k1_launches + resnet_k1 + tl["train_aug"] + resume_k1
         + dp_launches["train_aug"] + tp_launches["train_aug"] + chain_k1
         + flops_k1 + stream_k1,
         k1_err,
         k1[TRAIN_BATCH]),
        ("rotate_expand", ["rotate.py:435", "rotate.py:837"],
         fused_launches["rotate_expand"] + material["rotate_expand"]
         + tl["rotate_expand"] + dp_launches["rotate_expand"],
         balance_err["rotate_expand"], balance_ms["rotate_expand"]),
        ("shear_cubic", ["rotate.py:304"],
         fused_launches["shear_cubic"] + material["shear_cubic"]
         + tl["shear_cubic"] + dp_launches["shear_cubic"],
         balance_err["shear_cubic"], balance_ms["shear_cubic"]),
        ("distortion", ["distortion.py:108"],
         k6_launches + material["distortion"], balance_err["distortion"],
         balance_ms["distortion"]),
    ]
    kernels = []
    for name, replaces, n, err, ms in rows:
        bound_ms, bound_by = bounds[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"leaffliction_tpu_torch/csrc/{name}.cu",
            "replaces": ", ".join(f"leaffliction_tpu/ops/pallas/{r}"
                                  for r in replaces),
            "launches": n, "max_abs_err": err, "ms": round(ms["ms"], 5),
            "call_ms": round(ms["call_ms"], 5),
            "plain_ms": round(ms["plain_ms"], 5),
            "bound_ms": round(bound_ms, 6),
            "bound_us": round(bound_ms * 1e3, 3), "bound_by": bound_by,
            "library_ms": None})
    log("done", smoke_seconds=f"{time.perf_counter() - t_start:.1f}")
    print(f"nvidia-smi: {nvidia_smi()}", flush=True)
    print(json.dumps({"kernels": kernels, "card": CARD}), flush=True)
    print(json.dumps({"batch_norm": bn_rows, "card": CARD}), flush=True)
    print(json.dumps({"block_exit": exit_rows, "card": CARD}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
