#!/usr/bin/env python3
"""Multi-step dispatch times that `chip_smoke.py` phase 27 does not take:

1. the whole val set eagerly (`StepFns.eval_chain_gather`, its `sel` and
   `mask` uploaded, one host read) against a CUDA graph of the same
   call replayed, with the graph's warm-up (its first batch) and capture
   timed apart, at a val set of `--val-images` (a 20% split of the
   Leaffliction tree's 7,222 images) for leafcnn-base b32 and resnet18
   b128 (bf16, random weights);
2. the train CLI at its chained default against `--steps-per-dispatch 1`
   on phase 11's manifest (a JPEG tree of 8 classes × 32 leaf-like images,
   7 steps an epoch at b32), for leafcnn-base (the CLI's default) and
   `--arch resnet18`, after one untimed epoch (the process's and the
   model's first-use costs), at 2 and at 20 epochs (early stopping may end
   a run sooner), each length run eager, chained, chained, eager: the walls
   and steps of each run, and for each mode a line through its two
   lengths' medians (wall against steps), where the chained line meets the
   eager one.

    python tools/time_chain.py [--seed N] [--val-images N] [--reps N]
                               [--parts eval,cli]

Run from the root of a checkout on a machine with a CUDA card. It prints
its lines as `chip_smoke.py` does, beside the card's name and power limit,
and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

EVAL_MODELS = (("leafcnn-base", 32), ("resnet18", 128))
CLI_MODELS = (("leafcnn-base", ()), ("resnet18", ("--arch", "resnet18")))
CLI_EPOCHS = (2, 20)


def time_eval(torch, cs, arch: str, batch: int, n_val: int, reps: int,
              seed: int) -> None:
    """Eager whole-set eval against a graph replay of it (one line)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    data = torch.randint(0, 256, (n_val, cs.SIZE, cs.SIZE, 3),
                         dtype=torch.uint8, device="cuda", generator=gen)
    labels = torch.randint(0, cs.CLASSES, (n_val,), device="cuda",
                           generator=gen)
    state, fns, _ = cs.chain_setup(torch, arch, "regularized", seed, data)
    k = -(-n_val // batch)
    sel = np.resize(np.arange(n_val), k * batch).reshape(k, batch)
    mask = (np.arange(k * batch) < n_val).astype(np.float32).reshape(
        k, batch)

    def sums(m):
        return torch.stack([m["loss_sum"], m["correct"], m["n"]]).sum(1)

    def eager():
        m, _ = fns.eval_chain_gather(
            state, data, labels, torch.from_numpy(sel).cuda(),
            torch.from_numpy(mask).cuda())
        return sums(m).double().cpu()

    static = (torch.from_numpy(sel).cuda(), torch.from_numpy(mask).cuda())
    eager()  # cuDNN and cuBLAS set up for the eager path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fns.eval_chain_gather(state, data, labels, static[0][:1],
                              static[1][:1])
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph):
        out = sums(fns.eval_chain_gather(state, data, labels, *static)[0])
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0

    def replay():
        graph.replay()
        return out.double().cpu()

    times = {"eager": [], "graph": []}
    results = {}
    for _ in range(reps):
        for name, fn in (("eager", eager), ("graph", replay),
                         ("graph", replay), ("eager", eager)):
            t0 = time.perf_counter()
            results[name] = fn()
            times[name].append((time.perf_counter() - t0) * 1e3)
    diff = float((results["eager"] - results["graph"]).abs().max())
    eager_ms, graph_ms = (np.median(times["eager"]),
                          np.median(times["graph"]))
    gain = eager_ms - graph_ms
    cost_ms = (warmup_s + capture_s) * 1e3
    evals_20 = CLI_EPOCHS[-1] + 1  # an eval an epoch and the last choice
    cs.log("eval graph", model=arch, img=cs.SIZE, batch=batch, dtype="bf16",
           val_images=n_val, batches=k, reps=2 * reps,
           eager_ms_median=f"{eager_ms:.3f}",
           eager_ms_min=f"{min(times['eager']):.3f}",
           eager_ms_max=f"{max(times['eager']):.3f}",
           graph_ms_median=f"{graph_ms:.3f}",
           graph_ms_min=f"{min(times['graph']):.3f}",
           graph_ms_max=f"{max(times['graph']):.3f}",
           warmup_s=f"{warmup_s:.3f}", capture_s=f"{capture_s:.3f}",
           gain_ms_per_eval=f"{gain:.3f}",
           evals_to_repay=(f"{cost_ms / gain:.1f}" if gain > 0 else "never"),
           net_s_over_21_evals=f"{(evals_20 * gain - cost_ms) / 1e3:.3f}",
           sums_max_abs_diff=f"{diff:.3e}")
    graph.reset()


def fixed_and_slope(a, b):
    """The line through two (steps, wall s) points → (wall at 0 steps, s a
    step)."""
    slope = (b[1] - a[1]) / (b[0] - a[0])
    return a[1] - slope * a[0], slope


def time_cli(torch, cs, tmp: Path, rng, seed: int) -> None:
    """The train CLI chained against eager at each of CLI_EPOCHS, for
    each of CLI_MODELS."""
    from leaffliction_tpu_torch.cli.train import main as train_main
    from leaffliction_tpu_torch.core.logging import setup_logging
    from leaffliction_tpu_torch.data.manifest import write_split_manifest

    cs.write_jpeg_tree(tmp / "tree", rng)
    manifest = tmp / "manifest_split.json"
    write_split_manifest(tmp / "tree", manifest, val_ratio=0.2, seed=32)

    def run_cli(name: str, epochs: int, *extra: str):
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                fit = train_main([
                    "--manifest", str(manifest), "--epochs", str(epochs),
                    "--img-size", str(cs.SIZE),
                    "--batch-size", str(cs.TRAIN_BATCH),
                    "--seed", str(seed), "--out-dir", str(tmp / name),
                    *extra])["fit"]
        finally:
            setup_logging()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, fit.train_time_s, fit.steps_ran

    eager_flags = ("--steps-per-dispatch", "1")
    for model, model_flags in CLI_MODELS:
        run_cli("cli_first", 1, *model_flags, *eager_flags)
        line = {}
        for epochs in CLI_EPOCHS:
            runs = {"eager": [], "chained": []}
            for mode in ("eager", "chained", "chained", "eager"):
                runs[mode].append(run_cli(
                    f"cli_{epochs}_{mode}", epochs, *model_flags,
                    *(eager_flags if mode == "eager" else ())))
            for mode, rs in runs.items():
                line.setdefault(mode, []).append(
                    (np.median([r[2] for r in rs]),
                     np.median([r[0] for r in rs])))
            cs.log("chain cli", model=model, batch=cs.TRAIN_BATCH,
                   epochs=epochs,
                   **{f"{m}_{key}": [round(r[i], 3) if i < 2 else r[i]
                                     for r in rs]
                      for m, rs in runs.items()
                      for i, key in enumerate(("wall_s", "train_s",
                                               "steps"))})
        if any(line[m][0][0] == line[m][1][0] for m in line):
            continue  # early stopping ended both lengths at one step count
        (ae, be), (ac, bc) = (fixed_and_slope(*line[m])
                              for m in ("eager", "chained"))
        cs.log("chain cli break-even", model=model,
               eager_fixed_s=f"{ae:.3f}", eager_ms_per_step=f"{be * 1e3:.3f}",
               chained_fixed_s=f"{ac:.3f}",
               chained_ms_per_step=f"{bc * 1e3:.3f}",
               steps_to_break_even=(f"{(ac - ae) / (be - bc):.1f}"
                                    if be > bc else "never"))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--val-images", type=int, default=1444)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--parts", default="eval,cli",
                   help="comma-separated: eval (1), cli (2)")
    args = p.parse_args()
    parts = set(args.parts.split(","))

    import torch

    import chip_smoke as cs
    from leaffliction_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print("time_chain: CUDA is not available", file=sys.stderr)
        return 1
    cs.CARD = cs.nvidia_smi()
    build.load()
    for arch, batch in EVAL_MODELS if "eval" in parts else ():
        time_eval(torch, cs, arch, batch, args.val_images, args.reps,
                  args.seed)
    if "cli" in parts:
        with tempfile.TemporaryDirectory(prefix="time_chain_") as tmp:
            time_cli(torch, cs, Path(tmp), np.random.default_rng(args.seed),
                     args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
