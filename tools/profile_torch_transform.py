#!/usr/bin/env python3
"""Profile the PyTorch port's transform CLI in folder mode on one CUDA card.

    python tools/profile_torch_transform.py [--images 64] [--out build/profile]

Writes `--images` leaf-like 256² JPEGs with brown spots (`chip_smoke.py`'s
`spotted_leaf`, seeded), runs `cli.transform` in folder mode on 8 of them
as a warm-up, then on all of them three times: plain (the wall and its
stage seconds), under `torch.profiler` (CPU + CUDA: the summed device time
of all kernels, the device busy share over the wall, the device time by
kernel group and the top kernels), and under `cProfile` (the host
functions by their own time and by cumulative time; cProfile slows Python
code and not native code, so read its shares as where the host time goes,
not as times). The card's name and power limit are printed first; the
full tables go under --out.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=str(ROOT / "build" / "profile"))
    p.add_argument("--images", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    from PIL import Image

    import chip_smoke as smoke
    from leaffliction_tpu_torch.cli.transform import main as transform
    from profile_torch_serving import device_us, kernel_group

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(f"nvidia-smi: {smoke.nvidia_smi()}", flush=True)
    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory(prefix="profile_transform_") as tmp:
        tmp = Path(tmp)
        src, warm = tmp / "src", tmp / "warm"
        for i in range(args.images):
            d = src / f"class{i % 8}"
            d.mkdir(parents=True, exist_ok=True)
            leaf = smoke.spotted_leaf(rng, 256)
            Image.fromarray(leaf).save(d / f"image ({i}).JPG", quality=90)
            if i < 8:
                warm.mkdir(exist_ok=True)
                Image.fromarray(leaf).save(warm / f"image ({i}).JPG",
                                           quality=90)

        def run(name):
            return transform(["-src", str(src if name != "warm" else warm),
                              "-dst", str(tmp / f"out_{name}"), "--device",
                              "cuda"])

        run("warm")
        torch.cuda.synchronize()
        plain = run("plain")
        print(f"[plain] images={plain['images']} "
              f"wall_s={plain['wall_s']:.3f} "
              f"img_per_s={plain['images'] / plain['wall_s']:.2f} "
              + " ".join(f"{k}_s={v:.3f}"
                         for k, v in plain["stages"].items()), flush=True)

        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run("torch_profiler")
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.key_averages()
        cuda = [e for e in events
                if str(getattr(e, "device_type", "")).endswith("CUDA")]
        busy_us = sum(device_us(e) for e in cuda)
        (out / "transform_folder_kernels.txt").write_text(
            events.table(sort_by="self_device_time_total", row_limit=60))
        print(f"[torch.profiler] wall_ms={wall_us / 1e3:.1f} "
              f"device_busy_ms={busy_us / 1e3:.3f} "
              f"busy_share={busy_us / wall_us:.4f} "
              f"kernel_launches={sum(e.count for e in cuda)}", flush=True)
        groups: dict = {}
        for e in cuda:
            g = "k4_k5" if ("cc_" in e.key or "edge_nms" in e.key) \
                else kernel_group(e.key)
            groups[g] = groups.get(g, 0.0) + device_us(e)
        print("    by group (device ms): " + " ".join(
            f"{g}={us / 1e3:.3f}" for g, us in sorted(
                groups.items(), key=lambda kv: -kv[1])), flush=True)
        for e in sorted(cuda, key=device_us, reverse=True)[:10]:
            print(f"    {device_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
                  f"{e.key[:90]}", flush=True)

        prof_c = cProfile.Profile()
        t0 = time.perf_counter()
        prof_c.enable()
        run("cprofile")
        torch.cuda.synchronize()
        prof_c.disable()
        print(f"[cProfile] wall_s={time.perf_counter() - t0:.3f}",
              flush=True)
        for key, name in (("tottime", "own"), ("cumulative", "cumulative")):
            buf = io.StringIO()
            pstats.Stats(prof_c, stream=buf).sort_stats(key).print_stats(40)
            (out / f"transform_folder_cprofile_{name}.txt").write_text(
                buf.getvalue())
            stats = pstats.Stats(prof_c).sort_stats(key)
            rows = sorted(stats.stats.items(),
                          key=lambda kv: -kv[1][2 if key == "tottime"
                                                 else 3])[:15]
            print(f"    host by {name} time (s):", flush=True)
            for (fname, line, func), (_, calls, tt, ct, _) in rows:
                where = f"{Path(fname).name}:{line}({func})"
                print(f"      {tt if key == 'tottime' else ct:8.3f}  "
                      f"x{calls:<7d} {where[:90]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
