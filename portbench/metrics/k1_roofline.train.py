"""k1_roofline.train: kernel K1's (`csrc/train_aug.cu`) least time over
its median kernel time in the trace (%). The least time is the uint8
batch read once and the bf16 batch written once, at the cell's batch and
size, over the HBM rate; K1's arithmetic is far below the compute rate."""

import numpy as np

from portbench import flops

FRAGMENTS = ("train_aug",)


def least_seconds(batch: int, size: int) -> float:
    pixels = batch * size * size * 3
    return (pixels * 1 + pixels * 2) / flops.HBM_BYTES_PER_S


def read(run):
    t = run.traced
    times = t.kernel_times(*FRAGMENTS) if t is not None else []
    if not times:
        return None
    least = least_seconds(run.config["batch_size"], run.config["img_size"])
    return 100.0 * least / float(np.median(times))
