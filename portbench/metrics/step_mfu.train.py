"""step_mfu.train: the train step's share (%) of the card's dense bf16
peak over the traced epoch: the reference's FLOPs for one image's forward
and backward (`flops.train_flops_per_image`) times the rows the traced
epoch's steps computed (padding rows included, they are computed) over
the traced window, evaluation time included."""

from portbench import flops


def read(run):
    t, rows = run.traced, run.counters.get("traced_rows")
    if t is None or not rows or t.window_s <= 0:
        return None
    per_image = flops.train_flops_per_image(run.config)
    return 100.0 * per_image * rows / t.window_s / flops.peak_flops(
        run.device)
