"""train_img_per_s: the training images that `fit` completed in the
window (whole epochs, their evaluations inside) over the window's
seconds, host clock."""


def read(run):
    if not run.window_s or not run.images:
        return None
    return run.images / run.window_s
