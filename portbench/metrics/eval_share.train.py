"""eval_share.train: the port's `trainer.evaluate` spans (the epoch's
evaluation over the validation set) summed over the traced epoch, as a
share (%) of the traced window (`spans.window_share`)."""

from portbench import spans


def read(run):
    return spans.window_share(run, "trainer.evaluate")
