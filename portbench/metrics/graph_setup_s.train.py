"""graph_setup_s.train: host seconds of the port's CUDA-graph warm-ups and
captures (the counter `graphs.capture_s`); the set-up epoch captures both
graphs, so they all fall in `setup_s`. Read in the traced run."""

from portbench import spans


def read(run):
    if run.traced is None:
        return None
    return spans.counter("graphs.capture_s")
