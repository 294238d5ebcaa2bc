"""graph_launch.train: the port's `graphs.launch` spans (the host inside
`CUDAGraph.replay`) summed over the traced epoch, as a share (%) of the
traced window (`spans.window_share`). Near `cudaGraphLaunch`'s idle share
every launch finds the device drained; far above it, launches overlap
device work."""

from portbench import spans


def read(run):
    return spans.window_share(run, "graphs.launch")
