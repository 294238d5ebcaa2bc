"""setup_s: seconds from the process's start to the window's: imports,
inputs and weights made from the seed, the build of the port's kernels
in a checkout's first run, and the warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
