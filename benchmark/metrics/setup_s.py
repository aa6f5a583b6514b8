"""setup_s (s): process start to the window's start: imports, CUDA start,
loading (or the first time, building) the kernels, the cell's inputs made
from the seed, and the warm-up renders of the cell's own shapes."""


def read(run):
    return run.setup_s
