"""End to end: seconds from the process's start to the window's opening:
imports, the kernels' build or load, the model, the cell's inputs and its
warm-up request."""


def read(r):
    return r.setup_s
