"""End to end: (z, x) pairs consumed by the optimizer steps completed in the
window (validation passes fall inside it), over the window's wall time."""


def read(r):
    return r.window.pairs / r.window_s if r.window.pairs else None
