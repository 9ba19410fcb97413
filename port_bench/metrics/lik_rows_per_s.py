"""End to end: trial-likelihood rows evaluated by the sampler's potential
calls (gradient and value-only) completed in the window, over the window's
wall time."""


def read(r):
    return r.window.rows / r.window_s if r.window.rows else None
