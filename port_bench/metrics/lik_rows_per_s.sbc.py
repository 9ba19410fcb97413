"""End to end, SBC cells: the same rate as ``lik_rows_per_s`` (rows of the
potential calls completed in the window over its wall time), under a bound
of its own: the fold's calls are a hundred times longer and its runs spread
about a tenth as much as the serving cells', whose host-bound spread sets
``lik_rows_per_s``'s bound."""


def read(r):
    return r.window.rows / r.window_s if r.window.rows else None
