"""Sampler driver: host milliseconds a potential call spends outside the
potential, (window - time inside the potential's spans) / calls."""


def read(r):
    c = r.window
    if not c.calls:
        return None
    return (r.window_s - c.potential_s) * 1e3 / c.calls
