"""Device: the share of the profiled tail of a sampler cell in which no
operation ran on the card."""


def read(r):
    if r.trace is None or not r.tail_s or not r.tail.calls:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.tail_s)
