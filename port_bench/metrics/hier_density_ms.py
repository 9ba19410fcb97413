"""Hierarchical density: host milliseconds a potential call spends inside
the port's ``hier.density`` spans (the joint density's bijection,
hyperprior, u = mu + tau * eps and chain rule around the likelihood) and
outside their ``potential`` spans, over the profiled tail, from the port's
recorder (``drivers/hier.py`` puts the totals on the tail's counters).
Nothing where the port records no such span."""


def read(r):
    calls = getattr(r.tail, "hier_calls", 0)
    if not calls:
        return None
    return r.tail.hier_density_s * 1e3 / calls
