"""Potential: mean host span of a call of the likelihood
(``log_lik_and_grad``, ``log_lik_fn``), in milliseconds."""


def read(r):
    c = r.window
    if not c.calls:
        return None
    return c.potential_s * 1e3 / c.calls
