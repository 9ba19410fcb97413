"""Sampler driver: device microseconds a launch of the NUTS leaf kernel
(``nuts_leaf_kernel``) takes in the profiled tail."""


def read(r):
    if r.trace is None:
        return None
    seconds = sum(s for name, s in r.trace["op_s"].items() if "nuts_leaf_kernel" in name)
    launches = sum(n for name, n in r.trace["op_n"].items() if "nuts_leaf_kernel" in name)
    return seconds * 1e6 / launches if launches else None
