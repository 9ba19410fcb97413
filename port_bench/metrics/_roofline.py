"""Shared by the fused backward kernels' roofline readers."""

from port_bench import counts


def roofline_pct(r, kernel: str):
    """The datasheet-bound time of the rows the named kernel ran in the
    profiled tail (one launch a gradient call over all its rows) over that
    kernel's device time, in %; None where the trace shows no such kernel."""
    if r.trace is None or r.shapes is None:
        return None
    seconds = sum(s for name, s in r.trace["op_s"].items() if kernel in name)
    launches = sum(n for name, n in r.trace["op_n"].items() if kernel in name)
    t = r.tail
    if not seconds or not t.grad_rows:
        return None
    flops = t.grad_rows * counts.row_flops(r.shapes, True)
    nbytes = launches * counts.weight_bytes(r.shapes) + t.grad_rows * counts.row_bytes(r.shapes, True)
    return 100.0 * counts.bound_seconds(flops, nbytes)[0] / seconds
