"""Model step: the MNLE products of every row of every potential call in the
window (forward; the input gradient too on gradient calls), as a share of
the window at the FP32 peak."""

from port_bench import counts


def read(r):
    c = r.window
    if not c.rows or r.shapes is None:
        return None
    flops = c.grad_rows * counts.row_flops(r.shapes, True) + c.value_rows * counts.row_flops(r.shapes, False)
    return 100.0 * flops / (r.window_s * counts.FP32_FLOPS)
