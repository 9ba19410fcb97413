"""Model step (training): forward, weight-gradient and input-gradient
products of the pairs of the window's optimizer steps, as a share of the
window at the FP32 peak (training keeps TF32 off)."""

from port_bench import counts


def read(r):
    c = r.window
    if not c.pairs or r.shapes is None:
        return None
    return 100.0 * c.pairs * counts.train_flops(r.shapes) / (r.window_s * counts.FP32_FLOPS)
