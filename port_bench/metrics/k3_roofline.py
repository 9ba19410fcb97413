"""Kernels (K3): the fused MNLE backward's share of its datasheet bound over
the rows it ran (bound by FLOP at the FP32 peak at these shapes)."""

from port_bench.metrics._roofline import roofline_pct


def read(r):
    return roofline_pct(r, "mnle_logprob_bwd_kernel")
