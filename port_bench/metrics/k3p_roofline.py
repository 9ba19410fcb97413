"""Kernels (K3p): the pulse-grid fused MNLE backward's share of its datasheet
bound over the rows it ran (bound by FLOP at the FP32 peak)."""

from port_bench.metrics._roofline import roofline_pct


def read(r):
    return roofline_pct(r, "mnle_pulse_bwd_kernel")
