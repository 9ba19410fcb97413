"""Neural density estimators (PyTorch port): the MNLE (categorical head +
RQ-spline flow)."""

from .mnle_net import MNLE, MNLEConfig, MNLENet, build_mnle
from .spline import num_spline_params, rq_spline_forward, rq_spline_inverse

__all__ = [
    "MNLE",
    "MNLEConfig",
    "MNLENet",
    "build_mnle",
    "num_spline_params",
    "rq_spline_forward",
    "rq_spline_inverse",
]
