"""Kernel K1: the pulse-DDM simulator as a hand-written CUDA kernel.

Counterpart of ``sbi_for_diffusion_models_tpu/ops/ddm_pallas.py``
(``ddm_rt_choice_pallas``); the kernel is ``csrc/ddm_rt_choice.cu``.
``ddm_rt_choice_cuda`` launches it for CUDA tensors. For CPU tensors it runs
the plain version, ``ops/ddm_scan.ddm_rt_choice_scan``, which has the same
semantics but another random stream (as the Pallas kernel's hardware PRNG
differs from the scan kernel's), so the two agree exactly only without
noise and in distribution otherwise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ..constants import DT_CHOICE, T_MAX
from ..utils.rng import as_seed
from ._cuda import CudaKernel, check_cuda_tensor, stream_handle
from .ddm_scan import ddm_rt_choice_scan

__all__ = ["ddm_rt_choice_cuda", "K1"]

K1 = CudaKernel(
    "ddm_rt_choice",
    "ddm_rt_choice.cu",
    "sdm_ddm_rt_choice",
    [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 3
    + [ctypes.c_float] * 5
    + [ctypes.c_uint64, ctypes.c_void_p],
    flags=("--fmad=false",),
)


def ddm_rt_choice_cuda(
    theta: torch.Tensor,
    pulse_sides: torch.Tensor,
    seed: int = 0,
    *,
    mu_sensory: float = 1.0,
    collapse_rate: float = 0.0,
    dt: float = float(DT_CHOICE),
    t_max: float = float(T_MAX),
    steps_per_pulse: int = 200,
    n_max: Optional[int] = None,
) -> torch.Tensor:
    """theta (N, 5), pulse_sides (N, P >= n_max/steps_per_pulse) ->
    (N, 2) float32 [rt, choice], choice in {0, 1, 2}."""
    if n_max is None:
        n_max = int(t_max / dt)
    if n_max % steps_per_pulse != 0:
        raise ValueError(f"n_max={n_max} must be divisible by steps_per_pulse={steps_per_pulse}")
    if not theta.is_cuda:
        return ddm_rt_choice_scan(
            theta, pulse_sides, seed, mu_sensory=mu_sensory, collapse_rate=collapse_rate,
            dt=dt, t_max=t_max, steps_per_pulse=steps_per_pulse,
            chunk_steps=steps_per_pulse, n_max=n_max,
        )
    if steps_per_pulse % 4 != 0:
        raise ValueError(
            f"steps_per_pulse={steps_per_pulse} must be a multiple of 4 (one Philox "
            "call feeds four steps)"
        )
    n_chunks = n_max // steps_per_pulse
    N = theta.shape[0]
    if pulse_sides.dim() != 2 or pulse_sides.shape[1] < n_chunks:
        raise ValueError(
            f"pulse_sides must be (N, P >= {n_chunks}), got {tuple(pulse_sides.shape)}"
        )
    if pulse_sides.device != theta.device:
        raise ValueError("theta and pulse_sides must be on one device")
    # The kernel reads trial-minor layouts: (5, N) and (P, N).
    theta_t = theta.t().contiguous()
    s_t = pulse_sides[:, :n_chunks].t().contiguous()
    check_cuda_tensor("theta^T", theta_t, (5, N))
    check_cuda_tensor("pulse_sides^T", s_t, (n_chunks, N))
    out = torch.empty((N, 2), dtype=torch.float32, device=theta.device)
    sig = float(np.float32(mu_sensory) * np.sqrt(np.float32(dt)))
    K1(
        theta_t.data_ptr(), s_t.data_ptr(), out.data_ptr(),
        N, n_max, steps_per_pulse,
        float(dt), float(t_max), float(t_max) - 1e-6, sig, float(collapse_rate),
        as_seed(seed), stream_handle(theta.device),
    )
    return out
