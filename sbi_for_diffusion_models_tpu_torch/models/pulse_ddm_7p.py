"""7-parameter pulse-DDM (PyTorch port): theta = [a0, lam, nu, B, sigma_a,
t_nd, sigma_s].

Counterpart of ``sbi_for_diffusion_models_tpu/models/pulse_ddm_7p.py`` with
the same names and semantics:

* ``sigma_a = |theta[:, 4]|`` is each trial's diffusion noise scale (the
  5-parameter model's global ``mu_sensory``), passed to the simulator as an
  (N,) tensor, so kernel K1 runs its per-trial noise-scale instances on the
  card;
* ``sigma_s = |theta[:, 6]|`` corrupts every pulse: the kick reads s_eff =
  s + sigma_s * eta, eta ~ N(0, 1) per (trial, pulse), which K1 takes as
  real-valued pulses.

Everything else (leak, bounds, censoring, RT convention) is the
5-parameter model's, through ``rt_choice_model.dispatch_sim_kernel``. The
streams are the port's own: outputs agree with the JAX package's exactly
without noise (sigma_a = sigma_s = 0) and in distribution otherwise.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..constants import T_MAX
from ..run_config import RUN_CONFIG_PARAMS
from ..utils.rng import as_seed, child_seed, make_generator
from .rt_choice_model import (
    _as_f32,
    as_pulse_tensor,
    dispatch_sim_kernel,
    generate_pulse_matrix,
    n_pulses_max_from_schedule,
    pulse_schedule,
)

cfg = RUN_CONFIG_PARAMS

ArrayLike = Union[np.ndarray, torch.Tensor]

__all__ = ["rt_choice_model_simulator_7p", "simulate_session_data_7p"]


def rt_choice_model_simulator_7p(
    theta: ArrayLike,
    rng=None,
    *,
    pulse_sides: Optional[ArrayLike] = None,
    p_success: float = cfg.P_SUCCESS,
    collapse_rate: float = 0.0,
    device=None,
) -> torch.Tensor:
    """Batched 7-parameter simulator: theta (N, 7) or (7,) [a0, lam, nu, B,
    sigma_a, t_nd, sigma_s] -> (N, 2) float32 [rt, choice] on ``device``
    (default: theta's device, the CUDA card for numpy input). Without
    ``pulse_sides`` the stimulus is drawn here (``child_seed(rng, 1)``); a
    single stimulus row broadcasts over the batch. The sensory noise eta
    comes from ``child_seed(rng, 2)``, the diffusion noise from
    ``child_seed(rng, 0)``."""
    theta = _as_f32(theta, device)
    if theta.dim() == 1:
        theta = theta.reshape(1, -1)
    if theta.shape[-1] != 7:
        raise ValueError(f"Expected theta shape (N,7) or (7,), got {tuple(theta.shape)}")
    seed = as_seed(rng)
    dev = theta.device
    N = theta.shape[0]
    n_max, spp = pulse_schedule()
    P = n_pulses_max_from_schedule(n_max, spp)
    if pulse_sides is None:
        s = generate_pulse_matrix(make_generator(child_seed(seed, 1), dev), N, P, p_success=p_success)
    else:
        s = as_pulse_tensor(pulse_sides, device=dev)
        if s.shape[0] == 1 and N > 1:
            s = s.expand(N, s.shape[1])
        if s.shape[0] != N:
            raise ValueError(
                f"pulse_sides first dim must match batch size N={N} (or be 1 for broadcast), got {s.shape[0]}"
            )
        if s.shape[1] < P:
            raise ValueError(f"pulse_sides has P={s.shape[1]} pulses but simulator needs at least {P} for "
                             f"T_MAX={T_MAX}s")
        s = s[:, :P]

    sigma_a = torch.abs(theta[:, 4])
    sigma_s = torch.abs(theta[:, 6])
    # Sensory noise on the evidence stream: each pulse's effective side is s + sigma_s * eta.
    eta = torch.randn(s.shape, generator=make_generator(child_seed(seed, 2), dev), device=dev, dtype=torch.float32)
    s_eff = s + sigma_s[:, None] * eta
    theta5 = theta[:, [0, 1, 2, 3, 5]]
    run = dispatch_sim_kernel()
    return run(theta5, s_eff, child_seed(seed, 0), mu_sensory=sigma_a, collapse_rate=float(collapse_rate),
               steps_per_pulse=spp, n_max=n_max)


def simulate_session_data_7p(
    theta_true: ArrayLike,
    num_trials: int,
    rng=None,
    *,
    p_success: float = cfg.P_SUCCESS,
    return_pulse_sides: bool = False,
    device=None,
):
    """IID session under one 7-parameter theta: (num_trials, 2) [rt,
    choice]; with ``return_pulse_sides=True`` also the (num_trials, P)
    stimulus (before the sensory noise). On ``device`` (default: theta's
    device, the CUDA card for numpy input)."""
    seed = as_seed(rng)
    theta_true = _as_f32(theta_true, device).reshape(1, -1)
    dev = theta_true.device
    theta_rep = theta_true.expand(int(num_trials), theta_true.shape[1])
    n_max, spp = pulse_schedule()
    P = n_pulses_max_from_schedule(n_max, spp)
    pulses = generate_pulse_matrix(make_generator(child_seed(seed, 7), dev), int(num_trials), P, p_success=p_success)
    x = rt_choice_model_simulator_7p(theta_rep, rng=child_seed(seed, 8), pulse_sides=pulses)
    if return_pulse_sides:
        return x, pulses
    return x
