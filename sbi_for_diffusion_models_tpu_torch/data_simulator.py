"""Training-set and observed-session generation (PyTorch port).

Counterpart of ``sbi_for_diffusion_models_tpu/data_simulator.py``:
``sim_wrapper``, ``simulate_training_set_with_conditions``,
``simulate_observed_session`` and ``summarize_trials``. Everything stays on
``device``; batching only bounds device memory. The invariant checks
(finite outputs, choice in {0, 1, 2}) raise on failure.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .models.rt_choice_model import (
    generate_pulse_matrix,
    n_pulses_max_from_schedule,
    pack_x_rt_choice,
    pulse_schedule,
    rt_choice_model_simulator_torch,
)
from .run_config import RUN_CONFIG_PARAMS, RunConfig
from .utils.device import resolve_device
from .utils.rng import as_seed, child_seed, make_generator

__all__ = [
    "sim_wrapper",
    "simulate_training_set_with_conditions",
    "simulate_observed_session",
    "summarize_trials",
]


def sim_wrapper(
    z: torch.Tensor,
    *,
    theta_dim: int = 5,
    n_pulses: Optional[int] = None,
    mu_sensory: float = RUN_CONFIG_PARAMS.MU_SENSORY,
    log_rt: bool = RUN_CONFIG_PARAMS.LOG_RT_MANUALLY,
    rng=None,
) -> torch.Tensor:
    """Split z = [theta, pulses] -> simulate -> pack x."""
    if n_pulses is None:
        n_pulses = n_pulses_max_from_schedule(*pulse_schedule())
    theta = z[:, :theta_dim]
    pulses = z[:, theta_dim : theta_dim + n_pulses]
    x = rt_choice_model_simulator_torch(theta, rng=rng, mu_sensory=mu_sensory, pulse_sides=pulses)
    return pack_x_rt_choice(x, log_rt=log_rt)


def _check_outputs(x: torch.Tensor) -> None:
    if not bool(torch.isfinite(x).all()):
        raise RuntimeError("non-finite simulator outputs")
    c = x[:, 1]
    if not bool(((c == 0) | (c == 1) | (c == 2)).all()):
        raise RuntimeError("choice outside {0,1,2}")


def simulate_training_set_with_conditions(
    cfg: RunConfig,
    proposal,
    *,
    num_simulations: Optional[int] = None,
    batch_size: Optional[int] = None,
    device=None,
    seed: int = 0,
    verbose: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Simulate (z, x) training pairs on ``device`` (default: the CUDA card).

    Returns z: (N, 5+P) float32 and x: (N, 2) float32 [rt, choice].
    Batch b draws z from ``child_seed(seed, 2b)`` and the noise from
    ``child_seed(seed, 2b+1)``.
    """
    device = resolve_device(device)
    num_simulations = int(num_simulations or cfg.NUM_SIMULATIONS)
    batch_size = int(batch_size or cfg.TRAIN_BATCH_SIZE)
    seed = as_seed(seed)
    zs, xs = [], []
    n_batches = -(-num_simulations // batch_size)
    for b in range(n_batches):
        start = b * batch_size
        bs = min(batch_size, num_simulations - start)
        z = proposal.sample(make_generator(child_seed(seed, 2 * b), device), (bs,))
        x = sim_wrapper(
            z, mu_sensory=cfg.MU_SENSORY, log_rt=cfg.LOG_RT_MANUALLY, rng=child_seed(seed, 2 * b + 1)
        )
        zs.append(z)
        xs.append(x)
        if verbose and (b % 50 == 0 or b == n_batches - 1):
            print(f"[simulate] batch {b + 1}/{n_batches} ({start + bs}/{num_simulations} trials)")
    z_all = torch.cat(zs, dim=0)
    x_all = torch.cat(xs, dim=0)
    _check_outputs(x_all)
    return z_all, x_all


def simulate_observed_session(
    theta_true,
    num_trials: int,
    *,
    mu_sensory: float = RUN_CONFIG_PARAMS.MU_SENSORY,
    p_success: float = RUN_CONFIG_PARAMS.P_SUCCESS,
    log_rt: bool = RUN_CONFIG_PARAMS.LOG_RT_MANUALLY,
    seed: int = 123,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Seeded observed session: (x_o (T, 2), pulses_o (T, P)) on ``device``
    (default: theta_true's device, the CUDA card for numpy input)."""
    seed = as_seed(seed)
    if isinstance(theta_true, torch.Tensor):
        device = theta_true.device if device is None else torch.device(device)
        theta_true = theta_true.to(device=device, dtype=torch.float32)
    else:
        device = resolve_device(device)
        theta_true = torch.as_tensor(np.asarray(theta_true, np.float32), device=device)
    theta_true = theta_true.reshape(1, -1)
    n_max, spp = pulse_schedule()
    P = n_pulses_max_from_schedule(n_max, spp)
    pulses_o = generate_pulse_matrix(
        make_generator(child_seed(seed, 0), device), int(num_trials), P, p_success=p_success
    )
    theta_rep = theta_true.expand(int(num_trials), theta_true.shape[1])
    x = rt_choice_model_simulator_torch(
        theta_rep, rng=child_seed(seed, 1), mu_sensory=mu_sensory, pulse_sides=pulses_o
    )
    return pack_x_rt_choice(x, log_rt=log_rt), pulses_o


def summarize_trials(name: str, x) -> None:
    """Print-based diagnostics."""
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    n = x.shape[0]
    rt = x[:, 0]
    choice = x[:, 1].astype(np.int64)
    counts = np.bincount(choice, minlength=3)
    fracs = counts / max(n, 1)
    print(
        f"[{name}] n={n} rt[min={rt.min():.4f}, max={rt.max():.4f}] "
        f"choices: 0={counts[0]} ({fracs[0]:.2%}), 1={counts[1]} ({fracs[1]:.2%}), "
        f"2={counts[2]} ({fracs[2]:.2%})"
    )
