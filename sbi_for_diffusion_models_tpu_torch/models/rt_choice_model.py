"""RT+choice pulse-DDM: public API (PyTorch port).

Counterpart of ``sbi_for_diffusion_models_tpu/models/rt_choice_model.py``
with the same names and output conventions. The simulator runs kernel K1
(``ops/ddm_cuda.py``) on CUDA tensors and its plain version
(``ops/ddm_scan.py``) on CPU tensors. Every entry takes ``device=``; inputs
may be numpy arrays or tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..constants import DT_CHOICE, PULSE_INTERVAL, T_MAX
from ..ops.ddm_cuda import ddm_rt_choice_cuda
from ..ops.ddm_scan import ddm_rt_choice_scan
from ..run_config import RUN_CONFIG_PARAMS
from ..utils.device import resolve_device
from ..utils.rng import as_seed, child_seed, make_generator

cfg = RUN_CONFIG_PARAMS

ArrayLike = Union[np.ndarray, torch.Tensor]

__all__ = [
    "RTChoiceModelParams",
    "dispatch_sim_kernel",
    "pulse_schedule",
    "n_pulses_max_from_schedule",
    "generate_pulse_matrix_numpy",
    "generate_pulse_matrix",
    "as_pulse_tensor",
    "rt_choice_model_simulator",
    "rt_choice_model_simulator_torch",
    "simulate_session_data_rt_choice",
    "pack_x_rt_choice",
]


def dispatch_sim_kernel(sim_kernel: Optional[str] = None):
    """Pick the simulator (cfg.SIM_KERNEL: "auto" | "scan" | "pallas").

    "pallas" and "auto" give the K1 wrapper, which launches the CUDA kernel
    for CUDA tensors and runs the plain version for CPU tensors; "scan"
    gives the plain version on any device. The returned ``run(theta, s,
    seed, *, mu_sensory, collapse_rate, steps_per_pulse, n_max, dt=DT_CHOICE,
    t_max=T_MAX)`` takes ``mu_sensory`` as a float or an (N,) tensor.
    """
    choice = sim_kernel or cfg.SIM_KERNEL
    if choice not in ("auto", "scan", "pallas"):
        raise ValueError(f"unknown sim kernel {choice!r}")
    if choice in ("auto", "pallas"):
        def run(theta, s, seed, *, mu_sensory, collapse_rate, steps_per_pulse, n_max,
                dt=float(DT_CHOICE), t_max=float(T_MAX)):
            return ddm_rt_choice_cuda(
                theta, s, seed, mu_sensory=mu_sensory, collapse_rate=collapse_rate,
                dt=dt, t_max=t_max, steps_per_pulse=steps_per_pulse, n_max=n_max,
            )
        return run

    def run(theta, s, seed, *, mu_sensory, collapse_rate, steps_per_pulse, n_max,
            dt=float(DT_CHOICE), t_max=float(T_MAX)):
        return ddm_rt_choice_scan(
            theta, s, seed, mu_sensory=mu_sensory, collapse_rate=collapse_rate, dt=dt, t_max=t_max,
            steps_per_pulse=steps_per_pulse,
            chunk_steps=min(cfg.SIM_CHUNK_STEPS, steps_per_pulse), n_max=n_max,
        )
    return run


@dataclass(frozen=True)
class RTChoiceModelParams:
    """Named scalar parameters [a0, lam, v, B, t_nd]."""

    a0_frac: float
    lam: float
    v: float
    B: float
    t_nd: float

    @staticmethod
    def from_theta(theta) -> "RTChoiceModelParams":
        """From a 5-vector (numpy or tensor), sanitised as the simulator
        sees it: B = max(|B|, 1e-6) (1 if not finite), a0 clipped to [0, 1]
        (0.5 if not finite), lam and v 0 if not finite, t_nd clipped to [0,
        T_MAX - 1e-6] (0 if not finite)."""
        if isinstance(theta, torch.Tensor):
            theta = theta.detach().cpu().numpy()
        theta = np.asarray(theta)
        if theta.shape[-1] != 5:
            raise ValueError(f"Expected theta with 5 params [a0, lam, v, B, t_nd], got shape {theta.shape}.")
        a0, lam, v, B, t_nd = np.asarray(theta, dtype=np.float64)
        B = float(abs(B)) if np.isfinite(B) else 1.0
        B = max(B, 1e-6)
        a0 = float(np.clip(a0, 0.0, 1.0)) if np.isfinite(a0) else 0.5
        lam = float(lam) if np.isfinite(lam) else 0.0
        v = float(v) if np.isfinite(v) else 0.0
        t_nd = float(t_nd) if np.isfinite(t_nd) else 0.0
        t_nd = float(np.clip(t_nd, 0.0, float(T_MAX) - 1e-6))
        return RTChoiceModelParams(a0_frac=a0, lam=lam, v=v, B=B, t_nd=t_nd)


def pulse_schedule(*, dt: float = float(DT_CHOICE)) -> Tuple[int, int]:
    """(n_max, steps_per_pulse) for the time grid."""
    n_max = int(np.floor(float(T_MAX) / float(dt)))
    steps_per_pulse = max(int(np.round(float(PULSE_INTERVAL) / float(dt))), 1)
    return n_max, steps_per_pulse


def n_pulses_max_from_schedule(n_max: int, steps_per_pulse: int) -> int:
    """Max pulse slots for a trial of n_max steps."""
    return (int(n_max) + int(steps_per_pulse) - 1) // int(steps_per_pulse)


def generate_pulse_matrix_numpy(
    rng: np.random.Generator, n_trials: int, n_pulses: int, *, p_success: float = cfg.P_SUCCESS
) -> np.ndarray:
    """Host-side stimulus matrix s in {+1,-1}^(n_trials, n_pulses): correct
    side 50/50 per trial, each pulse matches it with probability p_success."""
    if n_trials < 0:
        raise ValueError("n_trials must be >= 0")
    if n_pulses < 0:
        raise ValueError("n_pulses must be >= 0")
    p = float(np.clip(p_success, 0.0, 1.0))
    correct = np.where(rng.random(n_trials) < 0.5, 1.0, -1.0).astype(np.float32)
    match = rng.random((n_trials, n_pulses)) < p
    return np.where(match, correct[:, None], -correct[:, None]).astype(np.float32)


def generate_pulse_matrix(
    generator: torch.Generator, n_trials: int, n_pulses: int, *, p_success: float = cfg.P_SUCCESS
) -> torch.Tensor:
    """Device-side stimulus matrix (same distribution), drawn from
    ``generator`` on its device."""
    dev = generator.device
    correct = torch.where(torch.rand((n_trials, 1), generator=generator, device=dev) < 0.5, 1.0, -1.0)
    match = torch.rand((n_trials, n_pulses), generator=generator, device=dev) < p_success
    return torch.where(match, correct, -correct).to(torch.float32)


def _as_f32(x: ArrayLike, device=None) -> torch.Tensor:
    """A float32 tensor on ``device``: by default a tensor's own device, and
    the CUDA card for other input."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=resolve_device(device))


def as_pulse_tensor(pulse_sides: ArrayLike, *, device=None) -> torch.Tensor:
    """Normalize pulse_sides to a (N, P) float32 tensor."""
    s = _as_f32(pulse_sides, device)
    if s.dim() == 1:
        s = s.reshape(1, -1)
    if s.dim() != 2:
        raise ValueError(f"pulse_sides must have shape (N,P) or (P,), got {tuple(s.shape)}")
    return s


def _simulate_rt_choice_batch(
    theta: torch.Tensor,
    *,
    mu_sensory: float,
    pulse_sides: Optional[ArrayLike] = None,
    p_success: float = cfg.P_SUCCESS,
    rng=None,
    collapse_rate: float = 0.0,
) -> torch.Tensor:
    """theta (N, 5) -> (N, 2) [rt, choice]. Without ``pulse_sides`` the
    stimulus is drawn here; a single stimulus row broadcasts over the batch
    and any extra tail is dropped."""
    N = theta.shape[0]
    n_max, steps_per_pulse = pulse_schedule()
    n_pulses_max = n_pulses_max_from_schedule(n_max, steps_per_pulse)
    seed = as_seed(rng)
    if pulse_sides is None:
        s = generate_pulse_matrix(
            make_generator(child_seed(seed, 1), theta.device), N, n_pulses_max, p_success=p_success
        )
    else:
        s = as_pulse_tensor(pulse_sides, device=theta.device)
        if s.shape[0] == 1 and N > 1:
            s = s.expand(N, s.shape[1])
        if s.shape[0] != N:
            raise ValueError(
                f"pulse_sides first dim must match batch size N={N} (or be 1 for broadcast), got {s.shape[0]}"
            )
        if s.shape[1] < n_pulses_max:
            raise ValueError(
                f"pulse_sides has P={s.shape[1]} pulses but simulator needs at least "
                f"{n_pulses_max} for T_MAX={T_MAX}s"
            )
        s = s[:, :n_pulses_max]
    run = dispatch_sim_kernel()
    return run(
        theta, s, child_seed(seed, 0), mu_sensory=float(mu_sensory),
        collapse_rate=float(collapse_rate), steps_per_pulse=steps_per_pulse, n_max=n_max,
    )


def rt_choice_model_simulator(
    theta,
    rng=None,
    *,
    mu_sensory: float = 1.0,
    pulse_sides: Optional[ArrayLike] = None,
    p_success: float = cfg.P_SUCCESS,
    device=None,
) -> tuple[float, int]:
    """Single-trial API: (rt, choice) as Python numbers for one theta (5,),
    simulated through ``dispatch_sim_kernel`` (K1 on the card) on ``device``
    (default: theta's device, the CUDA card for numpy input)."""
    th = _as_f32(theta, device).reshape(1, 5)
    x = _simulate_rt_choice_batch(th, mu_sensory=float(mu_sensory), pulse_sides=pulse_sides,
                                  p_success=float(p_success), rng=rng)
    return float(x[0, 0]), int(x[0, 1])


def rt_choice_model_simulator_torch(
    theta: ArrayLike,
    rng=None,
    *,
    mu_sensory: float = 1.0,
    pulse_sides: Optional[ArrayLike] = None,
    p_success: float = cfg.P_SUCCESS,
    collapse_rate: float = 0.0,
    device=None,
) -> torch.Tensor:
    """Batched simulator: theta (N,5) or (5,) -> (N,2) float32 [rt, choice]
    on ``device`` (default: theta's device, the CUDA card for numpy input)."""
    theta = _as_f32(theta, device)
    if theta.dim() == 1:
        theta = theta.reshape(1, -1)
    if theta.shape[-1] != 5:
        raise ValueError(f"Expected theta shape (N,5) or (5,), got {tuple(theta.shape)}")
    return _simulate_rt_choice_batch(
        theta, mu_sensory=float(mu_sensory), pulse_sides=pulse_sides,
        p_success=float(p_success), rng=rng, collapse_rate=collapse_rate,
    )


def simulate_session_data_rt_choice(
    theta_true: ArrayLike,
    num_trials: int,
    rng=None,
    *,
    mu_sensory: float = 1.0,
    pulse_sides: Optional[ArrayLike] = None,
    p_success: float = cfg.P_SUCCESS,
    return_pulse_sides: bool = False,
    device=None,
):
    """IID session: (num_trials, 2) [rt, choice]; with
    ``return_pulse_sides=True`` also the realized (num_trials, P) stimulus.
    On ``device`` (default: theta_true's device, the CUDA card for numpy
    input)."""
    seed = as_seed(rng)
    theta_true = _as_f32(theta_true, device).reshape(1, -1)
    dev = theta_true.device
    theta_rep = theta_true.expand(num_trials, theta_true.shape[1])
    if pulse_sides is None:
        n_max, steps_per_pulse = pulse_schedule()
        P = n_pulses_max_from_schedule(n_max, steps_per_pulse)
        pulse_sides = generate_pulse_matrix(
            make_generator(child_seed(seed, 7), dev), num_trials, P, p_success=p_success
        )
    x = rt_choice_model_simulator_torch(
        theta_rep, rng=child_seed(seed, 8), mu_sensory=mu_sensory,
        pulse_sides=pulse_sides, p_success=p_success,
    )
    if return_pulse_sides:
        return x, as_pulse_tensor(pulse_sides, device=dev)
    return x


def pack_x_rt_choice(rt_choice: ArrayLike, *, log_rt: bool, device=None) -> torch.Tensor:
    """Pack to the MNLE x-convention: continuous column first, discrete last;
    RT clamped then optionally logged, choice never logged."""
    rt_choice = _as_f32(rt_choice, device)
    rt = torch.clamp(rt_choice[:, 0:1], min=1e-6)
    if log_rt:
        rt = torch.log(rt)
    return torch.cat([rt, rt_choice[:, 1:2]], dim=1)
