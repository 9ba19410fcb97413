"""Choice-only pulse-DDM (PyTorch port).

Counterpart of ``sbi_for_diffusion_models_tpu/models/choice_model.py`` with
the same names: the model emits only the choice, in {-1 (invalid: no bound
hit), 0, 1}, with optional re-simulation of invalid trials. It is the
simulator of the SNPE/SNLE workflow (``snpe.py``). The batch runs through
``ops/ddm_scan.ddm_choice_scan``: kernel K1 on the card, the plain scan on
the CPU. The random streams are the port's own (``utils/rng``), so outputs
agree with the JAX package's in distribution, and exactly without noise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import numpy as np
import torch

from ..ops.ddm_scan import ddm_choice_scan
from ..run_config import RUN_CONFIG_PARAMS
from ..utils.rng import as_seed
from .rt_choice_model import RTChoiceModelParams, _as_f32

cfg = RUN_CONFIG_PARAMS

ArrayLike = Union[np.ndarray, torch.Tensor]

__all__ = ["ChoiceModelParams", "generate_pulse_sides", "choice_model_simulator", "choice_model_simulator_torch"]


@dataclass(frozen=True)
class ChoiceModelParams:
    """Named scalar parameters [a0, lam, v, B, t_nd]."""

    a0_frac: float
    lam: float
    v: float
    B: float
    t_nd: float

    @staticmethod
    def from_theta(theta) -> "ChoiceModelParams":
        """From a 5-vector (numpy or tensor), sanitised as
        ``RTChoiceModelParams.from_theta`` (and the JAX package) does."""
        return ChoiceModelParams(**RTChoiceModelParams.from_theta(theta).__dict__)


def generate_pulse_sides(rng: np.random.Generator, n_pulses: int, *, p_success: float = cfg.P_SUCCESS) -> np.ndarray:
    """One trial's stimulus s in {+1,-1}^n_pulses on the host: the correct
    side 50/50, each pulse matching it with probability p_success (the JAX
    package's draws from the same generator)."""
    if n_pulses <= 0:
        return np.zeros((0,), dtype=np.float32)
    p_success = float(np.clip(p_success, 0.0, 1.0))
    correct_side = 1.0 if rng.random() < 0.5 else -1.0
    is_correct = rng.random(size=n_pulses) < p_success
    return np.where(is_correct, correct_side, -correct_side).astype(np.float32)


def choice_model_simulator(
    theta,
    rng,
    *,
    mu_sensory: float = 1.0,
    p_success: float = cfg.P_SUCCESS,
    device=None,
) -> int:
    """Single-trial API: the choice in {-1, 0, 1} as a Python int for one
    theta (5,), on ``device`` (default: theta's device, the CUDA card for
    numpy input)."""
    th = _as_f32(theta, device).reshape(1, 5)
    out = ddm_choice_scan(th, as_seed(rng), mu_sensory=float(mu_sensory), p_success=float(p_success))
    return int(out[0])


def choice_model_simulator_torch(
    theta: ArrayLike,
    rng=None,
    *,
    mu_sensory: float = 1.0,
    p_success: float = cfg.P_SUCCESS,
    resample_invalid: bool = False,
    max_resamples: int = 50,
    device=None,
) -> torch.Tensor:
    """Batched choice-only simulator: theta (N, 5) or (5,) -> (N, 1)
    float32 in {0., 1.} (-1. invalid) on ``device`` (default: theta's
    device, the CUDA card for numpy input). With ``resample_invalid=True``
    invalid trials are re-run with fresh noise and stimulus, up to
    ``max_resamples`` passes. The time grid is ``ddm_choice_scan``'s
    default; call that for another."""
    theta = _as_f32(theta, device)
    if theta.dim() == 1:
        theta = theta.reshape(1, -1)
    if theta.shape[-1] != 5:
        raise ValueError(f"Expected theta shape (N,5) or (5,), got {tuple(theta.shape)}")
    out = ddm_choice_scan(
        theta, as_seed(rng), mu_sensory=float(mu_sensory), p_success=float(p_success),
        max_resamples=int(max_resamples) if resample_invalid else 0,
    )
    return out.to(torch.float32).reshape(-1, 1)
