"""Pulse-DDM Euler-Maruyama in plain PyTorch: the plain version of kernel K1.

Counterpart of ``sbi_for_diffusion_models_tpu/ops/ddm_scan.py``
(``sanitize_theta``, ``ddm_rt_choice_scan``) with the same semantics, step
for step:

* each step ``a += (-lam*a)*dt + sigma*sqrt(dt)*eps``, then the pulse kick
  ``a += v*s[:, t // steps_per_pulse]`` on pulse steps for active trials;
* absorbing bounds {0, B} (or collapsing, ``f(t) = 1/2 + exp(-c t)/2``)
  checked after both; the first hit records ``hit_step = t + 1``;
* trials that never hit are censored to choice 2 with ``hit_step =
  n_steps``; ``rt = clip(t_nd + hit_step*dt, 1e-6, t_max)``.

Time runs in pulse-aligned chunks; a chunk in which no trial is active is
skipped. The noise of chunk ``c`` comes from ``noise(c)``, a ``(chunk_steps,
n_total)`` block of standard normals for the whole batch, of which the
trials [trial_offset, trial_offset + N) take their columns (a rank's block
of a sharded run; padded trials past ``n_total`` take the last column). By
default it is drawn from a generator seeded with ``child_seed(seed, c)``, so
the stream does not depend on which chunks were skipped, nor a trial's
noise on how the batch is split. Tests inject the exact draws the JAX scan
kernel uses.

Every float constant is a float32 tensor on the trials' device, so each
step rounds exactly as the JAX kernels and the CUDA kernel K1 do (no scalar
reciprocal or double-precision shortcut inside PyTorch's elementwise ops).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from ..constants import DT_CHOICE, T_MAX
from ..utils.rng import child_seed, make_generator

__all__ = ["sanitize_theta", "ddm_rt_choice_scan", "ddm_choice_scan"]


def sanitize_theta(theta: torch.Tensor, t_max: float = float(T_MAX)):
    """(a0_frac, lam, v, B, t_nd) with the reference's sanitation: a0_frac
    clipped to [0, 1], |v|, B = max(|B|, 1e-6), t_nd clipped to
    [0, t_max - 1e-6]."""
    theta = theta.to(torch.float32)
    a0_frac = torch.clamp(theta[:, 0], 0.0, 1.0)
    lam = theta[:, 1]
    v = torch.abs(theta[:, 2])
    B = torch.clamp(torch.abs(theta[:, 3]), min=1e-6)
    t_nd = torch.clamp(theta[:, 4], 0.0, float(t_max) - 1e-6)
    return a0_frac, lam, v, B, t_nd


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def ddm_rt_choice_scan(
    theta: torch.Tensor,
    pulse_sides: torch.Tensor,
    seed: int = 0,
    *,
    mu_sensory: Union[float, torch.Tensor] = 1.0,
    collapse_rate: float = 0.0,
    dt: float = float(DT_CHOICE),
    t_max: float = float(T_MAX),
    steps_per_pulse: int = 200,
    chunk_steps: int = 200,
    n_max: Optional[int] = None,
    noise: Optional[Callable[[int], torch.Tensor]] = None,
    trial_offset: int = 0,
    n_total: Optional[int] = None,
) -> torch.Tensor:
    """Batched RT+choice pulse-DDM simulator.

    theta: (N, 5) [a0_frac, lam, v, B, t_nd]; pulse_sides: (N, P) in {+1,-1}
    (or real-valued, as the 7-parameter model's noisy pulses) with P >=
    n_max / steps_per_pulse; ``mu_sensory`` a float or a per-trial (N,)
    tensor (the 7-parameter model's sigma_a). Returns (N, 2) float32 [rt,
    choice], choice in {0., 1., 2.} (2 = censored), on theta's device.
    ``trial_offset`` / ``n_total`` (default 0 / N): these N trials are the
    block from ``trial_offset`` of a batch of ``n_total``.
    """
    if n_max is None:
        n_max = int(t_max / dt)
    if n_max % chunk_steps != 0:
        raise ValueError(f"n_max={n_max} must be divisible by chunk_steps={chunk_steps}")
    n_chunks = n_max // chunk_steps
    dev = theta.device
    a0_frac, lam, v, B, t_nd = sanitize_theta(theta, t_max)
    N = theta.shape[0]
    P = pulse_sides.shape[1]
    s = pulse_sides.to(device=dev, dtype=torch.float32)

    dtf = _f32(dt, dev)
    t_maxf = _f32(t_max, dev)
    n_steps = torch.clamp(torch.floor((t_maxf - t_nd) / dtf).to(torch.int32), 0, n_max)
    # sigma * sqrt(dt) in float32, as the JAX scan computes it (a scalar, or one a trial); sqrt(dt) is the
    # correctly rounded float32 root of float32(dt), rounded on the host as K1's wrapper rounds it.
    sigma_sqrt_dt = torch.as_tensor(mu_sensory, dtype=torch.float32, device=dev) * float(np.sqrt(np.float32(dt)))
    crate = _f32(collapse_rate, dev)
    n_total = N if n_total is None else int(n_total)
    cols = None  # the block's columns of the whole batch's noise; None: all of them
    if (trial_offset, n_total) != (0, N):
        cols = torch.clamp(torch.arange(trial_offset, trial_offset + N, device=dev), max=n_total - 1)
    if noise is None:
        def noise(c):
            g = make_generator(child_seed(seed, c), dev)
            return torch.randn((chunk_steps, n_total), generator=g, device=dev, dtype=torch.float32)

    a = a0_frac * B
    hit = torch.zeros((N,), dtype=torch.bool, device=dev)
    choice = torch.zeros((N,), dtype=torch.int32, device=dev)
    hit_step = torch.zeros((N,), dtype=torch.int32, device=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    upper, lower = B, torch.zeros_like(B)

    for c in range(n_chunks):
        t0 = c * chunk_steps
        if not bool(torch.any(~hit & (t0 < n_steps))):
            continue
        block = noise(c).to(device=dev, dtype=torch.float32)
        eps_block = (block if cols is None else block[:, cols]) * sigma_sqrt_dt
        for i in range(chunk_steps):
            t = t0 + i
            active = ~hit & (t < n_steps)
            a = a + (-lam * a) * dtf + eps_block[i]
            if t % steps_per_pulse == 0:
                kick = v * s[:, min(t // steps_per_pulse, P - 1)]
                a = a + kick * active.to(torch.float32)
            if collapse_rate != 0.0:
                f = 0.5 + 0.5 * torch.exp(-crate * (_f32(t, dev) * dtf))
                upper = B * f
                lower = B * (1.0 - f)
            hit_upper = active & (a >= upper)
            hit_lower = active & (a <= lower)
            newly = hit_upper | hit_lower
            hit_step = torch.where(newly, t + 1, hit_step)
            choice = torch.where(hit_upper, one, torch.where(hit_lower, zero, choice))
            hit = hit | newly

    hit_step = torch.where(hit, hit_step, n_steps)
    outcome = torch.where(hit, choice, torch.full_like(choice, 2))
    rt = torch.clamp(t_nd + hit_step.to(torch.float32) * dtf, 1e-6, float(t_max))
    return torch.stack([rt, outcome.to(torch.float32)], dim=-1)


def ddm_choice_scan(
    theta: torch.Tensor,
    seed: int = 0,
    *,
    mu_sensory: float = 1.0,
    p_success: float = 0.75,
    max_resamples: int = 0,
    dt: float = float(DT_CHOICE),
    t_max: float = float(T_MAX),
    steps_per_pulse: int = 200,
    chunk_steps: int = 200,
    n_max: Optional[int] = None,
) -> torch.Tensor:
    """Choice-only pulse-DDM: theta (N, 5) -> (N,) int32 choices in {-1, 0,
    1}, -1 where no bound was hit (censored, invalid).

    Counterpart of the JAX ``ddm_choice_scan``. Each pass draws its stimulus
    on theta's device (correct side 50/50 a trial, each pulse matching it
    with probability ``p_success``) and simulates through
    ``models/rt_choice_model.dispatch_sim_kernel()``: kernel K1 for CUDA
    tensors, this module's plain scan for CPU tensors. With
    ``max_resamples > 0`` up to that many more passes re-run the invalid
    trials alone, each with fresh noise and a fresh stimulus, and stop once
    none is left. Pass i (0 the first) draws from ``child_seed(seed, i)``.
    ``chunk_steps`` is checked as JAX checks it (it must divide ``n_max``);
    the simulator keeps its own noise blocks (K1 has none), which changes
    the stream and not the distribution.
    """
    from ..models.rt_choice_model import dispatch_sim_kernel, generate_pulse_matrix

    if n_max is None:
        n_max = int(t_max / dt)
    if n_max % chunk_steps != 0:
        raise ValueError(f"n_max={n_max} must be divisible by chunk_steps={chunk_steps}")
    dev = theta.device
    N = theta.shape[0]
    P = -(-n_max // steps_per_pulse)
    run = dispatch_sim_kernel()

    def one_pass(th, pass_seed: int) -> torch.Tensor:
        s = generate_pulse_matrix(make_generator(child_seed(pass_seed, 1), dev), th.shape[0], P, p_success=p_success)
        x = run(th, s, child_seed(pass_seed, 0), mu_sensory=float(mu_sensory), collapse_rate=0.0,
                steps_per_pulse=steps_per_pulse, n_max=n_max, dt=dt, t_max=t_max)
        out = x[:, 1].to(torch.int32)
        return torch.where(out == 2, torch.full_like(out, -1), out)

    out = one_pass(theta, child_seed(seed, 0)) if N else torch.zeros((0,), dtype=torch.int32, device=dev)
    for i in range(int(max_resamples)):
        invalid = torch.nonzero(out < 0).reshape(-1)
        if invalid.numel() == 0:
            break
        out[invalid] = one_pass(theta[invalid], child_seed(seed, i + 1))
    return out
