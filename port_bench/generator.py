"""The benchmark's own traffic: prior draws, stimuli and simulated trials.

Every input a cell hands the port is made here from the run's seed, on the
run's device, with ``torch.Generator``s: the parameter draws, the click
stimuli and the trials of the pulse drift-diffusion model. The simulator is
a plain Euler-Maruyama scan written from the model's equations (the port's
own simulator is not used to make inputs):

* the accumulator starts at a0 * B and moves a += -lam * a * dt + sigma *
  sqrt(dt) * eps each step of dt = 0.5 ms, with a kick v * s_p at the first
  step of pulse p (every 100 ms);
* it stops at the first step where a >= B (choice 1) or a <= 0 (choice 0);
  a trial that reaches the end of its window, 8 s - t_nd, is censored
  (choice 2, rt 8 s);
* rt = t_nd + steps * dt.

The prior is the pipeline's: a0 ~ Beta(2, 2), lam ~ LogNormal(-1, 1),
v ~ LogNormal(0, 1), B ~ LogNormal(2.75, 0.5), t_nd ~ Beta(2, 2) (a
Beta(2, 2) draw is the median of three uniforms). Each pulse matches the
trial's correct side, drawn 50/50, with probability 0.75.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

__all__ = ["DT", "T_MAX", "PULSE_STEPS", "N_PULSES", "child", "generator", "prior_draws", "stimuli", "simulate",
           "sessions", "training_pairs", "load_mix"]

DT = 5e-4
T_MAX = 8.0
PULSE_STEPS = 200
N_PULSES = 80
P_SUCCESS = 0.75
SIGMA = 1.0
_ROOT = Path(__file__).resolve().parent
_MASK = (1 << 63) - 1


def child(seed: int, *tags: int) -> int:
    """A 63-bit seed derived from ``seed`` and the tags (splitmix64 steps)."""
    s = int(seed) & _MASK
    for t in tags:
        x = (s ^ ((int(t) * 0x9E3779B97F4A7C15) & ((1 << 64) - 1))) & ((1 << 64) - 1)
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
        s = (x ^ (x >> 31)) & _MASK
    return s


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & _MASK)
    return g


def prior_draws(gen: torch.Generator, n: int) -> torch.Tensor:
    """(n, 5) float32 draws of theta = (a0, lam, v, B, t_nd) from the prior."""
    dev = gen.device
    u = torch.rand((2, n, 3), generator=gen, device=dev).median(-1).values  # Beta(2, 2), twice
    z = torch.randn((3, n), generator=gen, device=dev)
    mu = torch.tensor([-1.0, 0.0, 2.75], device=dev)[:, None]
    sd = torch.tensor([1.0, 1.0, 0.5], device=dev)[:, None]
    lognormal = torch.exp(mu + sd * z)
    return torch.stack([u[0], lognormal[0], lognormal[1], lognormal[2], u[1]], -1).to(torch.float32)


def stimuli(gen: torch.Generator, n: int) -> torch.Tensor:
    """(n, 80) click sides in {+1, -1}."""
    dev = gen.device
    correct = torch.where(torch.rand((n, 1), generator=gen, device=dev) < 0.5, 1.0, -1.0)
    match = torch.rand((n, N_PULSES), generator=gen, device=dev) < P_SUCCESS
    return torch.where(match, correct, -correct)


def simulate(gen: torch.Generator, theta: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(n, 2) float32 trials (rt, choice) of theta (n, 5) under stimuli s (n, 80).
    Time runs in blocks of one pulse interval; the trials still running are
    gathered at each block's start, so the work shrinks as trials end."""
    dev = theta.device
    n = theta.shape[0]
    a0 = theta[:, 0].clamp(0.0, 1.0)
    lam, v = theta[:, 1], theta[:, 2].abs()
    bound = theta[:, 3].abs().clamp(min=1e-6)
    tnd = theta[:, 4].clamp(0.0, T_MAX - 1e-6)
    n_max = int(round(T_MAX / DT))
    n_steps = torch.clamp(torch.floor((T_MAX - tnd) / DT), 0, n_max).to(torch.int64)
    a = a0 * bound
    hit_step = n_steps.clone()
    choice = torch.full((n,), 2, dtype=torch.int64, device=dev)
    scale = SIGMA * math.sqrt(DT)
    live = torch.arange(n, device=dev)
    for block in range(n_max // PULSE_STEPS):
        t0 = block * PULSE_STEPS
        live = live[n_steps[live] > t0]
        if live.numel() == 0:
            break
        eps = torch.randn((PULSE_STEPS, live.numel()), generator=gen, device=dev) * scale
        al, laml, bl, nl = a[live], lam[live], bound[live], n_steps[live]
        kick = v[live] * s[live, block]
        done = torch.zeros(live.shape, dtype=torch.bool, device=dev)
        steps = torch.zeros(live.shape, dtype=torch.int64, device=dev)
        side = torch.zeros(live.shape, dtype=torch.int64, device=dev)
        for i in range(PULSE_STEPS):
            running = ~done & (nl > t0 + i)
            al = al + (-laml * al) * DT + eps[i]
            if i == 0:
                al = al + kick * running
            up, down = running & (al >= bl), running & (al <= 0.0)
            now = up | down
            steps = torch.where(now, t0 + i + 1, steps)
            side = torch.where(up, 1, torch.where(down, 0, side))
            done = done | now
        a[live] = al
        hit_step[live] = torch.where(done, steps, hit_step[live])
        choice[live] = torch.where(done, side, choice[live])
        live = live[~done]
    rt = torch.clamp(tnd + hit_step.to(torch.float32) * DT, 1e-6, T_MAX)
    return torch.stack([rt, choice.to(torch.float32)], -1)


def sessions(seed: int, count: int, trials: int, device):
    """``count`` observed sessions of ``trials`` trials, each at its own prior
    draw: (theta (count, 5), x (count, trials, 2), stimuli (count, trials, 80))."""
    gen = generator(seed, device)
    theta = prior_draws(gen, count)
    s = stimuli(gen, count * trials)
    x = simulate(gen, theta.repeat_interleave(trials, 0), s)
    return theta, x.reshape(count, trials, 2), s.reshape(count, trials, N_PULSES)


def training_pairs(seed: int, n: int, device):
    """``n`` training pairs: z = [theta, stimuli] (n, 85) and x (n, 2), one
    trial at each prior draw."""
    gen = generator(seed, device)
    theta = prior_draws(gen, n)
    s = stimuli(gen, n)
    return torch.cat([theta, s], -1), simulate(gen, theta, s)


def load_mix(name: str) -> dict:
    """The traffic mix ``traffic/<name>.json``."""
    return json.loads((_ROOT / "traffic" / f"{name}.json").read_text())
