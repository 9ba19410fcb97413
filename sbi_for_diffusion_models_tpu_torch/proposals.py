"""Training proposals over z = [theta, pulse_sides] (PyTorch port).

Counterpart of ``sbi_for_diffusion_models_tpu/proposals.py``.
``PulseSequenceProposal`` samples stimulus matrices s in {+1,-1}^P and
reports ``log_prob = 0`` on purpose: only sampling is needed for MNLE
training and the constant cancels in the posterior. ``ExtendedProposal``
is the product over the 5+P-dim z. Sampling draws from the
``torch.Generator`` it is given, on that generator's device; without one
it consumes the proposal's own seeded stream (as the JAX proposals do
without a key), on the proposal's ``device`` (default: the CUDA card).
"""

from __future__ import annotations

import torch

from .distributions import Distribution, Support, real_support
from .run_config import RUN_CONFIG_PARAMS
from .utils.device import resolve_device
from .utils.rng import child_seed, make_generator

__all__ = ["PulseSequenceProposal", "ExtendedProposal"]


class PulseSequenceProposal(Distribution):
    """Pulse-side sequences s in {+1,-1}^P: per trial a correct side is drawn
    +-1 with p=0.5; each pulse matches it with probability ``p_success``."""

    def __init__(self, n_pulses: int, p_success: float = RUN_CONFIG_PARAMS.P_SUCCESS,
                 seed: int | None = 0, *, device=None):
        self.n_pulses = int(n_pulses)
        self.p_success = float(p_success)
        self.event_shape = (self.n_pulses,)
        self.seed = seed
        self.device = resolve_device(device)
        self._counter = 0

    def _owned_generator(self, tag: int) -> torch.Generator:
        g = make_generator(child_seed(self.seed, tag + self._counter), self.device)
        self._counter += 1
        return g

    def sample(self, generator: torch.Generator | None = None, sample_shape=()):
        if generator is None:
            generator = self._owned_generator(0)
        n = 1
        for d in sample_shape:
            n *= int(d)
        dev = generator.device
        correct = torch.where(
            torch.rand((n, 1), generator=generator, device=dev) < 0.5, 1.0, -1.0
        )
        match = torch.rand((n, self.n_pulses), generator=generator, device=dev) < self.p_success
        s = torch.where(match, correct, -correct).to(torch.float32)
        return s.reshape(tuple(sample_shape) + (self.n_pulses,))

    def log_prob(self, value):
        """Intentionally 0: constant in theta, cancels in the posterior."""
        return torch.zeros(value.shape[:-1], dtype=torch.float32, device=value.device)

    def supports(self) -> list[Support]:
        return [real_support() for _ in range(self.n_pulses)]


class ExtendedProposal(Distribution):
    """Product proposal over z = [theta (5), pulse_sides (P)]."""

    def __init__(self, theta_prior: Distribution, pulse_proposal: PulseSequenceProposal):
        self.theta_prior = theta_prior
        self.pulse_proposal = pulse_proposal
        self.theta_dim = theta_prior.event_dim
        self.event_shape = (self.theta_dim + pulse_proposal.n_pulses,)

    def sample(self, generator: torch.Generator | None = None, sample_shape=()):
        if generator is None:
            generator = self.pulse_proposal._owned_generator(10_000)
        theta = self.theta_prior.sample(generator, sample_shape)
        pulses = self.pulse_proposal.sample(generator, sample_shape)
        return torch.cat([theta, pulses], dim=-1)

    def log_prob(self, z):
        theta = z[..., : self.theta_dim]
        pulses = z[..., self.theta_dim :]
        return self.theta_prior.log_prob(theta) + self.pulse_proposal.log_prob(pulses)

    def supports(self) -> list[Support]:
        return self.theta_prior.supports() + self.pulse_proposal.supports()
