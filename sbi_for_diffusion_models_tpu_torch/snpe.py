"""SNPE / SNLE: amortized posterior and likelihood estimation (PyTorch port).

Counterpart of ``sbi_for_diffusion_models_tpu/snpe.py`` with the same names:

* ``train_snpe`` fits q(theta | x) with a conditional coupling NSF
  (``nets/flows.py``) and returns a ``DirectPosterior``, whose ``sample``
  draws amortized posterior samples for an observation, re-drawing those
  outside the prior's support (bounded by ``max_tries``);
* ``train_snle`` fits q(x | theta) and returns ``(flow, make_posterior)``;
  ``make_posterior(x_o)`` is the port's ``MCMCPosterior`` over
  ``SNLEPotential``, the prior plus the flow's summed log-likelihood of the
  IID observations, sampled in the prior's ``mcmc_transform`` space.

Both are single-round (proposal = prior). They run on the device of their
tensor inputs, the CUDA card for other input, or on ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .distributions import Distribution, mcmc_transform
from .inference.mcmc import MCMCPosterior
from .nets.flows import FlowEstimator, NSFConfig, build_flow, fit_flow
from .run_config import RunConfig
from .utils.device import resolve_device
from .utils.rng import as_seed, child_seed, make_generator

__all__ = ["train_snpe", "train_snle", "DirectPosterior", "SNLEPotential"]


def _stats(a):
    return a.mean(0), torch.clamp(a.std(0, unbiased=False), min=1e-6)


def _inputs(theta, x, device):
    """theta and x as float32 tensors on ``device`` (default: theta's, the
    CUDA card for other input)."""
    if device is None:
        device = theta.device if isinstance(theta, torch.Tensor) else resolve_device(None)
    device = torch.device(device)
    return (torch.as_tensor(theta, dtype=torch.float32).to(device),
            torch.as_tensor(x, dtype=torch.float32).to(device), device)


@dataclass
class DirectPosterior:
    """Amortized q(theta | x) with prior-support rejection sampling."""

    flow: FlowEstimator
    prior: Distribution

    def log_prob(self, theta, x):
        return self.flow.log_prob(theta, x)

    def sample(self, sample_shape, x, *, generator=None, seed: int = 0, max_tries: int = 20):
        """``sample_shape[0]`` draws given one observation row x, on the
        flow's device. Draws outside the prior's support are drawn again, up
        to ``max_tries`` passes in all; any still outside are kept (as the
        JAX package does). Pass i draws from ``generator`` (a
        ``torch.Generator`` on the flow's device), else from
        ``child_seed(seed, i)``."""
        n = int(sample_shape[0])
        dev = self.flow.device
        x = torch.as_tensor(x, dtype=torch.float32).to(dev).reshape(1, -1)
        ctx = x.expand(n, x.shape[1])

        def gen(i):
            return generator if generator is not None else make_generator(child_seed(as_seed(seed), i), dev)

        def inside(theta):
            return torch.isfinite(self.prior.log_prob(theta))

        samples = self.flow.sample(gen(0), ctx)
        ok = inside(samples)
        for i in range(1, int(max_tries)):
            if bool(ok.all()):
                break
            fresh = self.flow.sample(gen(i), ctx)
            take = ~ok & inside(fresh)
            samples = torch.where(take[:, None], fresh, samples)
            ok = ok | take
        return samples


def _fit(cfg: RunConfig, y, context, *, hidden_features, num_transforms, num_bins, seed, verbose, device):
    y_mean, y_std = _stats(y)
    c_mean, c_std = _stats(context)
    flow_cfg = NSFConfig(dim=int(y.shape[1]), context_dim=int(context.shape[1]), hidden_features=hidden_features,
                         num_transforms=num_transforms, num_bins=num_bins)
    flow = build_flow(child_seed(as_seed(seed), 100), flow_cfg, device=device, y_mean=y_mean, y_std=y_std,
                      c_mean=c_mean, c_std=c_std)
    return fit_flow(flow, y, context, batch_size=min(cfg.TRAIN_BATCH_SIZE, y.shape[0]),
                    max_epochs=cfg.TRAIN_MAX_EPOCHS, patience=cfg.TRAIN_STOP_AFTER_EPOCHS,
                    learning_rate=cfg.TRAIN_LEARNING_RATE, seed=seed, verbose=verbose)


def train_snpe(
    cfg: RunConfig,
    prior: Distribution,
    theta,
    x,
    *,
    hidden_features: int = 64,
    num_transforms: int = 5,
    num_bins: int = 16,
    seed=0,
    verbose: bool = False,
    device=None,
) -> DirectPosterior:
    """Single-round SNPE (NPE): the maximum-likelihood fit of q(theta | x)
    (weights from ``child_seed(seed, 100)``, training streams from
    ``seed``); the cfg's TRAIN_* settings drive ``fit_flow``."""
    theta, x, device = _inputs(theta, x, device)
    flow = _fit(cfg, theta, x, hidden_features=hidden_features, num_transforms=num_transforms,
                num_bins=num_bins, seed=seed, verbose=verbose, device=device)
    return DirectPosterior(flow=flow, prior=prior)


class SNLEPotential:
    """The theta-potential of an SNLE likelihood over IID observations:
    log prior(theta) + sum_i log q(x_i | theta)."""

    def __init__(self, prior: Distribution, flow: FlowEstimator, x_o=None):
        self.prior = prior
        self.flow = flow
        self.x_o = None
        if x_o is not None:
            self.set_x_o(x_o)

    def set_x_o(self, x_o):
        self.x_o = torch.as_tensor(x_o, dtype=torch.float32).to(self.flow.device)

    def potential_fn(self, theta, x=None):
        """theta (D,) -> scalar, or (N, D) -> (N,); differentiable in
        theta. ``x`` (M, d) replaces the stored observations for this call."""
        x = self.x_o if x is None else torch.as_tensor(x, dtype=torch.float32).to(self.flow.device)
        squeeze = theta.dim() == 1
        th = theta.reshape(1, -1) if squeeze else theta
        N, M = th.shape[0], x.shape[0]
        ll = self.flow.log_prob_fn(self.flow.net, x[None].expand(N, M, x.shape[-1]),
                                   th[:, None].expand(N, M, th.shape[-1])).sum(-1)
        out = self.prior.log_prob(th) + ll
        return out[0] if squeeze else out


def train_snle(
    cfg: RunConfig,
    prior: Distribution,
    theta,
    x,
    *,
    hidden_features: int = 64,
    num_transforms: int = 5,
    num_bins: int = 16,
    seed=0,
    verbose: bool = False,
    device=None,
):
    """Single-round SNLE: the fit of q(x | theta). Returns ``(flow,
    make_posterior)``; ``make_posterior(x_o, method=None)`` is a ready
    ``MCMCPosterior`` (cfg's sampler settings, ``method`` overriding
    MCMC_METHOD) on the flow's device."""
    theta, x, device = _inputs(theta, x, device)
    flow = _fit(cfg, x, theta, hidden_features=hidden_features, num_transforms=num_transforms,
                num_bins=num_bins, seed=seed, verbose=verbose, device=device)

    def make_posterior(x_o, method: Optional[str] = None) -> MCMCPosterior:
        return MCMCPosterior(
            potential_fn=SNLEPotential(prior, flow, x_o=x_o),
            proposal=prior,
            theta_transform=mcmc_transform(prior),
            method=method or cfg.MCMC_METHOD,
            num_chains=cfg.NUM_CHAINS,
            warmup_steps=cfg.WARMUP_STEPS,
            thin=cfg.MCMC_THIN,
            max_tree_depth=cfg.MCMC_MAX_TREE_DEPTH,
            target_accept=cfg.MCMC_TARGET_ACCEPT,
            device=flow.device,
        )

    return flow, make_posterior
