"""Hierarchical multi-subject pulse-DDM (PyTorch port): per-subject theta
under a population prior, with joint NUTS over (population, subjects).

Counterpart of ``sbi_for_diffusion_models_tpu/models/hierarchical.py`` with
the same model, names and outputs. Non-centered, in the unconstrained space
of the single-subject prior's ``mcmc_transform`` bijection:

    mu_d      ~ Normal(m0_d, s0_d)          population location, d = 1..D
    log tau_d ~ Normal(lt0_d, st0_d)        population scale
    eps_sd    ~ Normal(0, 1)                subject offsets
    u_sd      = mu_d + tau_d * eps_sd
    theta_s   = bijector.forward(u_s)
    x_s       ~ MNLE likelihood conditioned on (theta_s, pulses_s)

The joint vector is q = [mu (D), log_tau (D), eps (S*D)].

Where the JAX package ``vmap``s the potential over chains and sums one
batched log-prob call over the S*T rows of each, the port folds every
(chain row, subject) pair into the "sessions" of
``potentials.ConditionedMNLELogLikelihood``, as the SBC fold does: the
stimuli and data of the B*S (dataset, subject) sessions are held once, and
a potential call over N chain rows is ONE K3 launch over N*S*T rows (K2
without the gradient; one per member for an ensemble). The likelihood's
gradient in theta comes in closed form from that launch and is carried
through the bijector, its Jacobian and u = mu + tau * eps by hand, so the
sampler's value and gradient need no autograd.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from functools import partial
from typing import Optional

import torch

from ..distributions import Distribution, mcmc_transform
from ..utils import metrics
from ..utils.device import resolve_device
from ..utils.rng import as_seed, child_seed, make_generator

__all__ = ["HierarchicalModel", "simulate_hierarchical_sessions", "run_hierarchical_inference"]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


@dataclass(frozen=True)
class HierarchicalModel:
    """Population hyperprior and the subject-level bijection's dimension.
    The four (D,) float32 tensors live on one device (``to``). ``unpack``,
    ``subject_u`` and ``log_prior`` take q (dim,) as the JAX package's do,
    or a batch of them (..., dim)."""

    theta_dim: int
    mu_loc: torch.Tensor
    mu_scale: torch.Tensor
    log_tau_loc: torch.Tensor
    log_tau_scale: torch.Tensor

    @staticmethod
    def from_prior(
        prior: Distribution,
        mu_frac: float = 0.75,
        tau_frac: float = 0.4,
        num_moment_samples: int = 8192,
        seed=0,
        device=None,
    ) -> "HierarchicalModel":
        """Moment-match the hyperprior to the single-subject prior: with
        (mean_d, std_d) the moments of ``num_moment_samples`` prior draws
        pushed through the ``mcmc_transform`` bijection (drawn from
        ``seed``), mu_d ~ Normal(mean_d, mu_frac std_d) and log tau_d ~
        Normal(log(tau_frac std_d), 0.4), so the subjects fall where an
        estimator trained on the prior has seen data. On ``device``
        (default: the CUDA card)."""
        device = resolve_device(device)
        bij = mcmc_transform(prior)
        theta = prior.sample(make_generator(seed, device), (int(num_moment_samples),))
        u = bij.inverse(theta.to(torch.float32))
        mean_u = u.mean(0)
        std_u = u.std(0, unbiased=False)
        D = bij.dim
        return HierarchicalModel(
            theta_dim=D,
            mu_loc=mean_u.to(torch.float32),
            mu_scale=(mu_frac * std_u).to(torch.float32),
            log_tau_loc=torch.log(tau_frac * std_u).to(torch.float32),
            log_tau_scale=torch.full((D,), 0.4, dtype=torch.float32, device=device),
        )

    def to(self, device) -> "HierarchicalModel":
        """The same model with its tensors on ``device``."""
        device = torch.device(device)
        return replace(self, mu_loc=self.mu_loc.to(device), mu_scale=self.mu_scale.to(device),
                       log_tau_loc=self.log_tau_loc.to(device), log_tau_scale=self.log_tau_scale.to(device))

    # -- packing ------------------------------------------------------------
    def dim(self, num_subjects: int) -> int:
        return 2 * self.theta_dim + num_subjects * self.theta_dim

    def unpack(self, q: torch.Tensor, num_subjects: int):
        """q (..., dim) -> (mu (..., D), log_tau (..., D), eps (..., S, D))."""
        D = self.theta_dim
        return q[..., :D], q[..., D : 2 * D], q[..., 2 * D :].reshape(*q.shape[:-1], num_subjects, D)

    def subject_u(self, q: torch.Tensor, num_subjects: int) -> torch.Tensor:
        """u_s = mu + exp(log_tau) * eps_s: (..., S, D)."""
        mu, log_tau, eps = self.unpack(q, num_subjects)
        return mu[..., None, :] + torch.exp(log_tau)[..., None, :] * eps

    def log_prior(self, q: torch.Tensor, num_subjects: int) -> torch.Tensor:
        """The hyperprior's log-density and the subject offsets' standard
        normal: (...,)."""
        mu, log_tau, eps = self.unpack(q, num_subjects)

        def normal_lp(x, loc, scale):
            return (-torch.log(scale) - _LOG_SQRT_2PI - 0.5 * ((x - loc) / scale) ** 2).sum(-1)

        return (normal_lp(mu, self.mu_loc, self.mu_scale) + normal_lp(log_tau, self.log_tau_loc, self.log_tau_scale)
                + (-_LOG_SQRT_2PI - 0.5 * eps**2).sum((-2, -1)))

    def log_prior_and_grad(self, q: torch.Tensor, num_subjects: int):
        """``log_prior`` (...,) and its gradient in q (..., dim)."""
        mu, log_tau, eps = self.unpack(q, num_subjects)
        z_mu = (mu - self.mu_loc) / self.mu_scale
        z_tau = (log_tau - self.log_tau_loc) / self.log_tau_scale
        grad = torch.cat([-z_mu / self.mu_scale, -z_tau / self.log_tau_scale, -eps.flatten(-2)], -1)
        return self.log_prior(q, num_subjects), grad


def simulate_hierarchical_sessions(
    prior: Distribution,
    num_subjects: int,
    trials_per_subject: int,
    *,
    model: Optional[HierarchicalModel] = None,
    mu_sensory: float = 1.0,
    p_success: float = 0.75,
    seed=0,
    return_hyperparams: bool = False,
    hyper_shrink: float = 0.5,
    device=None,
):
    """Draw per-subject theta from the hierarchy and simulate every session
    in one simulator call (K1 on the card). Returns (theta_true (S, D), x
    (S, T, 2) [rt, choice], pulses (S, T, P)); with ``return_hyperparams``
    also the generating ``(mu, log_tau)`` in the unconstrained space.
    ``hyper_shrink`` < 1 draws the hyperparameters from a narrowed
    hyperprior (demos); coverage checks need 1.0. On ``device`` (default:
    the model's, else the CUDA card)."""
    from .rt_choice_model import (
        generate_pulse_matrix,
        n_pulses_max_from_schedule,
        pulse_schedule,
        rt_choice_model_simulator_torch,
    )

    seed = as_seed(seed)
    if model is None:
        model = HierarchicalModel.from_prior(prior, device=device)
    dev = torch.device(device) if device is not None else model.mu_loc.device
    model = model.to(dev)
    bij = mcmc_transform(prior)
    D = model.theta_dim
    k_mu, k_tau, k_eps, k_stim, k_sim = (child_seed(seed, i) for i in range(5))

    def normal(k, shape):
        return torch.randn(shape, generator=make_generator(k, dev), device=dev, dtype=torch.float32)

    mu = model.mu_loc + model.mu_scale * hyper_shrink * normal(k_mu, (D,))
    log_tau = model.log_tau_loc + model.log_tau_scale * hyper_shrink * normal(k_tau, (D,))
    eps = normal(k_eps, (num_subjects, D))
    theta_true = bij.forward(mu[None, :] + torch.exp(log_tau)[None, :] * eps)

    S, T = int(num_subjects), int(trials_per_subject)
    n_max, spp = pulse_schedule()
    P = n_pulses_max_from_schedule(n_max, spp)
    pulses = generate_pulse_matrix(make_generator(k_stim, dev), S * T, P, p_success=p_success)
    x = rt_choice_model_simulator_torch(theta_true.repeat_interleave(T, 0), rng=k_sim, mu_sensory=mu_sensory,
                                        pulse_sides=pulses)
    out = (theta_true, x.reshape(S, T, 2), pulses.reshape(S, T, P))
    if return_hyperparams:
        return out + ((mu, log_tau),)
    return out


def _hierarchical_density(model: HierarchicalModel, bij, est, xs: torch.Tensor, ps: torch.Tensor,
                          logprob_kernel: str = "auto"):
    """The joint density of the fold, for chain rows q (N, dim) that carry
    ``data`` = (rep (N,), beta (N,)): each row's dataset among the B of
    ``xs`` (B, S, T, 2) / ``ps`` (B, S, T, P), and its inverse temperature.
    Returns ``(logp, ll, vg)``: ``logp(q, data)`` = base(q) + beta *
    ll(q, data), base the hyperprior plus every subject's log|d theta/du|;
    ``ll(q, data)`` the untempered summed log-likelihood over the row's S
    subjects (what beta multiplies, for the replica exchange); ``vg(q,
    data, need_grad=True)`` the same density with its gradient in closed
    form (one K3 launch over the N*S*T rows, K2 without the gradient), or
    None where the likelihood has no closed form (the sampler then
    differentiates ``logp`` by autograd).

    Each of the three runs inside a ``hier.density`` span (the likelihood's
    ``potential`` span nested in it) and adds its N*S*T rows to the counter
    ``hier.rows`` while the recorder (``utils.metrics``) is on."""
    from ..potentials import ConditionedMNLELogLikelihood

    B, S, T, _ = xs.shape
    D = model.theta_dim
    lik = ConditionedMNLELogLikelihood(est, ps.reshape(B * S, T, ps.shape[-1]), logprob_kernel=logprob_kernel)
    x_sessions = xs.reshape(B * S, T, xs.shape[-1])
    cache: dict = {}

    def sessions_of(rep):
        """Each (row, subject) pair's session, row-major: rep * S + s
        (made once per ``rep`` tensor, so the likelihood's session terms are
        gathered once per run)."""
        if cache.get("rep") is not rep:
            subjects = torch.arange(S, device=rep.device)
            cache.update(rep=rep, sessions=(rep[:, None] * S + subjects).reshape(-1))
        return cache["sessions"]

    def ll_of_theta(theta, rep, need_grad):
        """theta (N, S, D) -> (ll (N,), d ll / d theta (N, S, D) or None)."""
        N = theta.shape[0]
        flat = theta.reshape(N * S, D)
        if lik.closed_form_grad:
            ll, g = lik.log_lik_and_grad(x_sessions, flat, need_grad, sessions=sessions_of(rep))
            return ll.reshape(N, S).sum(-1), None if g is None else g.reshape(N, S, D)
        return lik.log_lik_fn(est.params, x_sessions, flat, sessions=sessions_of(rep)).reshape(N, S).sum(-1), None

    def done(span: int, q) -> None:
        """Close a ``hier.density`` span and count its rows."""
        if span >= 0:
            metrics.end(span)
        if metrics.RECORDING:
            metrics.count("hier.rows", q.shape[0] * S * T)

    def ll(q, data):
        span = metrics.begin("hier.density") if metrics.RECORDING else -1
        out = ll_of_theta(bij.forward(model.subject_u(q, S)), data[0], False)[0]
        done(span, q)
        return out

    def logp(q, data):
        span = metrics.begin("hier.density") if metrics.RECORDING else -1
        u = model.subject_u(q, S)
        base = model.log_prior(q, S) + bij.forward_log_det(u).sum(-1)
        out = base + data[1] * ll_of_theta(bij.forward(u), data[0], False)[0]
        done(span, q)
        return out

    if not lik.closed_form_grad:
        return logp, ll, None

    def vg(q, data, need_grad: bool = True):
        span = metrics.begin("hier.density") if metrics.RECORDING else -1
        rep, beta = data
        mu, log_tau, eps = model.unpack(q, S)
        tau = torch.exp(log_tau)
        u = mu[:, None, :] + tau[:, None, :] * eps
        theta, dtheta, log_det, dlog_det = bij.forward_and_grads(u)
        lp, g_lp = model.log_prior_and_grad(q, S)
        ll_v, g_ll = ll_of_theta(theta, rep, need_grad)
        value = lp + log_det.sum(-1) + beta * ll_v
        grad = None
        if need_grad:
            gu = beta[:, None, None] * g_ll * dtheta + dlog_det  # d value / d u, (N, S, D)
            grad = g_lp + torch.cat([gu.sum(1), (gu * eps).sum(1) * tau, (gu * tau[:, None, :]).flatten(1)], -1)
        done(span, q)
        return value, grad

    return logp, ll, vg


def run_hierarchical_inference(
    density_estimator,
    prior: Distribution,
    x,
    pulses,
    *,
    model: Optional[HierarchicalModel] = None,
    num_chains: int = 8,
    num_warmup: int = 300,
    num_samples: int = 500,
    max_tree_depth: int = 10,
    target_accept: float = 0.8,
    pt_replicas: int = 1,
    pt_beta_min: float = 0.04,
    segment_length: int = 50,
    logprob_kernel: str = "auto",
    mesh=None,
    seed=0,
    verbose: bool = True,
) -> dict:
    """Joint NUTS over (mu, log_tau, eps_1..S) on the estimator's device.
    ``x`` (S, T, 2) packed [rt, choice] and ``pulses`` (S, T, P), or with a
    leading axis of B independent datasets, (B, S, T, 2) / (B, S, T, P):
    then all B inferences run as one sampler launch (rows = B * chains *
    replicas, dataset-major, then chain, then rung with the cold rung
    first) and every returned array gains the leading B axis.

    ``pt_replicas`` > 1 runs each chain as a replica group on the geometric
    ladder ``geometric_ladder(pt_replicas, pt_beta_min)`` (a DEO swap sweep
    after every transition) and returns the cold rung. Chains start at the
    hyperprior's center, jittered by 0.1 of each block's prior scale
    (``child_seed(seed, 0)``); the sampler draws from ``child_seed(seed,
    1)``. ``density_estimator`` is an ``MNLE`` or an ensemble of them.
    ``mesh``: a ``parallel.mesh.default_mesh`` of the ranks (every rank
    calling with the same arguments); the sampler's rows are then split over
    its first axis (``parallel.mesh.sharded_run_nuts``), each rank's K3
    launch holding its own rows' (row, subject) pairs, and every rank
    returns the unsharded run's result.

    Returns {"raw": draws in q-space (B, C, N, dim) or (C, N, dim),
    "theta_subjects": (B, C*N, S, D) or (C*N, S, D), "population_theta":
    bijector.forward(mu) (B, C*N, D) or (C*N, D), "swap_accept" (None
    without tempering), "info": the sampler's info dict}."""
    from ..inference.nuts import ReplicaExchange, geometric_ladder, run_nuts

    seed = as_seed(seed)
    est = density_estimator
    dev = est.device
    bij = mcmc_transform(prior)
    model = (HierarchicalModel.from_prior(prior, device=dev) if model is None else model).to(dev)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    pulses = torch.as_tensor(pulses, dtype=torch.float32).to(dev)
    batched = x.dim() == 4
    xs = x if batched else x[None]
    ps = pulses if batched else pulses[None]
    B, S = xs.shape[:2]
    D = model.theta_dim
    C, R, N = int(num_chains), int(pt_replicas), int(num_samples)
    dim = model.dim(S)

    center = torch.cat([model.mu_loc, model.log_tau_loc, torch.zeros(S * D, device=dev)])
    scale = torch.cat([model.mu_scale, model.log_tau_scale, torch.ones(S * D, device=dev)])
    rows = B * C * R
    init_q = center + 0.1 * scale * torch.randn((rows, dim), generator=make_generator(child_seed(seed, 0), dev),
                                                device=dev)
    rep = torch.arange(B, device=dev).repeat_interleave(C * R)
    betas = torch.as_tensor(geometric_ladder(R, pt_beta_min), device=dev).repeat(B * C)
    data = (rep, betas)
    logp, ll, vg = _hierarchical_density(model, bij, est, xs, ps, logprob_kernel)
    exchange = ReplicaExchange(n_replicas=R, betas=betas, ll_fn=ll, swap_every=1) if R > 1 else None
    sampler = run_nuts
    if mesh is not None:
        from ..parallel.mesh import sharded_run_nuts

        sampler = partial(sharded_run_nuts, mesh=mesh, axis_name=mesh.mesh_dim_names[0])
    samples, info = sampler(
        child_seed(seed, 1), logp, init_q, num_warmup=num_warmup, num_samples=N, max_depth=max_tree_depth,
        target_accept=target_accept, data=data, segment_length=segment_length, exchange=exchange,
        value_and_grad_fn=vg,
    )
    if R > 1:  # keep the cold (beta = 1) rung of each replica group
        samples = samples.reshape(B * C, R, N, dim)[:, 0]

    flat = samples.reshape(B * C * N, dim)
    theta_subj = bij.forward(model.subject_u(flat, S))  # (BCN, S, D)
    mu_pop = bij.forward(flat[:, :D])
    if verbose:
        ap = float(info["accept_prob"].mean())
        dv = int(info["diverging"].sum())
        print(f"[hierarchical] datasets={B} chains={C} draws={N} subjects={S} "
              f"mean_accept={ap:.3f} divergences={dv}")
    raw = samples.cpu().numpy()
    theta_out = theta_subj.cpu().numpy()
    mu_out = mu_pop.cpu().numpy()
    if batched:
        raw = raw.reshape(B, C, N, dim)
        theta_out = theta_out.reshape(B, C * N, S, D)
        mu_out = mu_out.reshape(B, C * N, D)
    return {
        "raw": raw,
        "theta_subjects": theta_out,
        "population_theta": mu_out,
        "swap_accept": info.get("swap_accept") if R > 1 else None,
        "info": info,
    }
