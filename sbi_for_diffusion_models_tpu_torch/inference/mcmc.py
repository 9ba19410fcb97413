"""MCMCPosterior, the user-facing sampler wrapper, and its extra moves.

Counterpart of ``sbi_for_diffusion_models_tpu/inference/mcmc.py``:
``MCMCPosterior`` (the parallel-tempering NUTS path and the plain NUTS
path), ``make_grid_hop``, ``make_dim_slice`` and ``compose_moves``. The
potential is evaluated for all chains at once (``potential_fn`` takes theta
(N, D)), so each move costs one batched likelihood call per evaluation.

``method="slice"`` runs the batched slice sampler (``inference/slice.py``),
and plain NUTS falls back to it when its chains are unhealthy, as in the
JAX package. The moves take the sampler's generator, a ``torch.Generator``
or, on a rank of a sharded run, a ``parallel.comm.ShardedGenerator``: they
draw and stop their loops through ``utils.rng.draw`` and ``batch_any``.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch

from ..distributions import Bijector, Distribution
from ..utils import metrics
from ..utils.device import resolve_device
from ..utils.rng import batch_any, child_seed, draw, make_generator
from .nuts import ReplicaExchange, geometric_ladder, run_nuts
from .slice import run_slice

__all__ = ["MCMCPosterior", "make_grid_hop", "make_dim_slice", "compose_moves"]


class MCMCPosterior:
    def __init__(
        self,
        potential_fn,
        proposal: Distribution,
        theta_transform: Bijector,
        *,
        method: str = "nuts",
        num_chains: int = 2,
        warmup_steps: int = 100,
        thin: int = 1,
        max_tree_depth: int = 10,
        target_accept: float = 0.8,
        init_strategy: str = "proposal",
        num_workers: int = 1,
        verbose: bool = True,
        auto_fallback: bool = True,
        fallback_divergence_rate: float = 0.10,
        fallback_r_hat: float = 1.5,
        mode_hop=None,
        pt_replicas: int = 1,
        pt_beta_min: float = 0.1,
        pt_swap_every: int = 1,
        device=None,
    ):
        if method not in ("nuts", "nuts_pyro", "hmc", "slice", "slice_np_vectorized"):
            raise ValueError(f"unknown MCMC method {method!r}")
        if init_strategy not in ("proposal", "resample"):
            raise ValueError(
                f"unknown init_strategy {init_strategy!r}: expected 'proposal' or 'resample'"
            )
        self.potential = potential_fn
        self.proposal = proposal
        self.bij = theta_transform
        self.method = {"nuts_pyro": "nuts", "slice_np_vectorized": "slice"}.get(method, method)
        self.num_chains = int(num_chains)
        self.warmup_steps = int(warmup_steps)
        self.thin = int(thin)
        self.max_tree_depth = int(max_tree_depth)
        self.target_accept = float(target_accept)
        self.init_strategy = init_strategy
        self.verbose = verbose
        self.mode_hop = mode_hop
        self.pt_replicas = int(pt_replicas)
        self.pt_beta_min = float(pt_beta_min)
        self.pt_swap_every = int(pt_swap_every)
        if self.pt_replicas > 1 and self.method not in ("nuts", "hmc"):
            raise ValueError(
                "pt_replicas > 1 requires the NUTS sampler (parallel "
                "tempering is not wired into run_slice)"
            )
        self.auto_fallback = bool(auto_fallback)
        self.fallback_divergence_rate = float(fallback_divergence_rate)
        self.fallback_r_hat = float(fallback_r_hat)
        self.device = resolve_device(device)
        self.used_fallback = False
        self._last_info: Optional[dict] = None
        self._last_diagnostics: Optional[dict] = None

    # -- potential in unconstrained space ----------------------------------
    def _logp_u(self, u):
        """u (N, D) -> (N,) log-density in unconstrained space."""
        theta = self.bij.forward(u)
        return self.potential.potential_fn(theta) + self.bij.forward_log_det(u)

    def _init_positions(self, gen: torch.Generator, n: int | None = None) -> torch.Tensor:
        """Chain starts. "proposal": draws from the proposal. "resample":
        draws a pool from the proposal, weights it by the potential and
        resamples the starts (sbi's importance-resampling init)."""
        n = self.num_chains if n is None else int(n)
        if self.init_strategy == "proposal":
            return self.bij.inverse(self.proposal.sample(gen, (n,)).to(torch.float32))
        pool = self.proposal.sample(gen, (max(32 * n, 256),)).to(torch.float32)
        with torch.no_grad():
            logw = self.potential.potential_fn(pool)
        logw = torch.where(torch.isfinite(logw), logw, -math.inf)
        idx = torch.multinomial(torch.softmax(logw, 0), n, replacement=True, generator=gen)
        return self.bij.inverse(pool[idx])

    def _split_logp(self):
        """(base_fn, ll_fn) in u-space with logp_u(u) = base(u) + ll(u),
        where ``ll`` is the term a tempering beta multiplies: only the
        likelihood when the potential exposes (prior, likelihood), the whole
        density otherwise. Both take an optional ``theta = bij.forward(u)``
        computed once by the caller."""
        pot = self.potential
        if hasattr(pot, "prior") and hasattr(pot, "likelihood"):

            def base(u, theta=None):
                theta = self.bij.forward(u) if theta is None else theta
                return pot.prior.log_prob(theta) + self.bij.forward_log_det(u)

            def ll(u, theta=None):
                theta = self.bij.forward(u) if theta is None else theta
                lik = pot.likelihood.log_lik_fn(pot.likelihood.estimator.params, pot.x_o, theta)
                return lik / pot.temperature

            return base, ll
        return (lambda u, theta=None: torch.zeros(u.shape[:-1], device=u.device)), (lambda u, theta=None: self._logp_u(u))

    def _closed_form_vg(self):
        """``vg(u, beta, need_grad) -> (logp, grad)`` of the u-space density
        ``log prior(theta) + log_det(u) + beta * ll(theta) / T`` with its
        gradient in closed form (prior, bijector and the likelihood's
        outer transforms around K2/K3), or None when the potential lacks a
        closed form (then the sampler differentiates by autograd). Same
        density as ``_logp_u`` (beta = 1) and the tempered PT density."""
        pot = self.potential
        lik = getattr(pot, "likelihood", None)
        prior = getattr(pot, "prior", None)
        if not (getattr(lik, "closed_form_grad", False) and getattr(prior, "has_closed_form_grad", lambda: False)()):
            return None
        from ..potentials import tempered_value_and_grad

        vg = tempered_value_and_grad(prior, self.bij, lik, pot.temperature)
        return lambda u, beta, need_grad=True: vg(u, pot.x_o, beta, need_grad)

    def _nuts_failed(self, samples_u, info) -> bool:
        """Health check behind the JAX package's NUTS -> slice fallback."""
        if not bool(torch.isfinite(samples_u).all()):
            return True
        if float(info["diverging"].to(torch.float32).mean()) > self.fallback_divergence_rate:
            return True
        if self.num_chains >= 2 and samples_u.shape[1] >= 10:
            from .diagnostics import split_r_hat

            if float(np.max(split_r_hat(samples_u))) > self.fallback_r_hat:
                return True
        return False

    def sample(
        self,
        sample_shape: Tuple[int, ...],
        x=None,
        *,
        seed: int = 0,
        show_progress_bars: bool = False,
    ) -> torch.Tensor:
        """Draw ``sample_shape[0]`` pooled posterior samples (S, D) on the
        sampler's device. Chain starts come from ``child_seed(seed, 0)``,
        the sampler's own draws from ``child_seed(seed, 1)``."""
        if x is not None and hasattr(self.potential, "set_x_o"):
            self.potential.set_x_o(x)
        num_samples = int(sample_shape[0])
        gen_init = make_generator(child_seed(seed, 0), self.device)
        seed_run = child_seed(seed, 1)
        per_chain = math.ceil(num_samples / self.num_chains)
        R = self.pt_replicas

        if R > 1:
            # Parallel tempering: C cold chains, each with R contiguous
            # replicas (cold rung first) on a geometric beta ladder; beta
            # rides in ``data``, so one batched potential call serves every
            # rung, and DEO swap sweeps run between transitions.
            init_u = self._init_positions(gen_init, self.num_chains * R)
            base_fn, ll_fn = self._split_logp()
            ladder = torch.as_tensor(geometric_ladder(R, self.pt_beta_min), device=self.device)
            betas = ladder.repeat(self.num_chains)

            def logp_pt(u, beta):
                theta = self.bij.forward(u)  # shared by both terms
                return base_fn(u, theta) + beta * ll_fn(u, theta)

            exchange = ReplicaExchange(
                n_replicas=R, betas=betas, ll_fn=lambda u, beta: ll_fn(u),
                swap_every=self.pt_swap_every,
            )
            samples_u, info = run_nuts(
                seed_run, logp_pt, init_u,
                num_warmup=self.warmup_steps, num_samples=per_chain,
                max_depth=self.max_tree_depth, target_accept=self.target_accept,
                thin=self.thin, data=betas, mode_hop=self.mode_hop, exchange=exchange,
                value_and_grad_fn=self._closed_form_vg(),
            )
            # Keep only the cold (beta = 1) rung of each replica group; no
            # slice fallback on this path (as in the JAX package).
            D = samples_u.shape[-1]
            samples_u = samples_u.reshape(self.num_chains, R, per_chain, D)[:, 0]
        else:
            init_u = self._init_positions(gen_init)
            vg = self._closed_form_vg()
            vg1 = None if vg is None else (
                lambda u, need_grad=True: vg(u, torch.ones(u.shape[:-1], device=u.device), need_grad))

            def slice_run(seed):
                return run_slice(
                    seed, self._logp_u, init_u,
                    num_warmup=self.warmup_steps, num_samples=per_chain,
                    thin=self.thin, mode_hop=self.mode_hop, value_and_grad_fn=vg1,
                )

            if self.method == "slice":
                samples_u, info = slice_run(seed_run)
            else:
                samples_u, info = run_nuts(
                    seed_run, self._logp_u, init_u,
                    num_warmup=self.warmup_steps, num_samples=per_chain,
                    max_depth=self.max_tree_depth, target_accept=self.target_accept,
                    thin=self.thin, mode_hop=self.mode_hop, value_and_grad_fn=vg1,
                )
                if self.auto_fallback and self._nuts_failed(samples_u, info):
                    self.used_fallback = True
                    print(
                        "[mcmc] NUTS unhealthy (divergence storm / failed "
                        "mixing); falling back to the vectorized slice sampler "
                        "(reference recipe, ryans_test.ipynb cell 4)"
                    )
                    samples_u, info = slice_run(child_seed(seed_run, 1))
        self._last_info = info

        # (C, S_per, D) -> interleave chains -> (C * S_per, D) -> trim to S.
        theta = self.bij.forward(samples_u)
        pooled = theta.transpose(0, 1).reshape(-1, theta.shape[-1])
        out = pooled[:num_samples]
        if self.verbose and self.method == "nuts" and "diverging" in info:
            ap = float(info["accept_prob"].mean())
            dv = int(info["diverging"].sum())
            print(
                f"[mcmc] nuts: chains={self.num_chains} draws/chain={per_chain} "
                f"mean_accept={ap:.3f} divergences={dv}"
            )
        if self.verbose and self.num_chains >= 2 and per_chain >= 10:
            from .diagnostics import summarize_chains

            self._last_diagnostics = summarize_chains(theta, verbose=True)
        return out

    @property
    def last_info(self) -> Optional[dict]:
        return self._last_info


def make_grid_hop(bij: Bijector, index: int, delta: float, multiples=(-2, -1, 1, 2), bounds=None):
    """Metropolis mode hop for known periodic posterior structure: theta'
    = theta with theta[index] shifted by m*delta (m uniform over the
    symmetric ``multiples``), accepted with the exact posterior ratio; the
    bijector terms are taken out of the u-space log-densities. Proposals
    outside the support of theta[index] (``bounds``, by default from the
    bijector) are rejected.

    Returns ``hop(gen, u, logp, g, vg_fn) -> (u, logp, g)`` on batches of
    unconstrained states (C, D)."""
    delta = float(delta)
    if bounds is None:
        bounds = bij.bounds(index)
    lo_b, hi_b = float(bounds[0]), float(bounds[1])
    # Margin keeps proposals strictly inside finite edges (the bijector's
    # inverse clips at the boundary, which would break detailed balance).
    span = hi_b - lo_b
    margin = 1e-6 * span if np.isfinite(span) else 1e-6
    lo_g = lo_b + margin if np.isfinite(lo_b) else lo_b
    hi_g = hi_b - margin if np.isfinite(hi_b) else hi_b

    mults_cpu = torch.as_tensor(multiples, dtype=torch.float32)
    mults_on: dict = {}

    def hop(gen, u, logp, g, vg_fn):
        span = metrics.begin("move.grid_hop") if metrics.RECORDING else -1
        C = u.shape[0]
        dev = u.device
        mults = mults_on.setdefault(dev, mults_cpu.to(dev))
        m = mults[draw(gen, partial(torch.randint, 0, mults.shape[0]), (C,), dev)]
        theta = bij.forward(u)
        theta_new = theta.clone()
        theta_new[:, index] = theta[:, index] + m * delta
        valid = (theta_new[:, index] > lo_g) & (theta_new[:, index] < hi_g)
        theta_safe = torch.where(valid[:, None], theta_new, theta)
        u_prop = bij.inverse(theta_safe)
        logp_prop, g_prop = vg_fn(u_prop)
        log_ratio = (logp_prop - bij.forward_log_det(u_prop)) - (logp - bij.forward_log_det(u))
        uni = draw(gen, torch.rand, (C,), dev)
        accept = valid & (torch.log(uni) < torch.clamp(log_ratio, max=0.0))
        out = (
            torch.where(accept[:, None], u_prop, u),
            torch.where(accept, logp_prop, logp),
            torch.where(accept[:, None], g_prop, g),
        )
        if span >= 0:
            metrics.end(span)
        return out

    return hop


def make_dim_slice(index: int, width: float = 1.0, max_stepout: int = 6, max_shrink: int = 24):
    """Gradient-free slice update of one unconstrained coordinate, per chain:
    Neal (2003) limited stepping out (budget ``2*max_stepout`` split at
    random between the sides) and shrinkage (at most ``max_shrink`` tries;
    on the cap the state is kept). Targets the full conditional of the
    u-space density; non-finite densities count as zero.

    Returns ``move(gen, u, logp, g, vg_fn) -> (u, logp, g)``. The bracket
    search evaluates values only (no backward pass); the gradient is
    computed once at the new states."""
    w = float(width)
    m_total = 2 * int(max_stepout)

    def _lp(vg_fn, u, x):
        u2 = u.clone()
        u2[:, index] = x
        lp, _ = vg_fn(u2, need_grad=False)
        return torch.where(torch.isfinite(lp), lp, -math.inf)

    def move(gen, u, logp, g, vg_fn):
        span = metrics.begin("move.dim_slice") if metrics.RECORDING else -1
        C = u.shape[0]
        dev = u.device
        x0 = u[:, index]
        logy = logp + torch.log1p(-draw(gen, torch.rand, (C,), dev))
        lo = x0 - draw(gen, torch.rand, (C,), dev) * w
        hi = lo + w
        j_budget = draw(gen, partial(torch.randint, 0, m_total), (C,), dev)
        k_budget = (m_total - 1) - j_budget

        # Stepping out; a side that stopped never restarts (its edge and
        # density no longer change), so the loop ends when both sides stop.
        go_lo = torch.ones((C,), dtype=torch.bool, device=dev)
        go_hi = torch.ones_like(go_lo)
        for i in range(m_total - 1):
            go_lo = go_lo & (i < j_budget)
            go_hi = go_hi & (i < k_budget)
            if batch_any(gen, go_lo):
                go_lo = go_lo & (_lp(vg_fn, u, lo) > logy)
                lo = torch.where(go_lo, lo - w, lo)
            if batch_any(gen, go_hi):
                go_hi = go_hi & (_lp(vg_fn, u, hi) > logy)
                hi = torch.where(go_hi, hi + w, hi)
            if not batch_any(gen, go_lo | go_hi):
                break

        # Shrinkage.
        x = x0.clone()
        done = torch.zeros((C,), dtype=torch.bool, device=dev)
        for _ in range(max_shrink):
            if not batch_any(gen, ~done):
                break
            xp = lo + draw(gen, torch.rand, (C,), dev) * (hi - lo)
            ok = ~done & (_lp(vg_fn, u, xp) > logy)
            miss = ~done & ~ok
            lo = torch.where(miss & (xp < x0), xp, lo)
            hi = torch.where(miss & (xp >= x0), xp, hi)
            x = torch.where(ok, xp, x)
            done = done | ok
        u_new = u.clone()
        u_new[:, index] = torch.where(done, x, x0)
        logp_new, g_new = vg_fn(u_new)
        out = (
            torch.where(done[:, None], u_new, u),
            torch.where(done, logp_new, logp),
            torch.where(done[:, None], g_new, g),
        )
        if span >= 0:
            metrics.end(span)
        return out

    return move


def compose_moves(*moves):
    """Compose mode_hop-style moves, applied in order (each preserves the
    target, so any fixed composition does)."""
    moves = [m for m in moves if m is not None]
    if not moves:
        return None
    if len(moves) == 1:
        return moves[0]

    def move(gen, u, logp, g, vg_fn):
        for m in moves:
            u, logp, g = m(gen, u, logp, g, vg_fn)
        return u, logp, g

    return move
