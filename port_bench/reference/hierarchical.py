"""Plain joint log-density of the hierarchical pulse DDM, written from its equations.

This is the benchmark's yardstick for the hierarchical cell. HDDM's model
(Wiecki, Sofer & Frank 2013, Front. Neuroinform. 7:14) in the
non-centered form, over S subjects and the D = 5 parameters theta = (a0,
lam, v, B, t_nd) of each:

    mu_d      ~ Normal(m0_d, s0_d)          population location
    log tau_d ~ Normal(lt0_d, st0_d)        population scale
    eps_sd    ~ Normal(0, 1)                subject offsets
    u_sd      = mu_d + exp(log tau_d) * eps_sd
    theta_sd  = b_d(u_sd)
    x_s       ~ the MNLE likelihood at (theta_s, the subject's pulses)

and, for q = [mu (D), log tau (D), eps (S*D)] at inverse temperature
beta,

    log p(q) = log N(mu) + log N(log tau) + log N(eps)
               + sum_s sum_d log |d b_d / d u|(u_sd) + beta * sum_s ll(theta_s; x_s),

ll being ``reference.mnle.log_lik`` (the subject's summed trial
log-likelihood). The bijection b is the pipeline prior's
(``build_prior_theta``), written out: the Beta(2, 2) dimensions a0 and
t_nd live on (0, 1) and map through the logistic function (the inverse of
a logit), log |db/du| = log sigma(u) + log sigma(-u); the LogNormal
dimensions lam, v and B are positive and map through exp (the inverse of a
log), log |db/du| = u. The hyperprior's locations and scales are inputs,
as the weights are: the port moment-matches them to the prior.

The gradient in q is taken by autograd. Everything runs in the model's
type, float64 for the yardstick, with TF32 products switched off
explicitly (on only where the caller asks, for the control in float32).
It imports nothing of the port and nothing of JAX. No departure from the
equations above; ``ll`` beside the value is the untempered likelihood
(what beta multiplies), which the replica exchange reads.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import mnle

__all__ = ["Hyperprior", "UNIT_DIMS", "bijection", "log_density"]

UNIT_DIMS = (0, 4)  # a0 and t_nd: Beta(2, 2) on (0, 1); the others LogNormal on (0, inf)
_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


@dataclass
class Hyperprior:
    """The (D,) locations and scales of mu and log tau."""

    mu_loc: torch.Tensor
    mu_scale: torch.Tensor
    log_tau_loc: torch.Tensor
    log_tau_scale: torch.Tensor

    def to(self, dtype, device=None) -> "Hyperprior":
        return Hyperprior(*(t.to(dtype=dtype, device=device) for t in
                            (self.mu_loc, self.mu_scale, self.log_tau_loc, self.log_tau_scale)))


def _normal_lp(x, loc, scale):
    return -torch.log(scale) - _LOG_SQRT_2PI - 0.5 * ((x - loc) / scale) ** 2


def bijection(u):
    """theta = b(u) and log |d theta / d u| elementwise, u (..., 5)."""
    unit = torch.zeros(u.shape[-1], dtype=torch.bool, device=u.device)
    unit[list(UNIT_DIMS)] = True
    theta = torch.where(unit, torch.sigmoid(u), torch.exp(u))
    log_det = torch.where(unit, F.logsigmoid(u) + F.logsigmoid(-u), u)
    return theta, log_det


def _block(m, hyper, q, x, stim, beta):
    """(value, ll) of chain rows q (n, dim); x (n, S, T, 2), stim (n, S, T, P)."""
    n, S, T = x.shape[:3]
    D = hyper.mu_loc.shape[0]
    mu, log_tau, eps = q[:, :D], q[:, D:2 * D], q[:, 2 * D:].reshape(n, S, D)
    u = mu[:, None, :] + torch.exp(log_tau)[:, None, :] * eps
    theta, log_det = bijection(u)
    base = (_normal_lp(mu, hyper.mu_loc, hyper.mu_scale).sum(-1)
            + _normal_lp(log_tau, hyper.log_tau_loc, hyper.log_tau_scale).sum(-1)
            + (-_LOG_SQRT_2PI - 0.5 * eps ** 2).sum((-2, -1)) + log_det.sum((-2, -1)))
    ll = mnle.log_lik(m, x.reshape(n * S, T, x.shape[-1]), stim.reshape(n * S, T, stim.shape[-1]),
                      theta.reshape(n * S, D)).reshape(n, S).sum(-1)
    return base + beta * ll, ll


def log_density(m: mnle.Model, hyper: Hyperprior, q, x, stim, beta, need_grad: bool = True,
                tf32: bool = False, rows_per_block: int = 16_384):
    """The joint log-density of chain rows q (N, 2D + S*D) at inverse
    temperatures beta (N,), each row's cohort x (N, S, T, 2) and stim (N,
    S, T, P) (expanded views do): (value (N,), d value / d q (N, dim) or
    None, ll (N,)), in the model's type, in blocks of chain rows of at most
    ``rows_per_block`` trial rows. ``tf32`` allows TF32 products (the
    control); otherwise they are switched off."""
    dtype = m.cond_mean.dtype
    S, T = x.shape[1:3]
    step = max(1, rows_per_block // (S * T))
    hyper = hyper.to(dtype, m.cond_mean.device)
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    values, grads, lls = [], [], []
    try:
        for lo in range(0, q.shape[0], step):
            qb = q[lo:lo + step].to(dtype).detach().requires_grad_(need_grad)
            with torch.set_grad_enabled(need_grad):
                value, ll = _block(m, hyper, qb, x[lo:lo + step].to(dtype), stim[lo:lo + step].to(dtype),
                                   beta[lo:lo + step].to(dtype))
                if need_grad:
                    grads.append(torch.autograd.grad(value.sum(), qb)[0])
            values.append(value.detach())
            lls.append(ll.detach())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    return torch.cat(values), (torch.cat(grads) if need_grad else None), torch.cat(lls)
