"""Posterior potentials (PyTorch port): the conditioned summed
log-likelihood and the theta-only posterior potential.

Counterpart of ``sbi_for_diffusion_models_tpu/potentials.py``. Where the JAX
package ``vmap``s the per-theta sum over trials, the port builds the (N*T)
rows of all thetas and trials at once, so one batched call of the log-prob
serves every chain.

``log_lik_fn`` differentiates by autograd (through the fused
``autograd.Function`` or the plain network). ``log_lik_and_grad`` computes
the same value and its theta-gradient in closed form around one K3 launch
(K3p for the pulse rep), which writes the rows' values and their
gradients; a call without the gradient launches K2 (K2p). The sampler uses
it at every leapfrog step, where autograd's per-operation host cost was most
of the step's time on the card. The outer transforms are differentiated in
closed form: the condition's log dims and z-scoring, the shifted-log RT with
its floor and barrier, the left-tail sharpening, the pulse rep's t_nd phase
features, and the pulse embedding's physics features (which read |lambda|)
through the embedding MLP by one forward-mode pass.

An ensemble (``mnle.MNLEEnsemble``) is a uniform mixture per trial row: each
member's rows (with its own standardization and outer terms) come from its
own K3 (K2) launch, so a call launches one kernel per member; the rows mix
by log-mean-exp and the gradient weighs each member's row gradient by its
share of the row's mixture (a softmax over the members).

The likelihood also holds several sessions at once (SBC folds its datasets
into the chain axis): ``local_theta`` (G, T, P) and ``x`` (G, T, 2), and
each call names every theta row's session (``sessions``, (N,)). The
theta-free session terms are made once, for the G sessions, and every call
is still one launch (per member) over all N*T rows.
"""

from __future__ import annotations

import math

import torch

from .distributions import Distribution
from .nets.mnle_net import MNLE, slot_features, tail_sharp_transform
from .ops import density_cuda, mnle_cuda
from .utils import metrics

__all__ = [
    "ConditionedMNLELogLikelihood", "ThetaOnlyPosteriorPotential", "tempered_value_and_grad", "mixture_log_prob",
]


def mixture_log_prob(fns):
    """The uniform mixture of the log-prob functions ``fns`` (each
    ``fn(x, condition)``): log-mean-exp over them, row by row; one function
    is returned as it is."""
    if len(fns) == 1:
        return fns[0]
    log_k = math.log(len(fns))

    def log_prob(x, condition):
        return torch.logsumexp(torch.stack([f(x, condition) for f in fns]), dim=0) - log_k

    return log_prob


def _per_chain(a, sessions, n: int):
    """The rows of ``a`` for n theta rows: one session's (T, ...) broadcast
    to (n, T, ...), or each row's own session of the stack (G, T, ...)."""
    if sessions is None:
        return a[None].expand(n, *a.shape)
    return a[sessions]


class ConditionedMNLELogLikelihood:
    """``ll(theta) = sum_i log p(x_i | theta, s_i)`` for batches of theta,
    given the session's stimulus ``local_theta`` (T, P), or the stimuli of G
    sessions (G, T, P); with G sessions every call takes ``x`` (G, T, 2) and
    ``sessions`` (N,), the session of each theta row. ``estimator`` is an
    ``MNLE`` or an ensemble of them (anything with ``members``)."""

    def __init__(self, estimator: MNLE, local_theta, *, logprob_kernel: str = "xla"):
        self.estimator = estimator
        self.members = tuple(getattr(estimator, "members", (estimator,)))
        self.local_theta = torch.as_tensor(local_theta, dtype=torch.float32).to(estimator.device)
        if self.local_theta.dim() not in (2, 3):
            raise ValueError(
                f"local_theta must be (num_trials, P) or (num_sessions, num_trials, P), "
                f"got {tuple(self.local_theta.shape)}"
            )
        # "pallas" runs the rows through the fused kernels, which hold the
        # weights packed at construction; "xla" through log_prob_fn(params).
        # The pulse rep's tnd anchor has no fused path: "auto" evaluates it
        # with log_prob_fn, with no closed-form gradient ("pallas" raises).
        self.logprob_kernel = logprob_kernel
        cfg = estimator.cfg
        tnd_anchor = cfg.rt_rep == "pulse" and not cfg.circular
        fused = logprob_kernel != "xla" and (logprob_kernel == "pallas" or not tnd_anchor)
        self._fused = [m.dispatch_log_prob(logprob_kernel) for m in self.members] if fused else None
        self._lp_fused = mixture_log_prob(self._fused) if fused else None
        self._session_cache = None

    def __call__(self, x, theta):
        return self.forward(x, theta)

    def _check_sessions(self, sessions) -> None:
        if (sessions is None) != (self.local_theta.dim() == 2):
            raise ValueError(
                "sessions names each theta row's session: give it exactly when local_theta "
                f"holds several sessions (local_theta {tuple(self.local_theta.shape)})"
            )

    def log_lik_fn(self, params, x, theta, sessions=None):
        """x (T, 2), theta (N, D) -> (N,) summed log-likelihood; with G
        sessions x (G, T, 2) and ``sessions`` (N,)."""
        est = self.estimator
        if self._lp_fused is not None and params is not est.params:
            # The fused path holds the weights packed at construction; a
            # different network here would silently evaluate stale weights.
            raise ValueError(
                "fused log-prob path was built for the estimator's current "
                "params; pass estimator.params or use logprob_kernel='xla'"
            )
        self._check_sessions(sessions)
        span = metrics.begin("potential") if metrics.RECORDING else -1
        N = theta.shape[0]
        s = _per_chain(self.local_theta, sessions, N)
        T = s.shape[1]
        cond = torch.cat([theta[:, None, :].expand(N, T, theta.shape[-1]), s], dim=-1).reshape(N * T, -1)
        xr = _per_chain(x, sessions, N).reshape(N * T, -1)
        lp = self._lp_fused(xr, cond) if self._lp_fused is not None else est.log_prob_fn(params, xr, cond)
        out = lp.reshape(N, T).sum(-1)
        if span >= 0:
            metrics.end(span)
        return out

    @property
    def closed_form_grad(self) -> bool:
        """Whether ``log_lik_and_grad`` is available (the fused path)."""
        return self._lp_fused is not None

    def _session(self, x, sessions, n: int):
        """The theta-free parts of the rows of n theta rows, one dict per
        member, each entry (n, T, ...): one-hot choices, censored mask, the
        standardized stimulus columns of the condition (and the raw ones,
        for the pulse embedding's features), and the RT terms when they do
        not depend on theta. They are made once for ``x`` (one session (T,
        2), or G sessions (G, T, 2)); one session's are broadcast to the n
        rows, and with G sessions each row's are gathered once per
        ``sessions`` tensor, so a sampler's calls (the same ``x`` and
        ``sessions`` every time) compute them once."""
        if self._session_cache is None or self._session_cache[0] is not x:
            self._session_cache = (x, [self._session_terms(m, x) for m in self.members], None)
        _, terms, gathered = self._session_cache
        if gathered is not None and gathered[0] is sessions:
            return gathered[1]
        rows = [{k: v if k == "log_mask" or v is None else _per_chain(v, sessions, n) for k, v in t.items()}
                for t in terms]
        if sessions is not None:
            self._session_cache = (x, terms, (sessions, rows))
        return rows

    def _session_terms(self, est: MNLE, x):
        """The theta-free terms of session ``x`` (T, 2), or of the sessions
        ``x`` (G, T, 2), under member ``est``'s standardization, each of
        shape x.shape[:-1] + its own (``log_mask``: which theta columns
        enter the condition as logs)."""
        cfg = est.cfg
        P = self.local_theta.shape[-1]
        theta_dim = cfg.condition_dim - P
        lead = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1])
        probe = torch.cat(
            [torch.ones((x.shape[0], theta_dim), device=x.device), self.local_theta.reshape(-1, P)], dim=-1
        )
        if cfg.rt_rep == "pulse":
            # Absolute anchor: k, phi and ds are theta-free; t_nd enters
            # only through the sin/cos features, made per call.
            phi, onehot, c, kf, kv, ds, choice = est.standardize_pulse(x, probe)
            sess = {"phi": phi, "kv": kv, "extra": ds}
        else:
            t, onehot, c, log_det, barrier, choice = est.standardize(x, probe)
            sess = {"t": t, "extra": log_det + barrier}
        sess.update({
            "rt": x[:, 0],
            "onehot": onehot,
            "c_stim": c[:, theta_dim:],
            "s_raw": self.local_theta.reshape(-1, P) if cfg.context_block else None,
            "censored": (choice == cfg.censored_category) if cfg.censor_rt else None,
        })
        sess = {k: None if v is None else v.reshape(*lead, *v.shape[1:]) for k, v in sess.items()}
        sess["log_mask"] = None
        log_dims = [d for d in cfg.log_condition_dims if d < theta_dim]
        if log_dims:
            sess["log_mask"] = torch.zeros((theta_dim,), dtype=torch.bool, device=x.device)
            sess["log_mask"][log_dims] = True
        return sess

    def log_lik_and_grad(self, x, theta, need_grad: bool = True, sessions=None):
        """``(ll (N,), d ll / d theta (N, D) or None)`` for x (T, 2) and theta
        (N, D) on the fused path: one K3 (K3p) launch for the values and
        the gradient over all N*T rows (one K2 (K2p) launch for the values
        alone when ``need_grad`` is False), with the outer
        transforms (condition log/z-score, shifted-log RT, its log-det and
        barrier, the tail sharpening, the pulse rep's t_nd phase features,
        the pulse embedding, the censored mask) differentiated in closed
        form instead of by autograd. The same function as ``log_lik_fn``;
        the sampler calls this at every leapfrog step, where autograd's
        per-operation cost dominated. With G sessions, x is (G, T, 2) and
        ``sessions`` (N,) names each theta row's session; still one launch
        a call. An ensemble of K members launches K, one per member, and
        mixes them row by row."""
        if self._lp_fused is None:
            raise ValueError("log_lik_and_grad needs the fused path (logprob_kernel != 'xla')")
        self._check_sessions(sessions)
        span = metrics.begin("potential") if metrics.RECORDING else -1
        terms = self._session(x, sessions, theta.shape[0])
        rows = [self._member_rows(m, w, sess, theta, need_grad)
                for m, w, sess in zip(self.members, (f.weights for f in self._fused), terms)]
        if len(rows) == 1:
            lp, grad = rows[0]
            out = lp.sum(-1), grad(None) if need_grad else None
        else:
            lps = torch.stack([lp for lp, _ in rows])  # (K, N, T)
            ll = (torch.logsumexp(lps, dim=0) - math.log(len(rows))).sum(-1)
            if need_grad:
                share = torch.softmax(lps, dim=0)  # each member's share of each row's mixture
                out = ll, sum(grad(share[k]) for k, (_, grad) in enumerate(rows))
            else:
                out = ll, None
        if span >= 0:
            metrics.end(span)
        return out

    def _member_rows(self, est: MNLE, weights, sess, theta, need_grad: bool):
        """One member's rows: ``(lp (N, T), grad)``, lp each row's
        log-prob with its outer terms (one K3 launch, or K2 without the
        gradient), and ``grad(share)`` (None without the gradient) the
        theta-gradient (N, D) of the rows' sum, each row weighed by ``share``
        (N, T) (None: all rows by 1)."""
        cfg = est.cfg
        N, D = theta.shape
        T = sess["rt"].shape[1]

        # Condition columns of theta: log dims, then z-scoring.
        c_th = theta
        dc_th = torch.ones_like(theta)
        mask = sess["log_mask"]
        if mask is not None:
            clamped = torch.clamp(theta, min=1e-37)
            c_th = torch.where(mask, torch.log(clamped), theta)
            dc_th = torch.where(mask, torch.where(theta >= 1e-37, 1.0 / clamped, 0.0), 1.0)
        if cfg.z_score_theta:
            c_th = (c_th - est.cond_mean[:D]) / est.cond_std[:D]
            dc_th = dc_th / est.cond_std[:D]
        ctx = torch.cat([c_th[:, None, :].expand(N, T, D), sess["c_stim"]], dim=-1).reshape(N * T, -1)
        lam_tangent = None
        if cfg.context_block:
            # The embedding context reads |lambda| off the raw condition.
            c_raw = torch.cat([theta[:, None, :].expand(N, T, D), sess["s_raw"]], dim=-1).reshape(N * T, -1)
            ctx = est.net.make_context(ctx, c_raw, lam_tangent=need_grad)
            if need_grad:
                ctx, lam_tangent = ctx

        def weigh(a, share):
            return a if share is None else a * share.reshape(share.shape + (1,) * (a.dim() - 2))

        def context_grad(d_ctx, share):
            """The gradient through the context: its theta columns, and
            lambda's features (and embedding) where the context has them."""
            d_ctx = weigh(d_ctx.reshape(N, T, -1), share)
            grad = d_ctx[:, :, :D].sum(1) * dc_th
            if lam_tangent is not None:
                tan = lam_tangent.reshape(N, T, -1)
                grad[:, cfg.lam_index] += (d_ctx[:, :, cfg.context_start:] * tan).sum((1, 2))
            return grad

        if cfg.rt_rep == "pulse":
            return self._pulse_rows(est, weights, sess, theta, ctx, need_grad, weigh, context_grad)

        # RT coordinate: depends on theta only through t_nd in shifted-log.
        if cfg.rt_rep == "shifted_log":
            gap = sess["rt"] - theta[:, cfg.tnd_index, None]
            gap_c = torch.clamp(gap, min=1e-6)
            t_raw = torch.log(gap_c)
            t = (t_raw - est.x_mean) / est.x_std if cfg.z_score_x else t_raw
            extra = -t_raw - 50.0 * torch.relu(1e-6 - gap)
            if cfg.z_score_x:
                extra = extra - torch.log(est.x_std)
            t_std = t
            if cfg.tail_sharp_k > 0:
                t, ld = tail_sharp_transform(cfg, t)
                extra = extra + ld
        else:
            t = sess["t"]
            extra = sess["extra"]
        if sess["censored"] is not None:
            extra = torch.where(sess["censored"], 0.0, extra)

        t_rows = t.reshape(N * T)
        oh_rows = sess["onehot"].reshape(N * T, -1)
        if not need_grad:
            return mnle_cuda.rows_logp(t_rows, oh_rows, ctx, weights).reshape(N, T) + extra, None
        lp, d_t, d_ctx = mnle_cuda.rows_logp_and_vjp(t_rows, oh_rows, ctx, weights, torch.ones_like(t_rows))

        def grad(share):
            g = context_grad(d_ctx, share)
            if cfg.rt_rep == "shifted_log":
                # d t_raw / d t_nd = -1/gap above the floor; barrier slope -50 below it.
                dt_raw = torch.where(gap >= 1e-6, -1.0 / gap_c, 0.0)
                d_t_th = dt_raw / est.x_std if cfg.z_score_x else dt_raw
                d_extra = -dt_raw - 50.0 * (gap < 1e-6).to(theta.dtype)
                if cfg.tail_sharp_k > 0:
                    # phi' = 1 + e and d log1p(e) / dt = -k e / (1 + e), both
                    # through e = exp(-k (t - c)) where the clamp at 30 is off.
                    arg = -cfg.tail_sharp_k * (t_std - cfg.tail_sharp_c)
                    e = torch.exp(torch.clamp(arg, max=30.0))
                    free = arg < 30.0
                    d_extra = d_extra + torch.where(free, -cfg.tail_sharp_k * e / (1.0 + e), 0.0) * d_t_th
                    d_t_th = d_t_th * torch.where(free, 1.0 + e, 1.0)
                if sess["censored"] is not None:
                    d_extra = torch.where(sess["censored"], 0.0, d_extra)
                g[:, cfg.tnd_index] += weigh(d_t.reshape(N, T) * d_t_th + d_extra, share).sum(-1)
            return g

        return lp.reshape(N, T) + extra, grad

    def _pulse_rows(self, est: MNLE, weights, sess, theta, ctx, need_grad: bool, weigh, context_grad):
        """The pulse rep's part of ``_member_rows`` (absolute anchor):
        K3p on the rows (K2p without the gradient), and t_nd's gradient
        through the features kf = [k_norm, sin ang, cos ang],
        ang = 2 pi ((t_nd / Delta) mod 1):
        d kf / d t_nd = (0, cos ang, -sin ang) 2 pi / Delta. There is no
        barrier to differentiate."""
        cfg = est.cfg
        N, D = theta.shape
        T = sess["rt"].shape[1]
        kf = slot_features(cfg, sess["kv"], theta[:, cfg.tnd_index, None].expand(N, T), theta.dtype)
        rows = (sess["phi"].reshape(N * T), sess["onehot"].reshape(N * T, -1), ctx, kf.reshape(N * T, -1),
                sess["kv"].reshape(N * T))
        # extra = -log Delta on the rows that are not censored (made per session).
        if not need_grad:
            return mnle_cuda.rows_logp_pulse(*rows, weights).reshape(N, T) + sess["extra"], None
        lp, _, d_ctx, d_kf = mnle_cuda.rows_logp_pulse_and_vjp(*rows, weights, torch.ones_like(rows[0]))

        def grad(share):
            g = context_grad(d_ctx, share)
            d_kf3 = weigh(d_kf.reshape(N, T, -1), share).sum(1)
            scale = 2.0 * math.pi / cfg.pulse_interval
            sin, cos = kf[:, 0, 1], kf[:, 0, 2]
            g[:, cfg.tnd_index] += (d_kf3[:, 1] * cos - d_kf3[:, 2] * sin) * scale
            return g

        return lp.reshape(N, T) + sess["extra"], grad

    def forward(self, x, theta):
        """x: (T, 2) or (1, T, 2); theta: (N, D). Returns (1, N)."""
        x = torch.as_tensor(x, dtype=torch.float32)
        if x.dim() == 3:
            if x.shape[0] != 1:
                raise ValueError(f"only num_xs == 1 is supported, got {x.shape[0]}")
            x = x[0]
        theta = torch.as_tensor(theta, dtype=torch.float32)
        if theta.dim() == 1:
            theta = theta.reshape(1, -1)
        if x.shape[0] != self.local_theta.shape[0]:
            raise ValueError(
                f"x has {x.shape[0]} trials but local_theta has {self.local_theta.shape[0]}"
            )
        return self.log_lik_fn(self.estimator.params, x, theta)[None, :]


def _tempered_vg_plain(prior: Distribution, bij, likelihood: ConditionedMNLELogLikelihood, temperature: float,
                       u, x, beta, need_grad: bool = True, sessions=None):
    """The plain composition of ``tempered_value_and_grad``'s density, one
    eager operation at a time: the route of CPU tensors, and what the kernel
    pair (``ops/density_cuda.py``) follows bit for bit."""
    theta, dtheta, log_det, dlog_det = bij.forward_and_grads(u)
    lp, g_lp = prior.log_prob_and_grad(theta)
    ll, g_ll = likelihood.log_lik_and_grad(x, theta, need_grad, sessions=sessions)
    beta_t = beta / temperature
    value = lp + log_det + beta_t * ll
    if not need_grad:
        return value, None
    return value, (g_lp + beta_t[:, None] * g_ll) * dtheta + dlog_det


def _takes_density_kernel(u: torch.Tensor) -> bool:
    """Whether a call of the density runs in the kernel pair: on a CUDA
    ``u``. CPU tensors take ``_tempered_vg_plain``."""
    return u.is_cuda


def tempered_value_and_grad(prior: Distribution, bij, likelihood: ConditionedMNLELogLikelihood,
                            temperature: float = 1.0):
    """``vg(u, x, beta, need_grad=True, sessions=None) -> (value, grad or
    None)``: the u-space density ``log prior(theta) + log_det(u) + beta *
    ll(theta) / temperature``, theta = ``bij.forward(u)``, with its gradient
    in u in closed form (prior, bijector and the likelihood's outer
    transforms around one K3/K3p launch; a value-only call launches K2/K2p).
    beta (N,) is each row's inverse temperature (ones for the untempered
    density); ``x`` and ``sessions`` go to ``likelihood.log_lik_and_grad``.
    Needs ``likelihood.closed_form_grad`` and a prior with
    ``log_prob_and_grad``.

    On the card the prior, the bijector and the tempering run in two
    launches around the potential call (``ops/density_cuda.UDensity``:
    ``density_pre`` before it, ``density_post`` after), which give the plain
    composition's bits; the pair is built here for a likelihood on a card,
    and raises for a prior it does not take (see ``DensityTables``)."""
    pair = density_cuda.UDensity(prior, bij, temperature) if likelihood.local_theta.is_cuda else None

    def vg(u, x, beta, need_grad: bool = True, sessions=None):
        if not _takes_density_kernel(u):
            return _tempered_vg_plain(prior, bij, likelihood, temperature, u, x, beta, need_grad, sessions)
        theta = pair.pre(u, need_grad)
        ll, g_ll = likelihood.log_lik_and_grad(x, theta, need_grad, sessions=sessions)
        return pair.post(ll, g_ll, beta, need_grad)

    return vg


class ThetaOnlyPosteriorPotential:
    """log p(theta) + sum_i log p(x_i | theta, s_i) / temperature."""

    def __init__(self, prior: Distribution, likelihood: ConditionedMNLELogLikelihood, x_o=None,
                 temperature: float = 1.0):
        self.prior = prior
        self.likelihood = likelihood
        self.temperature = float(temperature)
        self.x_o = None
        if x_o is not None:
            self.set_x_o(x_o)

    def set_x_o(self, x_o):
        self.x_o = torch.as_tensor(x_o, dtype=torch.float32).to(self.likelihood.local_theta.device)

    set_x = set_x_o

    def log_likelihood(self, theta):
        """Untempered summed log-likelihood of theta (N, D) -> (N,)."""
        return self.likelihood.log_lik_fn(self.likelihood.estimator.params, self.x_o, theta)

    def potential_fn(self, theta, x=None):
        """theta (D,) -> scalar, or (N, D) -> (N,): prior + likelihood / T,
        differentiable in theta (no masking)."""
        if x is not None:
            self.set_x_o(x)
        squeeze = theta.dim() == 1
        th = theta.reshape(1, -1) if squeeze else theta
        out = self.prior.log_prob(th) + self.log_likelihood(th) / self.temperature
        return out[0] if squeeze else out

    def __call__(self, theta, x_o=None, track_gradients: bool = True):
        """Batched potential theta (N, D) -> (N,); rows outside the prior's
        support get -inf without their likelihood reaching the output."""
        if x_o is not None:
            self.set_x_o(x_o)
        theta = torch.as_tensor(theta, dtype=torch.float32)
        squeeze = theta.dim() == 1
        if squeeze:
            theta = theta.reshape(1, -1)
        with torch.set_grad_enabled(track_gradients and torch.is_grad_enabled()):
            lp_prior = self.prior.log_prob(theta)
            finite = torch.isfinite(lp_prior)
            safe_theta = torch.where(finite[:, None], theta, torch.ones_like(theta))
            ll = self.log_likelihood(safe_theta)
            out = torch.where(finite, lp_prior + ll / self.temperature, torch.full_like(ll, -math.inf))
        return out[0] if squeeze else out
