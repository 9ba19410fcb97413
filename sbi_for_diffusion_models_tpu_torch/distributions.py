"""Priors and the constrained <-> unconstrained bijection, in PyTorch.

Counterpart of ``sbi_for_diffusion_models_tpu/distributions.py`` with the
same conventions:

* ``sample(generator, sample_shape=())`` returns
  ``(*sample_shape, *event_shape)`` float32 on the generator's device;
* ``log_prob(x)`` accepts ``(..., *event_shape)`` and sums the event
  dimensions (torch ``Independent`` semantics).

Parameters are plain Python floats, so one distribution object serves
tensors on any device.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "Distribution",
    "Beta",
    "LogNormal",
    "Normal",
    "Uniform",
    "BoxUniform",
    "MultipleIndependent",
    "Support",
    "real_support",
    "positive_support",
    "interval_support",
    "Bijector",
    "mcmc_transform",
]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


class Support:
    """Constraint descriptor used to derive the MCMC bijection."""

    def __init__(self, kind: str = "real", lo: float | None = None, hi: float | None = None):
        self.kind = kind
        self.lo = lo
        self.hi = hi

    def __repr__(self):
        return f"Support({self.kind}, lo={self.lo}, hi={self.hi})"


def real_support() -> Support:
    return Support("real")


def positive_support() -> Support:
    return Support("positive", lo=0.0)


def interval_support(lo: float, hi: float) -> Support:
    return Support("interval", lo=lo, hi=hi)


def _as_params(v) -> list[float]:
    """Scalar or sequence parameter (numbers, a numpy array, a tensor) ->
    list of floats (one per event dim)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float64).reshape(-1).tolist()


class _Consts:
    """Float32 constant vectors per device, made once: building them anew on
    every call would copy them host to device (and wait for the device)
    each time a log-density is evaluated."""

    def __init__(self, **vals: list[float]):
        self._vals = vals
        self._by_device: dict = {}

    def on(self, like: torch.Tensor) -> dict:
        out = self._by_device.get(like.device)
        if out is None:
            out = {k: torch.tensor(v, dtype=torch.float32, device=like.device) for k, v in self._vals.items()}
            self._by_device[like.device] = out
        return out


def _kernel_rows(*cols) -> list[list[float]]:
    """Per-column float32 constants, one list per column, from vectors of
    one constant each."""
    return torch.stack(cols, dim=1).tolist()


class Distribution:
    event_shape: tuple

    @property
    def event_dim(self) -> int:
        return int(self.event_shape[0]) if self.event_shape else 1

    def kernel_groups(self) -> tuple[list, bool]:
        """``(groups, from_zero)``: the marginals in the order the log-density
        sums them, each ``(distribution, its columns)``, and whether the sum
        starts from 0.0, for the u-space density kernel
        (``ops/density_cuda.py``). One group of every column here; a family
        the kernel takes has ``kernel_family`` and ``kernel_constants``."""
        return [(self, list(range(self.event_dim)))], False

    def sample(self, generator: torch.Generator, sample_shape=()):  # pragma: no cover
        raise NotImplementedError

    def log_prob(self, x):  # pragma: no cover
        raise NotImplementedError

    def supports(self) -> list[Support]:  # pragma: no cover
        raise NotImplementedError


class Beta(Distribution):
    def __init__(self, concentration1, concentration0):
        self.a = _as_params(concentration1)
        self.b = _as_params(concentration0)
        self.event_shape = (len(self.a),)
        a, b = torch.tensor(self.a), torch.tensor(self.b)
        log_beta = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
        self._consts = _Consts(am1=(a - 1.0).tolist(), bm1=(b - 1.0).tolist(), log_beta=log_beta.tolist())

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.event_shape
        dev = generator.device
        a = torch.tensor(self.a, dtype=torch.float32, device=dev).expand(shape)
        b = torch.tensor(self.b, dtype=torch.float32, device=dev).expand(shape)
        x = torch._standard_gamma(a.contiguous(), generator=generator)
        y = torch._standard_gamma(b.contiguous(), generator=generator)
        return x / (x + y)

    def log_prob(self, x):
        c = self._consts.on(x)
        xc = torch.clamp(x, 1e-37, 1.0 - 1e-7)
        lp = c["am1"] * torch.log(xc) + c["bm1"] * torch.log1p(-xc) - c["log_beta"]
        inside = (x > 0.0) & (x < 1.0)
        lp = torch.where(inside, lp, torch.full_like(lp, -math.inf))
        return lp.sum(-1)

    def log_prob_and_grad(self, x):
        """``(log_prob(x), d log_prob / dx)`` in closed form, with the
        gradient autograd gives through ``log_prob`` (zero where the clamp or
        the support cuts it)."""
        c = self._consts.on(x)
        xc = torch.clamp(x, 1e-37, 1.0 - 1e-7)
        one_m = 1.0 - xc
        lp = c["am1"] * torch.log(xc) + c["bm1"] * torch.log1p(-xc) - c["log_beta"]
        ok = (x > 0.0) & (x < 1.0)
        grad = torch.where(ok & (x <= 1.0 - 1e-7) & (x >= 1e-37), c["am1"] / xc - c["bm1"] / one_m, 0.0)
        return torch.where(ok, lp, -math.inf).sum(-1), grad

    kernel_family = 2  # csrc/udensity.cu's code of the family

    def kernel_constants(self) -> list[list[float]]:
        """a - 1, b - 1, log B(a, b) and 0 a column, the float32 constants
        of ``log_prob_and_grad``, for the u-space density kernel."""
        c = self._consts.on(torch.empty(0))
        return _kernel_rows(c["am1"], c["bm1"], c["log_beta"], torch.zeros_like(c["am1"]))

    def supports(self):
        return [interval_support(0.0, 1.0) for _ in range(self.event_dim)]


class LogNormal(Distribution):
    def __init__(self, loc, scale):
        self.mu = _as_params(loc)
        self.sigma = _as_params(scale)
        self.event_shape = (len(self.mu),)
        log_sigma = torch.log(torch.tensor(self.sigma))
        self._consts = _Consts(mu=self.mu, sigma=self.sigma, log_sigma=log_sigma.tolist())

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.event_shape
        dev = generator.device
        eps = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        mu = torch.tensor(self.mu, dtype=torch.float32, device=dev)
        sigma = torch.tensor(self.sigma, dtype=torch.float32, device=dev)
        return torch.exp(mu + sigma * eps)

    def log_prob(self, x):
        c = self._consts.on(x)
        logx = torch.log(torch.clamp(x, min=1e-37))
        lp = -logx - c["log_sigma"] - _LOG_SQRT_2PI - 0.5 * ((logx - c["mu"]) / c["sigma"]) ** 2
        lp = torch.where(x > 0.0, lp, torch.full_like(lp, -math.inf))
        return lp.sum(-1)

    def log_prob_and_grad(self, x):
        """``(log_prob(x), d log_prob / dx)`` in closed form (see ``Beta``)."""
        c = self._consts.on(x)
        xc = torch.clamp(x, min=1e-37)
        logx = torch.log(xc)
        zs = (logx - c["mu"]) / c["sigma"]
        lp = -logx - c["log_sigma"] - _LOG_SQRT_2PI - 0.5 * zs * zs
        grad = torch.where(x >= 1e-37, (-1.0 - zs / c["sigma"]) / xc, 0.0)
        return torch.where(x > 0.0, lp, -math.inf).sum(-1), grad

    kernel_family = 3  # csrc/udensity.cu's code of the family

    def kernel_constants(self) -> list[list[float]]:
        """mu, sigma, log sigma and log sqrt(2 pi) a column, the float32
        constants of ``log_prob_and_grad``, for the u-space density kernel."""
        c = self._consts.on(torch.empty(0))
        return _kernel_rows(c["mu"], c["sigma"], c["log_sigma"], torch.full_like(c["mu"], _LOG_SQRT_2PI))

    def supports(self):
        return [positive_support() for _ in range(self.event_dim)]


class Normal(Distribution):
    def __init__(self, loc, scale):
        self.mu = _as_params(loc)
        self.sigma = _as_params(scale)
        self.event_shape = (len(self.mu),)
        self._consts = _Consts(mu=self.mu, sigma=self.sigma, log_sigma=[math.log(v) for v in self.sigma])

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.event_shape
        dev = generator.device
        eps = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return torch.tensor(self.mu, device=dev) + torch.tensor(self.sigma, device=dev) * eps

    def log_prob(self, x):
        c = self._consts.on(x)
        return (-c["log_sigma"] - _LOG_SQRT_2PI - 0.5 * ((x - c["mu"]) / c["sigma"]) ** 2).sum(-1)

    def log_prob_and_grad(self, x):
        """``(log_prob(x), d log_prob / dx)`` in closed form."""
        c = self._consts.on(x)
        return self.log_prob(x), -(x - c["mu"]) / (c["sigma"] * c["sigma"])

    kernel_family = 1  # csrc/udensity.cu's code of the family

    def kernel_constants(self) -> list[list[float]]:
        """mu, sigma, -log sigma - log sqrt(2 pi) and sigma * sigma a
        column, for the u-space density kernel: the last two rounded once
        each in float32, as ``log_prob_and_grad`` rounds them."""
        c = self._consts.on(torch.empty(0))
        return _kernel_rows(c["mu"], c["sigma"], -c["log_sigma"] - _LOG_SQRT_2PI, c["sigma"] * c["sigma"])

    def supports(self):
        return [real_support() for _ in range(self.event_dim)]


class Uniform(Distribution):
    def __init__(self, low, high):
        self.lo = _as_params(low)
        self.hi = _as_params(high)
        self.event_shape = (len(self.lo),)
        self._consts = _Consts(lo=self.lo, hi=self.hi, neg_log_width=[-math.log(h - l) for l, h in zip(self.lo, self.hi)])

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.event_shape
        dev = generator.device
        lo, hi = torch.tensor(self.lo, device=dev), torch.tensor(self.hi, device=dev)
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=dev, dtype=torch.float32)

    def log_prob(self, x):
        c = self._consts.on(x)
        inside = (x >= c["lo"]) & (x <= c["hi"])
        return torch.where(inside, c["neg_log_width"], -math.inf).sum(-1)

    def log_prob_and_grad(self, x):
        """``(log_prob(x), 0)``: the density is flat on its box."""
        return self.log_prob(x), torch.zeros_like(x)

    kernel_family = 0  # csrc/udensity.cu's code of the family

    def kernel_constants(self) -> list[list[float]]:
        """lo, hi, -log(hi - lo) and 0 a column, the float32 constants of
        ``log_prob``, for the u-space density kernel."""
        c = self._consts.on(torch.empty(0))
        return _kernel_rows(c["lo"], c["hi"], c["neg_log_width"], torch.zeros_like(c["lo"]))

    def supports(self):
        return [interval_support(lo, hi) for lo, hi in zip(self.lo, self.hi)]


def BoxUniform(low, high) -> Uniform:
    """sbi-style BoxUniform: a ``Uniform`` on the box [low, high]."""
    return Uniform(low, high)


class MultipleIndependent(Distribution):
    """Product of 1-D (or small-d) marginals concatenated along the event
    axis (``sbi.utils.MultipleIndependent``).

    ``log_prob`` merges the marginals of one class (``Beta``, ``LogNormal``)
    into one vector-parameter distribution over their columns, so the prior
    costs a few tensor operations per class instead of per dimension: the
    sampler evaluates it (and its gradient) at every leapfrog step."""

    def __init__(self, dists: Sequence[Distribution]):
        self.dists = list(dists)
        self._dims = [d.event_dim for d in self.dists]
        self.event_shape = (sum(self._dims),)
        cols: dict[type, list[int]] = {}
        merged: list[tuple[Distribution, list[int]]] = []
        start = 0
        for d, w in zip(self.dists, self._dims):
            span = list(range(start, start + w))
            start += w
            if type(d) in (Beta, LogNormal):
                cols.setdefault(type(d), []).extend(span)
            else:
                merged.append((d, span))
        for kind, span in cols.items():
            parts = [d for d in self.dists if type(d) is kind]
            p, q = ("a", "b") if kind is Beta else ("mu", "sigma")
            merged.append((kind(sum((getattr(d, p) for d in parts), []), sum((getattr(d, q) for d in parts), [])), span))
        self._merged = merged
        self._index: dict = {}  # (group, device) -> column index tensor

    def _columns(self, x, i: int, span: list[int]):
        if span == list(range(span[0], span[-1] + 1)):
            return x[..., span[0] : span[-1] + 1]
        idx = self._index.get((i, x.device))
        if idx is None:
            idx = self._index[(i, x.device)] = torch.tensor(span, device=x.device)
        return x.index_select(-1, idx)

    def sample(self, generator, sample_shape=()):
        parts = [d.sample(generator, sample_shape) for d in self.dists]
        return torch.cat(parts, dim=-1)

    def log_prob(self, x):
        out = 0.0
        for i, (d, span) in enumerate(self._merged):
            out = out + d.log_prob(self._columns(x, i, span))
        return out

    def kernel_groups(self) -> tuple[list, bool]:
        """The merged marginals in the order ``log_prob_and_grad`` sums them,
        from 0.0 (see ``Distribution.kernel_groups``)."""
        return list(self._merged), True

    def has_closed_form_grad(self) -> bool:
        return all(hasattr(d, "log_prob_and_grad") for d, _ in self._merged)

    def log_prob_and_grad(self, x):
        """``(log_prob(x), d log_prob / dx)`` from the marginals' closed
        forms (every marginal must have ``log_prob_and_grad``)."""
        out = 0.0
        grad = torch.empty_like(x)
        for i, (d, span) in enumerate(self._merged):
            lp, g = d.log_prob_and_grad(self._columns(x, i, span))
            out = out + lp
            if span == list(range(span[0], span[-1] + 1)):
                grad[..., span[0] : span[-1] + 1] = g
            else:
                grad.index_copy_(-1, self._index[(i, x.device)], g)
        return out, grad

    def supports(self):
        out: list[Support] = []
        for d in self.dists:
            out.extend(d.supports())
        return out


class Bijector:
    """Elementwise bijection derived from per-dimension supports.

    ``forward`` maps unconstrained u -> theta, ``inverse`` theta -> u, and
    ``forward_log_det`` is ``sum_d log |d theta_d / d u_d|`` at u.
    """

    def __init__(self, supports: Sequence[Support]):
        self._kinds = [s.kind for s in supports]
        self._lo_list = [s.lo if s.lo is not None else 0.0 for s in supports]
        self._hi_list = [s.hi if s.hi is not None else 1.0 for s in supports]
        self._code_list = [{"real": 0, "positive": 1, "interval": 2}[k] for k in self._kinds]
        self.dim = len(self._kinds)
        self._const_cache = _Consts(lo=self._lo_list, hi=self._hi_list, code=self._code_list)
        span = [h - l for l, h in zip(self._lo_list, self._hi_list)]
        self._kind_masks = _Consts(
            real=[float(k == 0) for k in self._code_list], positive=[float(k == 1) for k in self._code_list],
            lo=self._lo_list, span=span, log_span=[math.log(v) if v > 0 else 0.0 for v in span],
        )

    def _consts(self, like: torch.Tensor):
        c = self._const_cache.on(like)
        return c["lo"], c["hi"], c["code"]

    def bounds(self, index: int) -> tuple[float, float]:
        """(lo, hi) support of dimension ``index``."""
        kind = self._kinds[index]
        if kind == "interval":
            return float(self._lo_list[index]), float(self._hi_list[index])
        if kind == "positive":
            return 0.0, math.inf
        return -math.inf, math.inf

    def forward(self, u):
        lo, hi, code = self._consts(u)
        interval = lo + (hi - lo) * torch.sigmoid(u)
        return torch.where(code == 0, u, torch.where(code == 1, torch.exp(u), interval))

    def inverse(self, theta):
        lo, hi, code = self._consts(theta)
        frac = torch.clamp((theta - lo) / (hi - lo), 1e-7, 1.0 - 1e-7)
        interval = torch.log(frac) - torch.log1p(-frac)
        positive = torch.log(torch.clamp(theta, min=1e-37))
        return torch.where(code == 0, theta, torch.where(code == 1, positive, interval))

    def forward_and_grads(self, u):
        """``(theta, dtheta/du, forward_log_det(u), d log_det/du)``, the
        elementwise derivatives in closed form (one pass for the sampler's
        gradient)."""
        c = self._kind_masks.on(u)
        real, pos, span = c["real"] > 0, c["positive"] > 0, c["span"]
        s = torch.sigmoid(u)
        e = torch.exp(u)
        theta = torch.where(real, u, torch.where(pos, e, c["lo"] + span * s))
        dtheta = torch.where(real, 1.0, torch.where(pos, e, span * (s * (1.0 - s))))
        interval = c["log_span"] + torch.nn.functional.logsigmoid(u) + torch.nn.functional.logsigmoid(-u)
        log_det = torch.where(real, 0.0, torch.where(pos, u, interval)).sum(-1)
        dlog_det = torch.where(real, 0.0, torch.where(pos, 1.0, 1.0 - 2.0 * s))
        return theta, dtheta, log_det, dlog_det

    def kernel_table(self) -> tuple[list[int], np.ndarray]:
        """``(codes, k)`` for the u-space density kernel
        (``ops/density_cuda.py``): each dimension's support code (0 real, 1
        positive, 2 interval) and its lo, span and log span (D, 3) in
        float32, the constants of ``forward_and_grads``."""
        c = self._kind_masks.on(torch.empty(0))
        return list(self._code_list), torch.stack([c["lo"], c["span"], c["log_span"]], dim=1).numpy()

    def forward_log_det(self, u):
        lo, hi, code = self._consts(u)
        interval = torch.log(hi - lo) + torch.nn.functional.logsigmoid(u) + torch.nn.functional.logsigmoid(-u)
        per_dim = torch.where(
            code == 0, torch.zeros_like(u), torch.where(code == 1, u, interval)
        )
        return per_dim.sum(-1)


def mcmc_transform(prior: Distribution) -> Bijector:
    """The constrained -> unconstrained bijection from the prior's supports
    (``sbi.utils.mcmc_transform``)."""
    return Bijector(prior.supports())
