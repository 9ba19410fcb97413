"""Mixed Neural Likelihood Estimator (MNLE) as PyTorch modules.

Counterpart of ``sbi_for_diffusion_models_tpu/nets/mnle_net.py``: a
categorical head p(choice | z) and a conditional flow p(rt | z, choice)
(an optional conditional affine layer, then ``num_transforms`` RQ splines,
then a standard-normal base), with the input transforms (log / shifted-log
RT, log-scaled condition dims, z-scoring) and their change-of-variables
terms baked into ``log_prob``.

Every option of the JAX ``MNLEConfig`` is ported: ``rt_rep`` "log" and
"shifted_log" (with or without ``censor_rt``, ``cond_affine`` and the
left-tail sharpening ``tail_sharp_k``) and "pulse" (both grid anchors), the
pulse embedding (``pulse_dim`` with ``embed_dim`` / ``embed_mode``: the
context the heads read is ``MNLENet.make_context``'s), and sampling
(``MNLE.sample``).

Layers are ``nn.Linear`` with PyTorch's (out, in) weight layout. The JAX
package's flax ``Dense`` kernels are (in, out): ``mnle_from_flax_params``
transposes each kernel once when it loads a JAX parameter tree, and
``mnle_to_flax_params`` transposes it back. ``build_mnle`` makes an untrained
estimator initialised as flax initialises the JAX one.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..constants import PULSE_INTERVAL, T_MAX
from ..utils.device import resolve_device
from ..utils.rng import make_generator
from .spline import (
    clip,
    num_circular_spline_params,
    num_spline_params,
    rq_spline_circular,
    rq_spline_forward,
    rq_spline_inverse,
)

__all__ = [
    "MNLEConfig",
    "MNLENet",
    "MNLE",
    "build_mnle",
    "mnle_from_flax_params",
    "mnle_to_flax_params",
    "transform_condition",
    "shifted_rt_transform",
    "tail_sharp_transform",
    "tail_sharp_inverse",
    "pulse_grid_split",
    "pulse_grid_join",
    "slot_features",
    "pulse_physics_features",
]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
# Horizon times (seconds) of the leak-decayed pulse-evidence summaries (the
# JAX package's ``_FEATURE_HORIZONS``).
_FEATURE_HORIZONS = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0)


@dataclass(frozen=True)
class MNLEConfig:
    """Architecture hyperparameters; the same fields and defaults as the JAX
    ``MNLEConfig``, so a saved model's ``__meta__`` config loads as is."""

    condition_dim: int = 85
    num_categories: int = 3
    hidden_features: int = 128
    num_transforms: int = 10
    num_bins: int = 24
    tail_bound: float = 5.0
    log_transform_x: bool = True
    z_score_theta: bool = True
    z_score_x: bool = True
    trunk_depth: int = 2
    pulse_dim: int = 0
    embed_dim: int = 0
    embed_depth: int = 2
    lam_index: int = 1
    embed_mode: str = "replace"
    censor_rt: bool = False
    censored_category: int = 2
    rt_rep: str = "log"
    log_condition_dims: tuple = ()
    num_pulse_slots: int = 80
    pulse_interval: float = 0.1
    euler_dt: float = 5e-4
    tnd_index: int = 4
    tail_sharp_k: float = 0.0
    tail_sharp_c: float | None = -3.5
    cond_affine: bool = False
    grid_anchor: str = "absolute"

    def __post_init__(self):
        object.__setattr__(self, "log_condition_dims", tuple(self.log_condition_dims))

    @property
    def circular(self) -> bool:
        """Whether the flow is the circular phase flow (pulse rep, absolute
        anchor)."""
        return self.rt_rep == "pulse" and self.grid_anchor == "absolute"

    @property
    def num_slot_features(self) -> int:
        """Width of the pulse rep's flow-head features (0 otherwise)."""
        if self.rt_rep != "pulse":
            return 0
        return 3 if self.grid_anchor == "absolute" else 1

    @property
    def use_embed(self) -> bool:
        """Whether the pulse block goes through the learned ``pulse_embed`` MLP."""
        return self.embed_dim > 0 and self.pulse_dim > 0

    @property
    def context_block(self) -> bool:
        """Whether the heads read [embedding?, physics features] beside (or,
        "replace" mode, instead of) the raw pulse block (JAX ``make_context``)."""
        return self.pulse_dim > 0 and (self.use_embed or self.embed_mode == "append")

    @property
    def context_start(self) -> int:
        """First column of the appended [embedding?, features] block of the
        context: condition_dim ("append") or the theta width ("replace")."""
        return self.condition_dim if self.embed_mode == "append" else self.condition_dim - self.pulse_dim

    @property
    def context_dim(self) -> int:
        """Width D of the context the heads (and the fused kernels) read."""
        if not self.context_block:
            return self.condition_dim
        return self.context_start + (self.embed_dim if self.use_embed else 0) + len(_FEATURE_HORIZONS)

    def validate(self) -> None:
        """Raise ``ValueError`` for invalid configurations."""
        if self.rt_rep not in ("log", "shifted_log", "pulse"):
            raise ValueError(f"unknown rt_rep {self.rt_rep!r}")
        if self.rt_rep in ("pulse", "shifted_log") and not self.censor_rt:
            raise ValueError(
                f"rt_rep={self.rt_rep!r} requires censor_rt=True: the censored "
                "atom is handled by the choice head, not the RT flow"
            )


@functools.lru_cache(maxsize=None)
def _dims_mask(dims: tuple, width: int, device: torch.device) -> torch.Tensor:
    """Boolean (width,) mask of ``dims``, made once per device (not copied
    to the device on every call of the potential)."""
    mask = torch.zeros((width,), dtype=torch.bool)
    mask[list(dims)] = True
    return mask.to(device)


def transform_condition(cfg: MNLEConfig, condition: torch.Tensor) -> torch.Tensor:
    """Log-transform ``cfg.log_condition_dims`` of the condition before
    z-scoring (a conditioning reparameterization: no density correction)."""
    if not cfg.log_condition_dims:
        return condition
    mask = _dims_mask(tuple(cfg.log_condition_dims), condition.shape[-1], condition.device)
    return torch.where(mask, torch.log(torch.clamp(condition, min=1e-37)), condition)


def shifted_rt_transform(cfg: MNLEConfig, rt: torch.Tensor, condition: torch.Tensor):
    """rt -> t = log(rt - t_nd) with t_nd = condition[..., tnd_index].

    Returns ``(t, log_det, barrier)``: log_det = log|dt/drt| = -t and a
    linear barrier (slope -50 per second below the onset) that keeps a
    gradient on the floor's plateau."""
    tau = condition[..., cfg.tnd_index]
    dt = rt - tau
    floor = 1e-6
    t = torch.log(torch.clamp(dt, min=floor))
    barrier = -50.0 * F.relu(floor - dt)
    return t, -t, barrier


def tail_sharp_transform(cfg: MNLEConfig, t: torch.Tensor):
    """Left-tail sharpening of the standardized flow coordinate:
    ``(phi(t), log|phi'(t)|)`` with phi(t) = t - e / k, e = exp(min(-k (t -
    c), 30)), and log|phi'| = log1p(e). The clamp keeps far-below-onset
    proposals finite (a huge negative log-density with finite gradients)."""
    k = cfg.tail_sharp_k
    e = torch.exp(torch.clamp(-k * (t - cfg.tail_sharp_c), max=30.0))
    return t - e / k, torch.log1p(e)


def tail_sharp_inverse(cfg: MNLEConfig, y: torch.Tensor) -> torch.Tensor:
    """Inverse of ``tail_sharp_transform`` by 30 Newton steps from a
    branch-aware start (the identity above c, the asymptote y ~ -exp(-k (t -
    c)) / k below it); phi' >= 1 keeps the steps bounded. No early exit, so
    no step reads anything back to the host."""
    k, c = cfg.tail_sharp_k, cfg.tail_sharp_c
    t = torch.where(y > c, y, c - torch.log1p(k * torch.clamp(c - y, min=0.0)) / k)
    for _ in range(30):
        e = torch.exp(torch.clamp(-k * (t - c), max=30.0))
        t = t - (t - e / k - y) / (1.0 + e)
    return t


def pulse_grid_split(cfg: MNLEConfig, rt: torch.Tensor, t_nd: torch.Tensor):
    """(pulse rep) rt -> ``(k, phi, s, ds, barrier)``: the slot k (int64),
    the within-slot phase phi in (0, 1), the flow coordinate s, log|ds/drt|
    and a barrier.

    Absolute anchor: k = floor(rt / Delta), s = phi (the circular flow takes
    the phase itself), ds = -log Delta, no barrier; all theta-free. tnd
    anchor: k = floor((rt - t_nd) / Delta), s = logit(phi), ds = log|ds/drt|
    and a quadratic barrier where rt <= t_nd + euler_dt."""
    delta = cfg.pulse_interval
    absolute = cfg.grid_anchor == "absolute"
    dtt = rt if absolute else rt - t_nd
    u = torch.maximum(dtt, dtt.new_tensor(cfg.euler_dt)) / delta
    k = torch.clamp(torch.floor(u).to(torch.int64), 0, cfg.num_pulse_slots - 1)
    phi = clip(u - k.to(u.dtype), 1e-6, 1.0 - 1e-6)
    if absolute:
        return k, phi, phi, torch.full_like(phi, -math.log(delta)), torch.zeros_like(rt)
    barrier = -((F.relu(cfg.euler_dt - dtt) / delta) ** 2) * 1e4
    s = torch.log(phi) - torch.log1p(-phi)
    ds = -torch.log(phi) - torch.log1p(-phi) - math.log(delta)
    return k, phi, s, ds, barrier


def pulse_grid_join(cfg: MNLEConfig, k: torch.Tensor, s: torch.Tensor, t_nd: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pulse_grid_split`` for sampling: (slot k, flow coordinate
    s) -> rt. Absolute anchor: s is the phase; tnd anchor: s = logit(phi)
    and the grid starts at t_nd."""
    if cfg.circular:
        return (k.to(s.dtype) + clip(s, 1e-6, 1.0 - 1e-6)) * cfg.pulse_interval
    phi = clip(torch.sigmoid(s), 1e-6, 1.0 - 1e-6)
    return t_nd + (k.to(s.dtype) + phi) * cfg.pulse_interval


@functools.lru_cache(maxsize=None)
def _feature_grid(pulse_dim: int, device: torch.device):
    """(lag (6, P), inside (6, P)): T - t_p for every horizon T and pulse
    time t_p = p x PULSE_INTERVAL, and where t_p < T; made once per device."""
    t_p = torch.arange(pulse_dim, dtype=torch.float32) * PULSE_INTERVAL
    horizons = torch.tensor(_FEATURE_HORIZONS, dtype=torch.float32)[:, None]
    return (horizons - t_p).to(device), (t_p < horizons).to(device)


def pulse_physics_features(c_raw: torch.Tensor, theta_dim: int, pulse_dim: int, lam_index: int, *,
                           lam_tangent: bool = False):
    """Leak-decayed pulse-evidence summaries (..., 6), one per horizon T in
    ``_FEATURE_HORIZONS``: F_T / sqrt(G_T + 1e-6) with F_T = sum_p w_p s_p,
    G_T = sum_p w_p^2 and w_p = exp(-|lambda| (T - t_p)) for pulses before T
    (0 after), lambda = c_raw[..., lam_index] raw and s the pulse block of
    the raw condition. With ``lam_tangent`` also their derivative w.r.t.
    |lambda| (..., 6), in closed form (dw_p = -(T - t_p) w_p)."""
    lag, inside = _feature_grid(pulse_dim, c_raw.device)
    lam = c_raw[..., lam_index]
    # |lambda| with JAX's derivative at 0 (1, where torch.abs gives 0).
    lam = torch.where(lam >= 0, lam, -lam)[..., None, None]
    s = c_raw[..., None, theta_dim : theta_dim + pulse_dim]
    w = torch.where(inside, torch.exp(-lam * lag), 0.0)
    num = (w * s).sum(-1)
    sq = (w * w).sum(-1) + 1e-6
    denom = torch.sqrt(sq)
    feats = num / denom
    if not lam_tangent:
        return feats
    dw = -lag * w
    d_num = (dw * s).sum(-1)
    d_sq = 2.0 * (dw * w).sum(-1)
    return feats, d_num / denom - 0.5 * num * d_sq / (sq * denom)


def slot_features(cfg: MNLEConfig, k: torch.Tensor, t_nd: torch.Tensor, dtype) -> torch.Tensor:
    """(pulse rep) flow-head features (..., F): the normalized slot index
    (k, an integer or its float value) and, for the absolute anchor, sin and
    cos of t_nd's grid phase 2 pi ((t_nd / Delta) mod 1), computed in
    ``dtype`` as the JAX package computes them."""
    k_norm = ((k.to(dtype) + 0.5) / cfg.num_pulse_slots)[..., None]
    if cfg.grid_anchor != "absolute":
        return k_norm
    ang = 2.0 * math.pi * torch.remainder(t_nd.to(dtype) / cfg.pulse_interval, 1.0)
    return torch.cat([k_norm, torch.sin(ang)[..., None], torch.cos(ang)[..., None]], -1)


class _MLP(nn.Module):
    """``depth`` ReLU layers of width ``hidden`` then a linear output layer
    (flax ``Dense_0 .. Dense_depth``)."""

    def __init__(self, in_features: int, hidden: int, out: int, depth: int):
        super().__init__()
        widths = [in_features] + [hidden] * depth
        self.layers = nn.ModuleList(
            [nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:])] + [nn.Linear(widths[-1], out)]
        )

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)

    def jvp(self, x, dx):
        """(forward(x), its derivative along the tangent dx): the forward's
        own operations, with each ReLU's mask applied to the tangent."""
        for layer in self.layers[:-1]:
            pre = layer(x)
            x = F.relu(pre)
            dx = torch.where(pre > 0, F.linear(dx, layer.weight), 0.0)
        return self.layers[-1](x), F.linear(dx, self.layers[-1].weight)


class MNLENet(nn.Module):
    """The raw network on standardized inputs: ``u`` the z-scored (log-)rt
    scalar (pulse rep: the flow coordinate s), ``c`` the context
    (``make_context`` of the z-scored condition)."""

    def __init__(self, cfg: MNLEConfig):
        super().__init__()
        cfg.validate()
        if cfg.tail_sharp_k > 0 and cfg.tail_sharp_c is None:
            raise ValueError("tail_sharp_c=None is a training-time sentinel: train_mnle resolves it before the "
                             "network is built")
        self.cfg = cfg
        H, C, D = cfg.hidden_features, cfg.num_categories, cfg.context_dim
        self.cat_net = _MLP(D, H, C, cfg.trunk_depth)
        self.flow_trunk = _MLP(D + C, H, H, cfg.trunk_depth)
        S = num_circular_spline_params(cfg.num_bins) if cfg.circular else num_spline_params(cfg.num_bins)
        head_in = H + cfg.num_slot_features
        self.spline_heads = nn.ModuleList([nn.Linear(head_in, S) for _ in range(cfg.num_transforms)])
        pulse = cfg.rt_rep == "pulse"
        self.affine_head = nn.Linear(H, 2) if cfg.cond_affine and not pulse else None
        self.pulse_slot_head = nn.Linear(H, cfg.num_pulse_slots) if pulse else None
        self.pulse_embed = None
        if cfg.use_embed:
            self.pulse_embed = _MLP(cfg.pulse_dim + len(_FEATURE_HORIZONS), H, cfg.embed_dim, cfg.embed_depth)

    def make_context(self, c_std, c_raw, lam_tangent: bool = False):
        """The heads' input: the z-scored condition ``c_std``, with the pulse
        block ("replace": raw pulses swapped for [embedding, physics
        features]; "append": raw pulses kept, [embedding?, features]
        appended) when ``cfg.context_block``. The features read |lambda| off
        the raw condition ``c_raw``. With ``lam_tangent``, returns ``(ctx,
        tangent)``: the derivative of the appended block (the columns from
        ``cfg.context_start`` on) w.r.t. ``c_raw[..., lam_index]`` (None
        without a block), for the closed-form potential gradient."""
        cfg = self.cfg
        if not cfg.context_block:
            return (c_std, None) if lam_tangent else c_std
        k = cfg.condition_dim - cfg.pulse_dim
        feats = pulse_physics_features(c_raw, k, cfg.pulse_dim, cfg.lam_index, lam_tangent=lam_tangent)
        if lam_tangent:
            feats, d_feats = feats
        parts = [c_std] if cfg.embed_mode == "append" else [c_std[..., :k]]
        tangents = []
        if self.pulse_embed is not None:
            inp = torch.cat([c_std[..., k:], feats], -1)
            if lam_tangent:
                emb, d_emb = self.pulse_embed.jvp(inp, torch.cat([torch.zeros_like(c_std[..., k:]), d_feats], -1))
                tangents.append(d_emb)
            else:
                emb = self.pulse_embed(inp)
            parts.append(emb)
        parts.append(feats)
        ctx = torch.cat(parts, -1)
        if not lam_tangent:
            return ctx
        # d|lambda| / d lambda: -1 below 0, 1 from 0 up (JAX's abs).
        sign = torch.where(c_raw[..., cfg.lam_index] >= 0, 1.0, -1.0)[..., None]
        return ctx, torch.cat(tangents + [d_feats], -1) * sign

    def choice_logits(self, c):
        """(..., context_dim) -> (..., num_categories) log-probabilities."""
        return F.log_softmax(self.cat_net(c), dim=-1)

    def _trunk_emb(self, c, choice_onehot):
        return F.relu(self.flow_trunk(torch.cat([c, choice_onehot], dim=-1)))

    def slot_logits(self, c, choice_onehot):
        """(pulse rep) (..., condition_dim), (..., C) -> (..., num_pulse_slots)
        log P(k | c, choice)."""
        return F.log_softmax(self.pulse_slot_head(self._trunk_emb(c, choice_onehot)), dim=-1)

    def flow_params(self, c, choice_onehot, k_feat=None):
        emb = self._trunk_emb(c, choice_onehot)
        if k_feat is not None:
            emb = torch.cat([emb, k_feat], dim=-1)
        params = [head(emb) for head in self.spline_heads]
        affine = None
        if self.affine_head is not None:
            a = self.affine_head(emb)
            affine = (a[..., 0], torch.clamp(a[..., 1], -7.0, 7.0))
        return params, affine

    def flow_log_prob(self, u, c, choice_onehot, k_feat=None):
        """log p(u | c, choice) for scalar u (shape (...,)); the pulse rep
        conditions the heads on the slot features ``k_feat``."""
        params, affine = self.flow_params(c, choice_onehot, k_feat)
        z = u
        log_det = torch.zeros_like(u)
        if self.cfg.circular:
            # Circular phase flow, uniform base on [0, 1): log p(z) = 0.
            for p in params:
                z, ld = rq_spline_circular(z, p, num_bins=self.cfg.num_bins)
                log_det = log_det + ld
            return log_det
        if affine is not None:
            mu, ls = affine
            z = (z - mu) * torch.exp(-ls)
            log_det = log_det - ls
        for p in params:
            z, ld = rq_spline_forward(z, p, num_bins=self.cfg.num_bins, tail_bound=self.cfg.tail_bound)
            log_det = log_det + ld
        return -_LOG_SQRT_2PI - 0.5 * z**2 + log_det

    def flow_sample(self, generator, c, choice_onehot, k_feat=None):
        """One draw u ~ p(u | c, choice) per row (c: (..., context_dim)): the
        base (standard normal; uniform on [0, 1) for the circular flow)
        drawn from ``generator``, then the flow's inverse."""
        params, affine = self.flow_params(c, choice_onehot, k_feat)
        shape, dev = c.shape[:-1], c.device
        if self.cfg.circular:
            z = torch.rand(shape, generator=generator, device=dev)
            for p in reversed(params):
                z, _ = rq_spline_circular(z, p, num_bins=self.cfg.num_bins, inverse=True)
            return z
        z = torch.randn(shape, generator=generator, device=dev)
        for p in reversed(params):
            z, _ = rq_spline_inverse(z, p, num_bins=self.cfg.num_bins, tail_bound=self.cfg.tail_bound)
        if affine is not None:
            mu, ls = affine
            z = z * torch.exp(ls) + mu
        return z


def _categorical(generator: torch.Generator, logp: torch.Tensor) -> torch.Tensor:
    """One index per row of the log-probabilities ``logp`` (..., K), by the
    Gumbel-max rule on uniforms from ``generator`` (no read-back to the
    host, as ``torch.multinomial`` may need)."""
    u = torch.rand(logp.shape, generator=generator, device=logp.device)
    return torch.argmax(logp - torch.log(-torch.log(u)), dim=-1)


class MNLE:
    """Trained estimator: the network, the standardization stats and the
    log-prob entry points.

    ``x[..., 0]`` is rt in seconds (or log-rt if the pipeline logged it),
    ``x[..., 1]`` the choice in {0, 1, 2}; ``condition`` is z = [theta(5),
    pulse_sides(P)]. ``params`` is the network module, passed explicitly to
    ``log_prob_fn`` as the JAX package passes its parameter tree.
    """

    def __init__(self, cfg: MNLEConfig, net: MNLENet, cond_mean, cond_std, x_mean, x_std,
                 train_meta: dict | None = None):
        self.cfg = cfg
        self.net = net
        dev = next(net.parameters()).device

        def stat(v):
            if not isinstance(v, torch.Tensor):
                v = torch.as_tensor(np.asarray(v, np.float32))
            return v.detach().to(dtype=torch.float32, device=dev)

        self.cond_mean, self.cond_std = stat(cond_mean), stat(cond_std)
        self.x_mean, self.x_std = stat(x_mean), stat(x_std)
        self.train_meta = train_meta

    @property
    def params(self) -> MNLENet:
        return self.net

    @property
    def device(self) -> torch.device:
        return self.cond_mean.device

    def to(self, device) -> "MNLE":
        """Move the network and the stats to ``device`` (in place)."""
        self.net.to(device)
        for name in ("cond_mean", "cond_std", "x_mean", "x_std"):
            setattr(self, name, getattr(self, name).to(device))
        return self

    def _condition(self, condition):
        """The standardized condition: log dims, then z-scoring."""
        c = transform_condition(self.cfg, condition)
        return (c - self.cond_mean) / self.cond_std if self.cfg.z_score_theta else c

    def _standardize_condition(self, x, condition):
        """``(choice, onehot, c)``: the choice, its one-hot and the
        standardized condition."""
        cfg = self.cfg
        choice = x[..., 1].to(torch.int64)
        c = self._condition(condition)
        # A comparison, not F.one_hot: one_hot reads the largest index back
        # to the host, a device sync on every call of the potential.
        onehot = (choice[..., None] == torch.arange(cfg.num_categories, device=choice.device)).to(torch.float32)
        return choice, onehot, c

    def standardize(self, x, condition):
        """The outer transforms around the network, shared with the fused
        path: returns ``(t, onehot, c, log_det, barrier, choice)`` with t the
        standardized flow coordinate (after the tail sharpening, when
        ``tail_sharp_k > 0``), c the standardized condition (the context is
        ``net.make_context(c, condition)``) and log_det + barrier the
        change-of-variables terms of t."""
        cfg = self.cfg
        rt = x[..., 0]
        choice, onehot, c = self._standardize_condition(x, condition)
        log_det = torch.zeros_like(rt)
        barrier = torch.zeros_like(rt)
        t = rt
        if cfg.rt_rep == "shifted_log":
            t, ld, barrier = shifted_rt_transform(cfg, rt, condition)
            log_det = log_det + ld
        elif cfg.log_transform_x:
            t_safe = torch.clamp(t, min=1e-37)
            log_det = log_det - torch.log(t_safe)
            t = torch.log(t_safe)
        if cfg.z_score_x:
            t = (t - self.x_mean) / self.x_std
            log_det = log_det - torch.log(self.x_std)
        if cfg.tail_sharp_k > 0:
            t, ld = tail_sharp_transform(cfg, t)
            log_det = log_det + ld
        return t, onehot, c, log_det, barrier, choice

    def standardize_pulse(self, x, condition):
        """(pulse rep, absolute anchor) The rows of the fused path and of
        the potential: returns ``(phi, onehot, c, kf, kv, ds, choice)`` with
        phi the within-slot phase, kf the flow-head features [k_norm, sin,
        cos], kv the slot index as a float and ds = -log Delta on the rows
        that are not censored (0 on censored rows)."""
        cfg = self.cfg
        rt = x[..., 0]
        choice, onehot, c = self._standardize_condition(x, condition)
        t_nd = condition[..., cfg.tnd_index]
        k, phi, _, ds, _ = pulse_grid_split(cfg, rt, t_nd)
        kf = slot_features(cfg, k, t_nd, phi.dtype)
        ds = torch.where(choice == cfg.censored_category, 0.0, ds)
        return phi, onehot, c, kf, k.to(phi.dtype), ds, choice

    def _pulse_log_prob(self, params: MNLENet, x, condition):
        """The pulse branch of ``log_prob_fn``: P(choice) P(k | choice) and
        the phase flow, on the rows that are not censored."""
        cfg = self.cfg
        rt = x[..., 0]
        choice, onehot, c = self._standardize_condition(x, condition)
        ctx = params.make_context(c, condition)
        cat_lp = torch.gather(params.choice_logits(ctx), -1, choice[..., None])[..., 0]
        t_nd = condition[..., cfg.tnd_index]
        k, _, t, log_det, barrier = pulse_grid_split(cfg, rt, t_nd)
        if cfg.z_score_x and not cfg.circular:
            t = (t - self.x_mean) / self.x_std
            log_det = log_det - torch.log(self.x_std)
        slot_lp = torch.gather(params.slot_logits(ctx, onehot), -1, k[..., None])[..., 0]
        flow_lp = params.flow_log_prob(t, ctx, onehot, slot_features(cfg, k, t_nd, t.dtype))
        rt_term = slot_lp + flow_lp + log_det + barrier
        return cat_lp + torch.where(choice == cfg.censored_category, 0.0, rt_term)

    def log_prob_fn(self, params: MNLENet, x, condition):
        """log p(x | condition) in plain PyTorch, broadcasting over leading
        axes. x: (..., 2); condition: (..., condition_dim). Returns (...,)."""
        cfg = self.cfg
        if cfg.rt_rep == "pulse":
            return self._pulse_log_prob(params, x, condition)
        t, onehot, c, log_det, barrier, choice = self.standardize(x, condition)
        ctx = params.make_context(c, condition)
        cat_lp = torch.gather(params.choice_logits(ctx), -1, choice[..., None])[..., 0]
        flow_lp = params.flow_log_prob(t, ctx, onehot)
        if cfg.censor_rt:
            # Censored trials keep P(choice | z) only. The JAX package
            # multiplies by the not-censored mask; a where keeps a
            # non-finite flow term of a censored row (0 * -inf) out of the
            # value and the gradient, and equals the product otherwise.
            censored = choice == cfg.censored_category
            rt_term = torch.where(censored, 0.0, flow_lp + log_det + barrier)
            return cat_lp + rt_term
        return cat_lp + flow_lp + log_det + barrier

    def log_prob(self, x, condition):
        return self.log_prob_fn(self.net, x, condition)

    def dispatch_log_prob(self, kernel: str = "auto"):
        """The log-prob implementation for the MCMC hot path (kernel: "auto"
        | "xla" | "pallas"). "pallas" is the fused CUDA forward/backward
        pair (K2/K3, or K2p/K3p for the pulse rep; ``ops/mnle_cuda.py``),
        whose CPU route is the plain row function; "xla" is ``log_prob_fn``;
        "auto" takes the kernels for CUDA tensors and ``log_prob_fn`` for CPU
        tensors. The pulse rep's tnd anchor has no fused path: "auto" gives
        ``log_prob_fn`` for it and "pallas" raises. The returned
        ``fn(x, condition)`` differentiates w.r.t. its inputs."""
        choice = kernel or "auto"
        if choice not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown log-prob kernel {choice!r}")
        plain = lambda x, condition: self.log_prob_fn(self.net, x, condition)  # noqa: E731
        if choice == "xla" or (choice == "auto" and self.cfg.rt_rep == "pulse" and not self.cfg.circular):
            return plain
        from ..ops.mnle_cuda import make_fused_logprob

        fused = make_fused_logprob(self)
        if choice == "pallas":
            return fused

        def auto(x, condition):
            return (fused if x.is_cuda else plain)(x, condition)

        auto.weights = fused.weights
        return auto

    def sample_fn(self, params: MNLENet, generator, condition):
        """One (rt, choice) draw per condition row: condition (...,
        condition_dim) -> (..., 2), rt in seconds (T_MAX on censored draws).
        ``generator`` is a ``torch.Generator`` on the condition's device, or
        a seed for one. The choice is drawn from the categorical head (and,
        for the pulse rep, the slot from the slot head), then the flow's
        base, pushed through the inverse splines, the cond-affine head, the
        tail-sharp inverse, the de-standardisation and the RT transform's
        inverse. The streams are not the JAX package's: draws agree with
        its ``sample_fn`` in distribution."""
        cfg = self.cfg
        gen = generator if isinstance(generator, torch.Generator) else make_generator(generator, condition.device)
        with torch.no_grad():
            ctx = params.make_context(self._condition(condition), condition)
            choice = _categorical(gen, params.choice_logits(ctx))
            onehot = (choice[..., None] == torch.arange(cfg.num_categories, device=choice.device)).to(torch.float32)
            if cfg.rt_rep == "pulse":
                t_nd = condition[..., cfg.tnd_index]
                k = _categorical(gen, params.slot_logits(ctx, onehot))
                u = params.flow_sample(gen, ctx, onehot, slot_features(cfg, k, t_nd, torch.float32))
                if cfg.z_score_x and not cfg.circular:
                    u = u * self.x_std + self.x_mean
                t = pulse_grid_join(cfg, k, u, t_nd)
            else:
                t = params.flow_sample(gen, ctx, onehot)
                if cfg.tail_sharp_k > 0:
                    t = tail_sharp_inverse(cfg, t)
                if cfg.z_score_x:
                    t = t * self.x_std + self.x_mean
                if cfg.rt_rep == "shifted_log":
                    t = condition[..., cfg.tnd_index] + torch.exp(t)
                elif cfg.log_transform_x:
                    t = torch.exp(t)
            if cfg.censor_rt:
                t = torch.where(choice == cfg.censored_category, T_MAX, t)
            return torch.stack([t, choice.to(t.dtype)], dim=-1)

    def sample(self, generator, condition):
        """``sample_fn`` with the estimator's own network; ``condition`` is
        moved to the estimator's device."""
        condition = torch.as_tensor(condition, dtype=torch.float32).to(self.device)
        return self.sample_fn(self.net, generator, condition)


def mnle_from_flax_params(
    cfg: MNLEConfig,
    params: Mapping[str, Any],
    cond_mean,
    cond_std,
    x_mean,
    x_std,
    *,
    train_meta: dict | None = None,
    device=None,
) -> MNLE:
    """Build the port's ``MNLE`` from a JAX parameter tree.

    ``params`` is the flax tree as nested dicts of numpy arrays:
    ``cat_net/Dense_i``, ``flow_trunk/Dense_i``, ``spline_head_i``,
    (cond-affine) ``affine_head``, (pulse rep) ``pulse_slot_head`` and (pulse
    embedding) ``pulse_embed/Dense_i``, each with ``kernel`` (in, out) and
    ``bias`` (out,). The port's ``nn.Linear``
    layers keep PyTorch's (out, in) layout, so each kernel is transposed
    here; biases are copied as they are. The weights come back with
    ``requires_grad=False``, on ``device`` (default: the CUDA card).
    """
    net = MNLENet(cfg)
    device = resolve_device(device)

    def put(linear: nn.Linear, leaf) -> None:
        kernel = np.asarray(leaf["kernel"], np.float32)
        bias = np.asarray(leaf["bias"], np.float32)
        if kernel.shape != (linear.in_features, linear.out_features):
            raise ValueError(
                f"kernel shape {kernel.shape} != ({linear.in_features}, {linear.out_features})"
            )
        with torch.no_grad():
            linear.weight.copy_(torch.from_numpy(kernel.T.copy()))
            linear.bias.copy_(torch.from_numpy(bias))

    for path, linear in _named_linears(net):
        leaf = params
        for name in path:
            leaf = leaf[name]
        put(linear, leaf)
    # Inference differentiates w.r.t. the inputs only: the weights are
    # constants, as the JAX package's closed-over parameter tree is.
    net.requires_grad_(False)
    net.to(device)
    return MNLE(cfg, net, cond_mean, cond_std, x_mean, x_std, train_meta=train_meta)


def _named_linears(net: MNLENet):
    """(path in the flax tree, layer) of every ``nn.Linear`` of the net, in
    the flax tree's sorted order."""
    out = []
    if net.affine_head is not None:
        out.append((("affine_head",), net.affine_head))
    for name in ("cat_net", "flow_trunk", "pulse_embed"):
        if getattr(net, name) is not None:
            out += [((name, f"Dense_{i}"), layer) for i, layer in enumerate(getattr(net, name).layers)]
    if net.pulse_slot_head is not None:
        out.append((("pulse_slot_head",), net.pulse_slot_head))
    heads = [((f"spline_head_{i}",), head) for i, head in enumerate(net.spline_heads)]
    return out + sorted(heads, key=lambda kv: kv[0])


def mnle_to_flax_params(estimator: MNLE) -> dict:
    """The estimator's weights as the JAX parameter tree: nested dicts of
    numpy arrays named as flax names them (``cat_net/Dense_i``,
    ``flow_trunk/Dense_i``, ``spline_head_i``, ``affine_head``,
    ``pulse_slot_head``, ``pulse_embed/Dense_i``), each with ``kernel`` transposed back to (in, out),
    C-contiguous, and ``bias``. The inverse of ``mnle_from_flax_params``."""
    tree: dict = {}
    for path, linear in _named_linears(estimator.net):
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = {
            "bias": linear.bias.detach().cpu().numpy().copy(),
            "kernel": np.ascontiguousarray(linear.weight.detach().cpu().numpy().T),
        }
    return tree


_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated at +-2


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default ``Dense`` kernel init, in place: a normal truncated at
    +-2 sigma with variance 1 / fan_in after truncation, i.e. sigma =
    sqrt(1 / fan_in) / 0.87962566. Drawn by inverting the normal CDF on
    ``generator``'s device."""
    sigma = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(weight.shape, generator=generator, device=generator.device, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0)
    with torch.no_grad():
        weight.copy_((sigma * z.clamp(-2.0, 2.0)).to(torch.float32))


def build_mnle(
    generator_or_seed,
    cfg: MNLEConfig,
    *,
    cond_mean=None,
    cond_std=None,
    x_mean=0.0,
    x_std=1.0,
    device=None,
) -> MNLE:
    """An untrained MNLE with the given standardization stats, on ``device``
    (default: the CUDA card), its weights drawn from ``generator_or_seed`` (a
    ``torch.Generator`` or an integer seed).

    Initialised as flax initialises the JAX net, not as ``nn.Linear`` does:
    every kernel ``lecun_normal``, every bias zero, and the cond-affine
    head's kernel zero too, so that layer is the identity at the start. The
    weights require gradients."""
    cfg.validate()
    device = resolve_device(device)
    if isinstance(generator_or_seed, torch.Generator):
        gen = generator_or_seed
    else:
        gen = make_generator(generator_or_seed, device)
    net = MNLENet(cfg)
    for _, linear in _named_linears(net):
        nn.init.zeros_(linear.bias)
        if linear is net.affine_head:
            nn.init.zeros_(linear.weight)
        else:
            _lecun_normal_(linear.weight, gen)
    net.requires_grad_(True)
    net.to(device)
    if cond_mean is None:
        cond_mean = np.zeros((cfg.condition_dim,), np.float32)
    if cond_std is None:
        cond_std = np.ones((cfg.condition_dim,), np.float32)
    return MNLE(cfg, net, cond_mean, cond_std, x_mean, x_std)
