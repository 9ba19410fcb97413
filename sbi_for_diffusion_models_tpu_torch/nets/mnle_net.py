"""Mixed Neural Likelihood Estimator (MNLE) as PyTorch modules.

Counterpart of ``sbi_for_diffusion_models_tpu/nets/mnle_net.py``: a
categorical head p(choice | z) and a conditional flow p(rt | z, choice)
(an optional conditional affine layer, then ``num_transforms`` RQ splines,
then a standard-normal base), with the input transforms (log / shifted-log
RT, log-scaled condition dims, z-scoring) and their change-of-variables
terms baked into ``log_prob``.

Ported representations: ``rt_rep`` "log" and "shifted_log", with or without
``censor_rt`` and ``cond_affine``. The pulse representation, the pulse
embedding, ``tail_sharp`` and sampling are not ported yet; they raise
``NotImplementedError``.

Layers are ``nn.Linear`` with PyTorch's (out, in) weight layout. The JAX
package's flax ``Dense`` kernels are (in, out): ``mnle_from_flax_params``
transposes each kernel once when it loads a JAX parameter tree.
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

from ..utils.device import resolve_device
from .spline import (
    clip,
    num_circular_spline_params,
    num_spline_params,
    rq_spline_circular,
    rq_spline_forward,
)

__all__ = [
    "MNLEConfig",
    "MNLENet",
    "MNLE",
    "mnle_from_flax_params",
    "transform_condition",
    "shifted_rt_transform",
    "pulse_grid_split",
    "slot_features",
]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
_LATER = "is not ported to PyTorch yet (see ROADMAP.md, Queue 1)"


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

    def check_ported(self) -> None:
        """Raise ``ValueError`` for invalid configurations and
        ``NotImplementedError`` for the parts not ported yet."""
        if self.rt_rep not in ("log", "shifted_log", "pulse"):
            raise ValueError(f"unknown rt_rep {self.rt_rep!r}")
        if self.rt_rep in ("pulse", "shifted_log") and not self.censor_rt:
            raise ValueError(
                f"rt_rep={self.rt_rep!r} requires censor_rt=True: the censored "
                "atom is handled by the choice head, not the RT flow"
            )
        if self.pulse_dim > 0 and (self.embed_dim > 0 or self.embed_mode == "append"):
            raise NotImplementedError(f"the pulse embedding (pulse_dim > 0) {_LATER}")
        if self.tail_sharp_k > 0:
            raise NotImplementedError(f"tail_sharp (tail_sharp_k > 0) {_LATER}")


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


class MNLENet(nn.Module):
    """The raw network on standardized inputs: ``u`` the z-scored (log-)rt
    scalar (pulse rep: the flow coordinate s), ``c`` the z-scored
    condition."""

    def __init__(self, cfg: MNLEConfig):
        super().__init__()
        cfg.check_ported()
        self.cfg = cfg
        H, C = cfg.hidden_features, cfg.num_categories
        self.cat_net = _MLP(cfg.condition_dim, H, C, cfg.trunk_depth)
        self.flow_trunk = _MLP(cfg.condition_dim + C, H, H, cfg.trunk_depth)
        S = num_circular_spline_params(cfg.num_bins) if cfg.circular else num_spline_params(cfg.num_bins)
        head_in = H + cfg.num_slot_features
        self.spline_heads = nn.ModuleList([nn.Linear(head_in, S) for _ in range(cfg.num_transforms)])
        pulse = cfg.rt_rep == "pulse"
        self.affine_head = nn.Linear(H, 2) if cfg.cond_affine and not pulse else None
        self.pulse_slot_head = nn.Linear(H, cfg.num_pulse_slots) if pulse else None

    def choice_logits(self, c):
        """(..., condition_dim) -> (..., num_categories) log-probabilities."""
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
        f32 = dict(dtype=torch.float32, device=dev)
        self.cond_mean = torch.as_tensor(np.asarray(cond_mean, np.float32)).to(**f32)
        self.cond_std = torch.as_tensor(np.asarray(cond_std, np.float32)).to(**f32)
        self.x_mean = torch.as_tensor(np.asarray(x_mean, np.float32)).to(**f32)
        self.x_std = torch.as_tensor(np.asarray(x_std, np.float32)).to(**f32)
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

    def _standardize_condition(self, x, condition):
        """``(choice, onehot, c)``: the choice, its one-hot and the
        standardized condition."""
        cfg = self.cfg
        choice = x[..., 1].to(torch.int64)
        c = transform_condition(cfg, condition)
        if cfg.z_score_theta:
            c = (c - self.cond_mean) / self.cond_std
        # A comparison, not F.one_hot: one_hot reads the largest index back
        # to the host, a device sync on every call of the potential.
        onehot = (choice[..., None] == torch.arange(cfg.num_categories, device=choice.device)).to(torch.float32)
        return choice, onehot, c

    def standardize(self, x, condition):
        """The outer transforms around the network, shared with the fused
        path: returns ``(t, onehot, c, log_det, barrier, choice)`` with t the
        standardized flow coordinate, c the standardized condition and
        log_det + barrier the change-of-variables terms of t."""
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
        cat_lp = torch.gather(params.choice_logits(c), -1, choice[..., None])[..., 0]
        t_nd = condition[..., cfg.tnd_index]
        k, _, t, log_det, barrier = pulse_grid_split(cfg, rt, t_nd)
        if cfg.z_score_x and not cfg.circular:
            t = (t - self.x_mean) / self.x_std
            log_det = log_det - torch.log(self.x_std)
        slot_lp = torch.gather(params.slot_logits(c, onehot), -1, k[..., None])[..., 0]
        flow_lp = params.flow_log_prob(t, c, onehot, slot_features(cfg, k, t_nd, t.dtype))
        rt_term = slot_lp + flow_lp + log_det + barrier
        return cat_lp + torch.where(choice == cfg.censored_category, 0.0, rt_term)

    def log_prob_fn(self, params: MNLENet, x, condition):
        """log p(x | condition) in plain PyTorch, broadcasting over leading
        axes. x: (..., 2); condition: (..., condition_dim). Returns (...,)."""
        cfg = self.cfg
        if cfg.rt_rep == "pulse":
            return self._pulse_log_prob(params, x, condition)
        t, onehot, c, log_det, barrier, choice = self.standardize(x, condition)
        logits = params.choice_logits(c)
        cat_lp = torch.gather(logits, -1, choice[..., None])[..., 0]
        flow_lp = params.flow_log_prob(t, c, onehot)
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

    def sample_fn(self, *args, **kwargs):
        raise NotImplementedError(f"MNLE sampling {_LATER}")

    def sample(self, *args, **kwargs):
        raise NotImplementedError(f"MNLE sampling {_LATER}")


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
    (cond-affine) ``affine_head`` and (pulse rep) ``pulse_slot_head``, each
    with ``kernel`` (in, out) and ``bias`` (out,). The port's ``nn.Linear``
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

    for name in ("cat_net", "flow_trunk"):
        mlp = getattr(net, name)
        for i, layer in enumerate(mlp.layers):
            put(layer, params[name][f"Dense_{i}"])
    for i, head in enumerate(net.spline_heads):
        put(head, params[f"spline_head_{i}"])
    if net.affine_head is not None:
        put(net.affine_head, params["affine_head"])
    if net.pulse_slot_head is not None:
        put(net.pulse_slot_head, params["pulse_slot_head"])
    # Inference differentiates w.r.t. the inputs only: the weights are
    # constants, as the JAX package's closed-over parameter tree is.
    net.requires_grad_(False)
    net.to(device)
    return MNLE(cfg, net, cond_mean, cond_std, x_mean, x_std, train_meta=train_meta)
