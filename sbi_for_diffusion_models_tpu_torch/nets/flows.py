"""Multi-dimensional conditional neural spline flow (PyTorch port).

Counterpart of ``sbi_for_diffusion_models_tpu/nets/flows.py``: a
d-dimensional rational-quadratic-spline coupling flow with context
conditioning, the density estimator of ``snpe.py`` as a posterior q(theta |
x) (SNPE) or a likelihood q(x | theta) (SNLE).

Alternating-mask coupling layers: layer t passes the dims with ``i % 2 ==
t % 2`` through and transforms the others by an RQ spline whose parameters
come from an MLP (Dense -> ReLU -> Dense -> ReLU -> Dense(d * n_params)) of
``where(mask, z, 0) || context``; for d == 1 every layer transforms the
single dim from the context alone. The splines are ``nets/spline.py``'s.

The weights carry across from the JAX package: ``flow_from_flax_params``
builds the port's estimator from a flax parameter tree
(``conditioner_t/layers_{0,2,4}``, kernels (in, out)), and
``flow_to_flax_params`` gives it back. Training (``fit_flow``) is
``torch.optim.Adam`` with the JAX package's validation split and early
stopping; its random streams are the port's own (``utils/rng``).
"""

from __future__ import annotations

import copy
import math
import time
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from ..utils.device import resolve_device
from ..utils.rng import as_seed, child_seed, make_generator
from .mnle_net import _lecun_normal_
from .spline import num_spline_params, rq_spline_forward, rq_spline_inverse

__all__ = ["NSFConfig", "CouplingNSF", "FlowEstimator", "build_flow", "fit_flow", "flow_from_flax_params",
           "flow_to_flax_params"]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


@dataclass(frozen=True)
class NSFConfig:
    dim: int
    context_dim: int
    hidden_features: int = 64
    num_transforms: int = 5
    num_bins: int = 16
    tail_bound: float = 5.0


class CouplingNSF(nn.Module):
    """Stack of RQ-spline coupling transforms with alternating masks."""

    def __init__(self, cfg: NSFConfig):
        super().__init__()
        self.cfg = cfg
        d, H = cfg.dim, cfg.hidden_features
        n_params = num_spline_params(cfg.num_bins)
        masks = [np.zeros(1, bool) if d == 1 else np.arange(d) % 2 == t % 2 for t in range(cfg.num_transforms)]
        self.register_buffer("masks", torch.as_tensor(np.stack(masks)))  # True: passed through
        self.conditioners = nn.ModuleList([
            nn.Sequential(nn.Linear(d + cfg.context_dim, H), nn.ReLU(), nn.Linear(H, H), nn.ReLU(),
                          nn.Linear(H, d * n_params))
            for _ in range(cfg.num_transforms)
        ])

    def _params_for(self, t: int, z, context):
        """Spline params (..., d, n_params) of layer t from its pass-through
        dims and the context."""
        cfg = self.cfg
        inp = torch.cat([torch.where(self.masks[t], z, 0.0), context], -1)
        raw = self.conditioners[t](inp)
        return raw.reshape(*raw.shape[:-1], cfg.dim, num_spline_params(cfg.num_bins))

    def log_prob(self, theta, context):
        """log q(theta | context); theta (..., d), context (..., c) -> (...)."""
        cfg = self.cfg
        z = theta
        log_det = torch.zeros(theta.shape[:-1], dtype=theta.dtype, device=theta.device)
        for t in range(cfg.num_transforms):
            mask = self.masks[t]
            z_new, ld = rq_spline_forward(z, self._params_for(t, z, context), num_bins=cfg.num_bins,
                                          tail_bound=cfg.tail_bound)
            z = torch.where(mask, z, z_new)
            log_det = log_det + torch.where(mask, 0.0, ld).sum(-1)
        return (-_LOG_SQRT_2PI - 0.5 * z**2).sum(-1) + log_det

    def sample(self, generator: torch.Generator, context):
        """One draw per context row: context (..., c) -> (..., d)."""
        cfg = self.cfg
        z = torch.randn((*context.shape[:-1], cfg.dim), generator=generator, device=context.device,
                        dtype=context.dtype)
        for t in reversed(range(cfg.num_transforms)):
            mask = self.masks[t]
            z_new, _ = rq_spline_inverse(z, self._params_for(t, z, context), num_bins=cfg.num_bins,
                                         tail_bound=cfg.tail_bound)
            z = torch.where(mask, z, z_new)
        return z

    def forward(self, theta, context):
        return self.log_prob(theta, context)


@dataclass
class FlowEstimator:
    """A conditional flow with the z-scoring of the modelled variable (y)
    and of the context baked into ``log_prob`` and ``sample``; the stats are
    float32 tensors on the network's device. ``train_meta`` holds what
    ``fit_flow`` measured (None for an untrained flow)."""

    cfg: NSFConfig
    net: CouplingNSF
    y_mean: torch.Tensor
    y_std: torch.Tensor
    c_mean: torch.Tensor
    c_std: torch.Tensor
    train_meta: Optional[dict] = field(default=None, compare=False)

    @property
    def params(self) -> CouplingNSF:
        """The network (the JAX package's parameter tree)."""
        return self.net

    @property
    def device(self) -> torch.device:
        return self.y_mean.device

    def log_prob_fn(self, params: CouplingNSF, y, context):
        u = (y - self.y_mean) / self.y_std
        c = (context - self.c_mean) / self.c_std
        return params.log_prob(u, c) - torch.log(self.y_std).sum()

    def log_prob(self, y, context):
        y = torch.as_tensor(y, dtype=torch.float32).to(self.device)
        context = torch.as_tensor(context, dtype=torch.float32).to(self.device)
        return self.log_prob_fn(self.net, y, context)

    def sample(self, generator, context):
        """One draw per context row; ``generator`` is a ``torch.Generator``
        on the estimator's device, or a seed for one."""
        context = torch.as_tensor(context, dtype=torch.float32).to(self.device)
        gen = generator if isinstance(generator, torch.Generator) else make_generator(generator, self.device)
        with torch.no_grad():
            u = self.net.sample(gen, (context - self.c_mean) / self.c_std)
        return u * self.y_std + self.y_mean


def _stat(v, n: int, fill: float, device) -> torch.Tensor:
    if v is None:
        return torch.full((n,), fill, dtype=torch.float32, device=device)
    return torch.as_tensor(v, dtype=torch.float32).detach().to(device)


def build_flow(generator_or_seed, cfg: NSFConfig, *, device=None, **stats) -> FlowEstimator:
    """An untrained flow on ``device`` (default: the CUDA card), initialised
    as flax initialises the JAX one (kernels ``lecun_normal`` from
    ``generator_or_seed``, a ``torch.Generator`` or a seed; biases zero),
    with the stats ``y_mean``, ``y_std``, ``c_mean``, ``c_std`` (default 0
    and 1)."""
    device = resolve_device(device)
    gen = (generator_or_seed if isinstance(generator_or_seed, torch.Generator)
           else make_generator(generator_or_seed, device))
    net = CouplingNSF(cfg)
    for m in net.modules():
        if isinstance(m, nn.Linear):
            nn.init.zeros_(m.bias)
            _lecun_normal_(m.weight, gen)
    net.to(device)
    return FlowEstimator(
        cfg=cfg, net=net,
        y_mean=_stat(stats.get("y_mean"), cfg.dim, 0.0, device), y_std=_stat(stats.get("y_std"), cfg.dim, 1.0, device),
        c_mean=_stat(stats.get("c_mean"), cfg.context_dim, 0.0, device),
        c_std=_stat(stats.get("c_std"), cfg.context_dim, 1.0, device),
    )


def _linears(net: CouplingNSF):
    """((conditioner_t, layers_i), layer) of every ``nn.Linear``: flax's
    names for the layers of the JAX flow's ``nn.Sequential``."""
    return [((f"conditioner_{t}", f"layers_{i}"), layer) for t, seq in enumerate(net.conditioners)
            for i, layer in enumerate(seq) if isinstance(layer, nn.Linear)]


def flow_from_flax_params(cfg: NSFConfig, params: Mapping[str, Any], stats: Mapping[str, Any], *,
                          device=None) -> FlowEstimator:
    """The port's ``FlowEstimator`` from a JAX flow's parameter tree (nested
    dicts of arrays, ``conditioner_t/layers_i`` with ``kernel`` (in, out)
    and ``bias``) and its stats (``y_mean``, ``y_std``, ``c_mean``,
    ``c_std``), on ``device`` (default: the CUDA card). Each kernel is
    transposed to ``nn.Linear``'s (out, in); the weights come back not
    requiring gradients, as the JAX flow's closed-over tree is constant."""
    est = build_flow(0, cfg, device=device, **dict(stats))
    with torch.no_grad():
        for (cond, layer_name), layer in _linears(est.net):
            leaf = params[cond][layer_name]
            kernel = np.asarray(leaf["kernel"], np.float32)
            if kernel.shape != (layer.in_features, layer.out_features):
                raise ValueError(f"{cond}/{layer_name}: kernel shape {kernel.shape} != "
                                 f"({layer.in_features}, {layer.out_features})")
            layer.weight.copy_(torch.from_numpy(kernel.T.copy()))
            layer.bias.copy_(torch.from_numpy(np.asarray(leaf["bias"], np.float32)))
    est.net.requires_grad_(False)
    return est


def flow_to_flax_params(flow: FlowEstimator) -> dict:
    """The flow's weights as the JAX flow's parameter tree (numpy arrays,
    kernels back to (in, out)); the inverse of ``flow_from_flax_params``."""
    tree: dict = {}
    for (cond, layer_name), layer in _linears(flow.net):
        tree.setdefault(cond, {})[layer_name] = {
            "bias": layer.bias.detach().cpu().numpy().copy(),
            "kernel": np.ascontiguousarray(layer.weight.detach().cpu().numpy().T),
        }
    return tree


def fit_flow(
    estimator: FlowEstimator,
    y,
    context,
    *,
    learning_rate: float = 5e-4,
    batch_size: int = 1024,
    max_epochs: int = 300,
    patience: int = 20,
    validation_fraction: float = 0.1,
    seed=0,
    verbose: bool = False,
) -> FlowEstimator:
    """Maximum-likelihood training with validation early stopping, on the
    estimator's device; returns a new estimator with the best validation
    loss's weights (the input's are trained in place).

    As in the JAX package: a validation split of ``validation_fraction``
    (none for n <= 10, where the training loss stands in), ``n_tr //
    batch_size`` shuffled batches an epoch, Adam (``torch.optim.Adam``,
    optax's defaults), and a stop after ``patience`` epochs without an
    improvement of 1e-5. Streams: ``child_seed(seed, 0)`` the split,
    ``child_seed(seed, 1 + epoch)`` each epoch's order. TF32 is off for the
    products, as in ``train_mnle``. ``train_meta`` holds the per-epoch
    ``train_losses`` and ``val_losses``, ``epochs``, ``steps_per_epoch`` and
    ``step_ms`` (mean wall milliseconds an optimizer step)."""
    dev = estimator.device
    y = torch.as_tensor(y, dtype=torch.float32).to(dev)
    context = torch.as_tensor(context, dtype=torch.float32).to(dev)
    seed = as_seed(seed)
    n = y.shape[0]
    n_val = max(int(n * validation_fraction), 1) if n > 10 else 0
    perm = torch.randperm(n, generator=make_generator(child_seed(seed, 0), dev), device=dev)
    val_idx, tr_idx = perm[:n_val], perm[n_val:]
    y_tr, c_tr, y_val, c_val = y[tr_idx], context[tr_idx], y[val_idx], context[val_idx]
    n_tr = int(y_tr.shape[0])
    batch_size = min(int(batch_size), n_tr)
    n_batches = max(n_tr // batch_size, 1)

    net = estimator.net
    net.requires_grad_(True)
    opt = torch.optim.Adam(net.parameters(), lr=learning_rate)

    def loss_fn(yb, cb):
        return -estimator.log_prob_fn(net, yb, cb).mean()

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    best_state, best_val, since = copy.deepcopy(net.state_dict()), math.inf, 0
    train_losses, val_losses, step_seconds, epochs = [], [], 0.0, 0
    try:
        for epoch in range(int(max_epochs)):
            order = torch.randperm(n_tr, generator=make_generator(child_seed(seed, 1 + epoch), dev), device=dev)
            batches = order[: n_batches * batch_size].reshape(n_batches, batch_size)
            t0 = time.perf_counter()
            losses = []
            for idx in batches:
                opt.zero_grad(set_to_none=True)
                loss = loss_fn(y_tr[idx], c_tr[idx])
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            tr_loss = float(torch.stack(losses).mean())
            step_seconds += time.perf_counter() - t0
            epochs += 1
            if n_val > 0:
                with torch.no_grad():
                    vl = float(loss_fn(y_val, c_val))
            else:
                vl = tr_loss
            train_losses.append(tr_loss)
            val_losses.append(vl)
            if vl < best_val - 1e-5:
                best_val, best_state, since = vl, copy.deepcopy(net.state_dict()), 0
            else:
                since += 1
            if verbose and epoch % 20 == 0:
                print(f"[fit_flow] epoch {epoch}: train={tr_loss:.4f} val={vl:.4f}")
            if since >= patience:
                break
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    best = CouplingNSF(estimator.cfg).to(dev)
    best.load_state_dict(best_state)
    best.requires_grad_(False)
    meta = {"train_losses": train_losses, "val_losses": val_losses, "best_val_loss": best_val, "epochs": epochs,
            "steps_per_epoch": n_batches, "step_ms": step_seconds * 1e3 / (epochs * n_batches) if epochs else None}
    return FlowEstimator(cfg=estimator.cfg, net=best, y_mean=estimator.y_mean, y_std=estimator.y_std,
                         c_mean=estimator.c_mean, c_std=estimator.c_std, train_meta=meta)
