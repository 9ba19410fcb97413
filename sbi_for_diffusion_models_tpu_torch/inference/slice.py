"""Axis-aligned slice sampler, batched over chains.

Counterpart of ``sbi_for_diffusion_models_tpu/inference/slice.py``: sbi's
``slice_np_vectorized`` method, the fallback the reference notebooks use when
NUTS misbehaves. Neal (2003) stepping-out and shrinkage per coordinate, with
the JAX package's loop bounds (``max_steps_out`` steps out on each side, at
most ``max_shrink`` shrinks).

The chains are the batch: every step-out or shrink iteration evaluates the
density of all C chains in one call of ``logp_fn`` on a (C, D) tensor and
masks the chains that are already done, so on the card each iteration is one
launch of the value kernel (K2 or K2p) and never a gradient (K3, K3p). The
loops stop as soon as no chain is active.

Per-coordinate widths adapt during warmup as in the JAX package: each
accepted move updates an exponential moving average of |z - x0| per
dimension (decay ``_WIDTH_EMA``) and the bracket is ``_WIDTH_MULT`` times
that average, clipped to [1e-3, 1e3]. Random numbers come from one
``torch.Generator``; only the distribution matches the JAX sampler's. With
``shard`` (this rank's chains of a batch split over processes,
``parallel.comm.RowShard``) the draws and the loops' stopping are the whole
batch's, as in ``inference/nuts.py``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from ..parallel.comm import ShardedGenerator
from ..utils.rng import batch_any, child_seed, draw, make_generator
from .nuts import value_and_grad

__all__ = ["run_slice"]

# Width adaptation: EMA decay and bracket = _WIDTH_MULT * E|z - x0|.
# For a Gaussian slice, E|z - x0| ~ 0.9 sigma, so 4x gives a ~3.5 sigma
# initial bracket -- rarely needs stepping out, rarely over-shrinks.
_WIDTH_EMA = 0.9
_WIDTH_MULT = 4.0
_WIDTH_MIN, _WIDTH_MAX = 1e-3, 1e3


def _slice_one_dim(gen, x, logp0, d: int, value_fn, width, max_steps_out: int, max_shrink: int):
    """Slice-update coordinate ``d`` of every chain of x (C, D), whose
    log-densities are logp0 (C,), with per-chain bracket widths ``width``
    (C,). Returns (new x, its log-densities, accepted (C,), |move| (C,))."""
    C = x.shape[0]
    dev = x.device
    logy = logp0 + torch.log(draw(gen, torch.rand, (C,), dev))
    x0 = x[:, d]

    def logp_at(z):
        xz = x.clone()
        xz[:, d] = z
        return value_fn(xz)

    L = x0 - draw(gen, torch.rand, (C,), dev) * width
    R = L + width

    def step_out(edge, sign):
        active = torch.ones((C,), dtype=torch.bool, device=dev)
        for _ in range(max_steps_out):
            active = active & (logp_at(edge) > logy)
            if not batch_any(gen, active):
                break
            edge = torch.where(active, edge + sign * width, edge)
        return edge

    L = step_out(L, -1.0)
    R = step_out(R, 1.0)

    z, lp_z = x0, logp0
    accepted = torch.zeros((C,), dtype=torch.bool, device=dev)
    for _ in range(max_shrink):
        z_new = L + (R - L) * draw(gen, torch.rand, (C,), dev)
        lp_new = logp_at(z_new)
        ok = ~accepted & (lp_new > logy)
        miss = ~accepted & ~ok
        L = torch.where(miss & (z_new < x0), z_new, L)
        R = torch.where(miss & (z_new >= x0), z_new, R)
        z = torch.where(ok, z_new, z)
        lp_z = torch.where(ok, lp_new, lp_z)
        accepted = accepted | ok
        if not batch_any(gen, ~accepted):
            break
    x_new = x.clone()
    x_new[:, d] = z  # z is x0 where no in-slice point was found
    return x_new, lp_z, accepted, (z - x0).abs()


def run_slice(
    generator_or_seed: Union[torch.Generator, int],
    logp_fn: Callable[..., torch.Tensor],
    init_u: torch.Tensor,
    *,
    num_warmup: int,
    num_samples: int,
    width: float = 1.0,
    max_steps_out: int = 20,
    max_shrink: int = 100,
    thin: int = 1,
    data=None,
    adapt_width: bool = True,
    mode_hop=None,
    value_and_grad_fn: Optional[Callable] = None,
    shard=None,
) -> Tuple[torch.Tensor, dict]:
    """Run the batched slice sampler on every chain of ``init_u`` (C, D),
    given in *unconstrained* space. ``logp_fn(u)`` (or ``logp_fn(u, data)``
    with per-chain ``data``, leading axis C) maps (C, D) to (C,); the
    sampler evaluates it without a gradient.

    Returns (samples (C, num_samples, D), info) on ``init_u``'s device,
    where info has ``accept_prob`` (the share of coordinate updates whose
    shrinkage found an in-slice point, (C, num_samples)), ``width`` (the
    final adapted per-coordinate widths, (C, D)) and ``potential_calls``
    (batched density evaluations). As in the JAX package, at least one
    warmup sweep runs.

    ``mode_hop``: optional move ``hop(gen, u, logp, g, vg_fn) -> (u, logp,
    g)`` applied after every sweep, with the density's value and gradient
    (see ``run_nuts``). ``value_and_grad_fn``: optional ``(u[, data],
    need_grad) -> (logp, grad or None)`` of the same density, used in place
    of autograd through ``logp_fn`` (the slice updates call it with
    ``need_grad=False``). ``shard``: a ``parallel.comm.RowShard`` when
    ``init_u`` holds this rank's rows of a batch split over ranks (every
    rank of the group calls together, with the same generator or seed).
    """
    num_chains, D = init_u.shape
    dev = init_u.device
    if isinstance(generator_or_seed, torch.Generator):
        gen = generator_or_seed
    else:
        gen = make_generator(child_seed(generator_or_seed, 0), dev)
    if shard is not None:
        gen = ShardedGenerator(gen, shard)

    if value_and_grad_fn is None:
        vg_once = value_and_grad(logp_fn, data)
    elif data is None:
        vg_once = value_and_grad_fn
    else:
        vg_once = lambda u, need_grad=True: value_and_grad_fn(u, data, need_grad)  # noqa: E731
    calls = [0]

    def vg_fn(u, need_grad: bool = True):
        calls[0] += 1
        return vg_once(u, need_grad)

    def value_fn(u):
        return vg_fn(u, need_grad=False)[0]

    def sweep(x, lp, w, adapt: bool):
        """One full coordinate sweep; adapts w when ``adapt``. Returns (x,
        its log-densities, w, the share of accepted updates per chain)."""
        n_acc = torch.zeros((num_chains,), device=dev)
        for d in range(D):
            x, lp, accepted, move = _slice_one_dim(gen, x, lp, d, value_fn, w[:, d], max_steps_out, max_shrink)
            if adapt:
                w_new = _WIDTH_EMA * w[:, d] + (1 - _WIDTH_EMA) * _WIDTH_MULT * move
                w[:, d] = torch.where(accepted, w_new.clamp(_WIDTH_MIN, _WIDTH_MAX), w[:, d])
            n_acc = n_acc + accepted.to(torch.float32)
        return x, lp, w, n_acc / D

    def hop(x, lp):
        if mode_hop is None:
            return x, lp
        g = vg_fn(x)[1]
        x, lp, _ = mode_hop(gen, x, lp, g, vg_fn)
        return x, lp

    x = init_u.to(torch.float32).clone()
    w = torch.full((num_chains, D), float(width), device=dev)
    lp = value_fn(x)
    for _ in range(max(int(num_warmup), 1)):
        x, lp, w, _ = sweep(x, lp, w, bool(adapt_width))
        x, lp = hop(x, lp)

    samples = torch.empty((num_chains, num_samples, D), device=dev)
    accept_prob = torch.empty((num_chains, num_samples), device=dev)
    for s in range(num_samples):
        acc = torch.zeros((num_chains,), device=dev)
        for _ in range(thin):
            x, lp, w, a = sweep(x, lp, w, False)
            x, lp = hop(x, lp)
            acc = acc + a
        samples[:, s] = x
        accept_prob[:, s] = acc / thin
    return samples, {"accept_prob": accept_prob, "width": w, "potential_calls": calls[0]}
