"""No-U-Turn Sampler over a batch of chains, in PyTorch.

Counterpart of ``sbi_for_diffusion_models_tpu/inference/nuts.py``:
iterative multinomial NUTS (Betancourt 2017) with Stan-style warmup (dual
averaging of the step size, windowed diagonal mass matrix), optional
replica exchange (parallel tempering) across the chain axis and an optional
Metropolis move after every transition.

Where the JAX package writes one chain and ``vmap``s a ``while_loop`` over
chains, this module advances every chain of the batch together. All chains
double their trees in lockstep: at tree depth ``d`` each chain still
building grows a subtree of ``2**d`` leaves, and chains that have stopped
(U-turn or divergence) are carried along under a mask. So each leapfrog step
is ONE call of the batched potential over all chains: one forward and one
backward of the log-likelihood for every chain and replica at once. The leaf
index inside a subtree is then the same for every chain, which makes the
U-turn checkpoint slots (``popcount``/trailing ones of the leaf index) plain
Python integers.

``logp_fn(u)`` (or ``logp_fn(u, data)`` with per-chain ``data``) maps
positions (C, D) to log-densities (C,) and is differentiable in ``u``; the
gradient comes from ``torch.autograd``. Random numbers come from
``torch.Generator``s on the chains' device, seeded from an integer seed:
one for the step-size search and one for each segment of ``run_nuts``.

With ``shard`` (a ``parallel.comm.RowShard``: this rank's chains of a batch
split over processes, ``parallel.mesh.sharded_run_nuts``) every draw is made
for the whole batch and each rank keeps its rows (``utils.rng.draw``), each
loop that stops when no chain is left stops on the whole batch's test
(``utils.rng.batch_any``), and the swap acceptance is pooled over every
rank: so each rank's chains take the draws and the decisions of the
unsharded run.

``run_nuts`` runs in segments, as the JAX one does, with a host mirror of
the sampler state, checkpoint/resume on disk (``nuts_segments.npz``) and a
replay from the mirror after a ``torch.AcceleratorError``.
"""

from __future__ import annotations

import hashlib
import math
import os
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops.nuts_cuda import LeafKernel
from ..parallel.comm import ShardedGenerator
from ..utils import metrics
from ..utils.rng import as_seed, batch_any, child_seed, draw, make_generator

__all__ = [
    "run_nuts",
    "nuts_step",
    "find_reasonable_step_size",
    "ReplicaExchange",
    "geometric_ladder",
]

_MAX_DELTA_ENERGY = 1000.0  # divergence threshold (Stan's default)


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant on ``like``'s device. Dividing by a tensor (not a
    Python scalar) keeps PyTorch from multiplying by a rounded reciprocal,
    so the adaptation arithmetic rounds as the JAX package's does."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# Hamiltonian pieces
# ---------------------------------------------------------------------------
def _kinetic(p, inv_mass):
    return 0.5 * (p * p * inv_mass).sum(-1)


def _leapfrog(vg_fn, u, p, g, eps, inv_mass):
    """One leapfrog step for every chain; eps (C,). Returns (u', p', logp', g')."""
    e = eps[:, None]
    p_half = p + 0.5 * e * g
    u_new = u + e * inv_mass * p_half
    logp_new, g_new = vg_fn(u_new)
    p_new = p_half + 0.5 * e * g_new
    return u_new, p_new, logp_new, g_new


def _popcount(n: int) -> int:
    return bin(n).count("1")


def _trailing_ones(n: int) -> int:
    c = 0
    while n & 1:
        n >>= 1
        c += 1
    return c


def _is_turning(v_left, v_right, rho):
    """Generalized U-turn criterion per chain, velocities v = inv_mass * p."""
    return ((v_left * rho).sum(-1) <= 0.0) | ((v_right * rho).sum(-1) <= 0.0)


def value_and_grad(logp_fn: Callable, data=None) -> Callable:
    """``vg(u, need_grad=True) -> (logp (C,), grad (C, D) or None)``.

    With ``need_grad=False`` only the value is computed (no backward pass):
    the slice move's bracket search needs no gradient."""

    def f(u):
        return logp_fn(u) if data is None else logp_fn(u, data)

    def vg(u, need_grad: bool = True):
        if not need_grad:
            with torch.no_grad():
                return f(u), None
        with torch.enable_grad():
            u_ = u.detach().requires_grad_(True)
            lp = f(u_)
            (g,) = torch.autograd.grad(lp.sum(), u_)
        return lp.detach(), g

    return vg


# ---------------------------------------------------------------------------
# Subtree construction (iterative, fixed-size checkpoint stack)
# ---------------------------------------------------------------------------
class _LaggedAny:
    """``any(mask)`` read back one step late, so the host does not wait for
    the device at every leaf: the flag of leaf n is copied to pinned memory
    behind an event as soon as it is computed and read at leaf n + 2, while
    leaf n + 1 is already queued. A loop that stops on it runs at most one
    extra leaf, on which every chain is masked (a no-op). Read over the
    whole batch ``gen`` draws for (``utils.rng.batch_any``). The leaf kernel
    writes its flag into the pinned byte ``slot()`` itself."""

    def __init__(self, device: torch.device, gen):
        self.cuda = device.type == "cuda"
        self.gen = gen
        self.host = torch.ones((2,), dtype=torch.bool, pin_memory=self.cuda)
        self.events = [None, None]
        self.n = 0

    def slot(self) -> int:
        """The byte of ``host`` that the next ``push`` fills."""
        return self.n % 2

    def push(self, mask: Optional[torch.Tensor] = None) -> None:
        """Push ``mask``'s flag, or (``mask`` None) the one a kernel queued
        into ``host[slot()]``."""
        i = self.n % 2
        if mask is not None:
            self.host[i].copy_(mask.any(), non_blocking=self.cuda)
        if self.cuda:
            self.events[i] = torch.cuda.Event()
            self.events[i].record()
        self.n += 1

    def any_before_last(self) -> bool:
        """The flag pushed before the most recent one (True until two were pushed)."""
        if self.n < 2:
            return True
        i = self.n % 2
        span = metrics.begin("wait") if metrics.RECORDING else -1
        if self.events[i] is not None:
            self.events[i].synchronize()
        out = batch_any(self.gen, bool(self.host[i]))
        if span >= 0:
            metrics.end(span)
        return out


def _leaf_slots(n: int) -> tuple:
    """Leaf n's checkpoint slots: (the slot an even leaf stores into, else
    -1; the first and last slot of an odd leaf's U-turn tests, else -1, -1)."""
    if n % 2 == 0:
        return _popcount(n >> 1), -1, -1
    idx_max = _popcount(n >> 1)
    return -1, idx_max - _trailing_ones(n) + 1, idx_max


def _leaf_plain(n: int, s: dict, u_new, p_half, logp_new, g_new, uni, half_e, inv_mass, H0) -> dict:
    """Leaf ``n``'s body after its potential call, in plain PyTorch: from
    the subtree's state ``s`` (``edge``, ``prop``, ``rho``, ``log_w``,
    ``sum_accept``, ``n_leaves``, ``turning``, ``diverging``, ``live``,
    ``r_ckpts``, ``rsum_ckpts``), the leaf's position ``u_new`` and half
    step ``p_half``, its potential (``logp_new``, ``g_new``) and uniforms
    ``uni``, the next state (the checkpoints are written in place). The
    kernel ``ops.nuts_cuda.LeafKernel.leaf`` computes the same."""
    edge, prop, rho, log_w, live = s["edge"], s["prop"], s["rho"], s["log_w"], s["live"]
    r_ckpts, rsum_ckpts, turning, diverging = s["r_ckpts"], s["rsum_ckpts"], s["turning"], s["diverging"]
    p_new = torch.addcmul(p_half, half_e, g_new)
    delta = (_kinetic(p_new, inv_mass) - logp_new) - H0
    delta = torch.nan_to_num(delta, nan=math.inf, posinf=math.inf, neginf=-math.inf)
    leaf_log_w = -delta

    # Progressive multinomial sampling within the subtree.
    new_log_w = torch.logaddexp(log_w, leaf_log_w)
    take = live & (torch.log(uni) < leaf_log_w - new_log_w)
    rho_after = rho + p_new
    live_col = live[:, None]

    slot, idx_min, idx_max = _leaf_slots(n)
    if slot >= 0:
        # Checkpoint store at even leaves.
        r_ckpts[:, slot] = torch.where(live_col, p_new, r_ckpts[:, slot])
        rsum_ckpts[:, slot] = torch.where(live_col, rho, rsum_ckpts[:, slot])
        leaf_turning = None
    else:
        # U-turn checks for the aligned segments that end at odd leaf n.
        v_new = p_new * inv_mass
        rho_seg = rho_after[:, None, :] - rsum_ckpts[:, idx_min : idx_max + 1]
        v_ckpt = r_ckpts[:, idx_min : idx_max + 1] * inv_mass[:, None, :]
        leaf_turning = (((v_ckpt * rho_seg).sum(-1) <= 0.0) | ((v_new[:, None, :] * rho_seg).sum(-1) <= 0.0)).any(-1)

    new_edge = torch.cat([u_new, p_new, g_new, logp_new[:, None]], dim=1)
    edge = torch.where(live_col, new_edge, edge)
    prop = torch.where(take[:, None], torch.cat([u_new, g_new, logp_new[:, None]], dim=1), prop)
    rho = torch.where(live_col, rho_after, rho)
    log_w = torch.where(live, new_log_w, log_w)
    sum_accept = s["sum_accept"] + torch.where(live, torch.clamp(torch.exp(-delta), max=1.0), 0.0)
    n_leaves = s["n_leaves"] + live
    if leaf_turning is not None:
        turning = turning | (live & leaf_turning)
    diverging = diverging | (live & (delta > _MAX_DELTA_ENERGY))
    live = live & ~(turning | diverging)
    return dict(edge=edge, prop=prop, rho=rho, log_w=log_w, sum_accept=sum_accept, n_leaves=n_leaves,
                turning=turning, diverging=diverging, live=live, r_ckpts=r_ckpts, rsum_ckpts=rsum_ckpts)


def _takes_leaf_kernel(edge: torch.Tensor) -> bool:
    """Whether a subtree's leaves run in the leaf kernel: on a CUDA ``edge``
    (``run_nuts`` works in float32). CPU tensors take ``_leaf_plain``."""
    return edge.is_cuda


def _build_subtree(gen, edge, depth: int, direction, eps, inv_mass, H0, max_depth: int, vg_fn, active):
    """Build 2**depth leaves by repeated leapfrog from ``edge`` = [u | p |
    g | logp] (C, 3D+1), per chain in its ``direction`` (+1/-1). Chains
    outside ``active``, and chains whose subtree has turned or diverged,
    keep their state. Returns a dict: the far ``edge``, the multinomial
    proposal ``prop`` = [u | g | logp] (C, 2D+1), the momentum sum ``rho``,
    ``log_w`` (logsumexp of leaf weights relative to H0), ``sum_accept``,
    ``n_leaves``, ``turning`` and ``diverging``.

    A leaf is one potential call, one ``torch.rand`` draw and its body: on a
    CUDA ``edge`` the leaf kernel (``ops.nuts_cuda``), which updates the
    state in place and queues the next leaf's position, else
    ``_leaf_plain``. Both give the same draws and decisions."""
    C = edge.shape[0]
    D = (edge.shape[1] - 1) // 3
    dev = edge.device
    half_e = (0.5 * eps * direction)[:, None]
    e_im = (eps * direction)[:, None] * inv_mass
    s = dict(
        edge=edge,
        prop=torch.cat([edge[:, :D], edge[:, 2 * D :]], dim=1),
        rho=torch.zeros((C, D), dtype=edge.dtype, device=dev),
        log_w=torch.full((C,), -math.inf, device=dev),
        sum_accept=torch.zeros((C,), device=dev),
        n_leaves=torch.zeros((C,), dtype=torch.int64, device=dev),
        turning=torch.zeros((C,), dtype=torch.bool, device=dev),
        diverging=torch.zeros((C,), dtype=torch.bool, device=dev),
        live=active.clone(),
        r_ckpts=torch.zeros((C, max_depth + 1, D), dtype=edge.dtype, device=dev),
    )
    s["rsum_ckpts"] = torch.zeros_like(s["r_ckpts"])
    flag = _LaggedAny(dev, gen)
    flag.push(s["live"])

    def half_step(edge, out=None):
        p_half = torch.addcmul(edge[:, D : 2 * D], half_e, edge[:, 2 * D : 3 * D], out=out)
        return p_half, torch.addcmul(edge[:, :D], e_im, p_half)

    kernel = None
    if _takes_leaf_kernel(edge):
        s["edge"] = s["edge"].contiguous()
        kernel = LeafKernel(s, half_e, e_im, inv_mass, H0, flag.host)
        # The first leaf's half step, into the kernel's; the kernel computes every later leaf's.
        _, u_new = half_step(s["edge"], out=kernel.p_half)
    for n in range(1 << depth):
        leaf = metrics.begin("nuts.leaf") if metrics.RECORDING else -1
        if not flag.any_before_last():
            if leaf >= 0:
                metrics.end(leaf)
            break
        if kernel is None:
            p_half, u_new = half_step(s["edge"])
        logp_new, g_new = vg_fn(u_new)
        uni = draw(gen, torch.rand, (C,), dev)
        if kernel is None:
            s = _leaf_plain(n, s, u_new, p_half, logp_new, g_new, uni, half_e, inv_mass, H0)
            flag.push(s["live"])
        else:
            u_new = kernel.leaf(u_new, logp_new, g_new, uni, _leaf_slots(n), flag.slot())
            flag.push()
        if leaf >= 0:
            metrics.end(leaf)
    return {k: s[k] for k in ("edge", "prop", "rho", "log_w", "sum_accept", "n_leaves", "turning", "diverging")}


# ---------------------------------------------------------------------------
# One NUTS transition
# ---------------------------------------------------------------------------
def nuts_step(gen, u, logp, g, *, vg_fn, eps, inv_mass, max_depth: int = 10):
    """One NUTS draw for every chain from positions u (C, D); eps (C,),
    inv_mass (C, D). Returns (u', logp', g', info dict of (C,) tensors)."""
    C, D = u.shape
    dev = u.device
    p0 = draw(gen, torch.randn, u.shape, dev, dtype=u.dtype) / torch.sqrt(inv_mass)
    H0 = -logp + _kinetic(p0, inv_mass)

    edge_l = edge_r = torch.cat([u, p0, g, logp[:, None]], dim=1)
    rho = p0
    prop = torch.cat([u, g, logp[:, None]], dim=1)
    log_w = torch.zeros((C,), device=dev)
    turning = torch.zeros((C,), dtype=torch.bool, device=dev)
    diverging = torch.zeros_like(turning)
    sum_accept = torch.zeros((C,), device=dev)
    num_steps = torch.zeros((C,), dtype=torch.int64, device=dev)
    depth = torch.zeros((C,), dtype=torch.int64, device=dev)

    for d in range(max_depth):
        active = ~(turning | diverging)
        if not batch_any(gen, active):
            break
        go_right = draw(gen, torch.rand, (C,), dev) < 0.5
        direction = torch.where(go_right, 1.0, -1.0)
        right_col = go_right[:, None]
        sub = _build_subtree(gen, torch.where(right_col, edge_r, edge_l), d, direction, eps, inv_mass, H0,
                             max_depth, vg_fn, active)
        ok = active & ~(sub["turning"] | sub["diverging"])

        # Merge valid subtrees: biased progressive sampling across subtrees.
        uni = draw(gen, torch.rand, (C,), dev)
        take = ok & (torch.log(uni) < sub["log_w"] - log_w)
        prop = torch.where(take[:, None], sub["prop"], prop)
        log_w = torch.where(ok, torch.logaddexp(log_w, sub["log_w"]), log_w)
        ok_col = ok[:, None]
        edge_l = torch.where(ok_col & ~right_col, sub["edge"], edge_l)
        edge_r = torch.where(ok_col & right_col, sub["edge"], edge_r)
        rho = torch.where(ok_col, rho + sub["rho"], rho)
        full_turn = _is_turning(edge_l[:, D : 2 * D] * inv_mass, edge_r[:, D : 2 * D] * inv_mass, rho)
        turning = torch.where(active, ~ok | full_turn, turning)
        diverging = diverging | (active & sub["diverging"])
        sum_accept = sum_accept + torch.where(active, sub["sum_accept"], 0.0)
        num_steps = num_steps + torch.where(active, sub["n_leaves"], 0)
        depth = depth + active

    info = {
        "accept_prob": sum_accept / torch.clamp(num_steps.to(torch.float32), min=1.0),
        "num_steps": num_steps,
        "diverging": diverging,
        "depth": depth,
    }
    return prop[:, :D], prop[:, 2 * D], prop[:, D : 2 * D], info


# ---------------------------------------------------------------------------
# Step-size initialization and dual averaging
# ---------------------------------------------------------------------------
def find_reasonable_step_size(gen, vg_fn, u, inv_mass, eps0: float = 1.0, *, logp=None, g=None):
    """Per chain, double or halve eps until the one-step accept probability
    crosses 0.5 (Hoffman & Gelman 2014, Algorithm 4). Returns eps (C,)."""
    C = u.shape[0]
    dev = u.device
    if logp is None or g is None:
        logp, g = vg_fn(u)
    p0 = draw(gen, torch.randn, u.shape, dev, dtype=u.dtype) / torch.sqrt(inv_mass)
    H0 = -logp + _kinetic(p0, inv_mass)
    log_half = math.log(0.5)

    def delta_h(eps):
        _, p1, logp1, _ = _leapfrog(vg_fn, u, p0, g, eps, inv_mass)
        d = H0 - (-logp1 + _kinetic(p1, inv_mass))
        return torch.where(torch.isnan(d), -math.inf, d)

    eps = torch.full((C,), float(eps0), device=dev)
    d = delta_h(eps)
    up = d > log_half
    running = torch.ones((C,), dtype=torch.bool, device=dev)
    it = 0
    while True:
        keep = torch.where(up, d > log_half, d < log_half)
        running = running & keep & (eps > 1e-10) & (eps < 1e7) & (it < 64)
        if not batch_any(gen, running):
            return eps
        eps = torch.where(running, eps * torch.where(up, 2.0, 0.5), eps)
        it += 1
        d = delta_h(eps)


@dataclass
class _DAState:
    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_avg: torch.Tensor
    mu: torch.Tensor
    count: torch.Tensor


def _da_init(eps: torch.Tensor) -> _DAState:
    return _DAState(
        log_eps=torch.log(eps),
        log_eps_avg=torch.log(eps),
        h_avg=torch.zeros_like(eps),
        mu=torch.log(10.0 * eps),
        count=torch.zeros_like(eps),
    )


def _da_update(state: _DAState, accept_prob, target: float) -> _DAState:
    t0, gamma, kappa = 10.0, 0.05, 0.75
    m = state.count + 1.0
    eta_h = _const(1.0, m) / (m + t0)
    h_avg = (1.0 - eta_h) * state.h_avg + eta_h * (target - accept_prob)
    log_eps = state.mu - torch.sqrt(m) / _const(gamma, m) * h_avg
    eta = m ** -kappa
    log_eps_avg = eta * log_eps + (1.0 - eta) * state.log_eps_avg
    return _DAState(log_eps, log_eps_avg, h_avg, state.mu, m)


# ---------------------------------------------------------------------------
# Welford variance accumulation (mass adaptation)
# ---------------------------------------------------------------------------
@dataclass
class _Welford:
    mean: torch.Tensor
    m2: torch.Tensor
    count: torch.Tensor


def _welford_init(shape, device=None) -> _Welford:
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return _Welford(z, z.clone(), torch.zeros(shape[:-1], dtype=torch.float32, device=device))


def _welford_update(w: _Welford, x) -> _Welford:
    n = w.count + 1.0
    delta = x - w.mean
    mean = w.mean + delta / n[..., None]
    m2 = w.m2 + delta * (x - mean)
    return _Welford(mean, m2, n)


def _welford_var(w: _Welford):
    """Regularized variance estimate (Stan's shrinkage toward 1e-3)."""
    n = torch.clamp(w.count - 1.0, min=1.0)[..., None]
    var = w.m2 / n
    c = w.count[..., None]
    return (c / (c + 5.0)) * var + 1e-3 * (_const(5.0, c) / (c + 5.0))


# ---------------------------------------------------------------------------
# Warmup schedule (Stan-style fast / window / fast phases)
# ---------------------------------------------------------------------------
def _warmup_schedule(num_warmup: int):
    """Returns list of (length, is_window, update_mass_at_end)."""
    if num_warmup <= 20:
        return [(num_warmup, False, False)] if num_warmup > 0 else []
    init = max(int(0.15 * num_warmup), 10)
    term = max(int(0.10 * num_warmup), 10)
    middle = num_warmup - init - term
    if middle < 20:
        return [(num_warmup, False, False)]
    phases = [(init, False, False)]
    size = max(middle // 4, 10) if middle >= 40 else middle
    pos = 0
    while pos < middle:
        w = min(size, middle - pos)
        if middle - (pos + w) < 10:  # absorb tail into the last window
            w = middle - pos
        phases.append((w, True, True))
        pos += w
        size *= 2
    phases.append((term, False, False))
    return phases


# ---------------------------------------------------------------------------
# Replica exchange (parallel tempering)
# ---------------------------------------------------------------------------
def geometric_ladder(n_replicas: int, beta_min: float) -> np.ndarray:
    """Geometric inverse-temperature ladder 1 = b_0 > ... > b_{R-1} =
    ``beta_min``; the cold rung (the target posterior) is index 0."""
    R = int(n_replicas)
    if R < 2:
        return np.ones((max(R, 1),), np.float32)
    return np.asarray(beta_min ** (np.arange(R) / (R - 1)), np.float32)


@dataclass(frozen=True)
class ReplicaExchange:
    """Replica-exchange (parallel tempering) spec for ``run_nuts``, with the
    JAX package's contract: the chain axis is grouped as ``C = M *
    n_replicas`` with replicas contiguous and the cold rung (beta = 1) first
    in each group; ``betas`` (C,) is aligned with the chain rows;
    ``ll_fn(u[, data])`` returns the untempered likelihood term (C,) that
    beta multiplies in ``logp_fn``. Swaps between rungs i, j are accepted
    with ``min(1, exp((beta_i - beta_j) * (ll_j - ll_i)))`` in the
    deterministic even-odd (DEO) scheme: sweep s pairs rungs (0,1),(2,3),...
    when s is even and (1,2),(3,4),... when odd."""

    n_replicas: int
    betas: torch.Tensor
    ll_fn: Callable
    swap_every: int = 1


def _exchange_sweep(ex: ReplicaExchange, uniforms, sweep_idx: int, u, data, groups=None):
    """One DEO swap sweep over positions u (C, D). ``uniforms`` (M, R) are
    the sweep's uniform draws, one used per pair (indexed by the pair's
    lower rung). Returns ``(perm, mean acceptance)`` with ``u_new =
    u[perm]``: only positions move between rungs; each rung keeps its step
    size and mass matrix. ``groups``: the ``RowShard`` of the replica groups
    when the batch is split over ranks; the mean is then the whole batch's."""
    C = u.shape[0]
    R = int(ex.n_replicas)
    M = C // R
    dev = u.device
    with torch.no_grad():
        ll = ex.ll_fn(u) if data is None else ex.ll_fn(u, data)
    llg = ll.reshape(M, R)
    bg = ex.betas.reshape(M, R)

    r = torch.arange(R, device=dev)
    parity = int(sweep_idx) % 2
    partner = torch.where((r - parity) % 2 == 0, r + 1, r - 1)
    in_range = (partner >= 0) & (partner < R)
    partner_safe = torch.clamp(partner, 0, R - 1)

    ll_p = llg[:, partner_safe]
    b_p = bg[:, partner_safe]
    # Symmetric in (r, partner): both members compute the same ratio.
    log_accept = (bg - b_p) * (ll_p - llg)
    pair_id = torch.minimum(r, partner_safe)
    uni_pair = uniforms[:, pair_id]
    accept = in_range[None, :] & (torch.log(uni_pair) < log_accept)
    perm_within = torch.where(accept, partner_safe[None, :], r[None, :])
    perm = (torch.arange(M, device=dev)[:, None] * R + perm_within).reshape(-1)
    accept = accept.to(torch.float32)
    return perm, accept.mean() if groups is None else groups.mean(accept)


# ---------------------------------------------------------------------------
# Full driver: warmup + sampling for the whole batch of chains
# ---------------------------------------------------------------------------
@dataclass
class _ChainState:
    """The sampler state carried across segments, for every chain: the
    JAX package's ``_ChainState`` leaves (``_state_leaves`` gives their
    order, which is the checkpoint's ``state_{i}``) and ``t``, the global
    index of the next transition, which sets the DEO sweep's parity. ``t``
    is not stored: a checkpoint's ``next_segment`` x L gives it."""

    u: torch.Tensor
    logp: torch.Tensor
    g: torch.Tensor
    da: _DAState
    w: _Welford
    inv_mass: torch.Tensor
    eps_final: torch.Tensor
    t: int = 0


_N_STATE_LEAVES = 13  # u, logp, g, the 5 dual-averaging and 3 Welford fields, inv_mass, eps_final


def _state_leaves(st: _ChainState) -> list:
    """The state's tensors in the JAX ``_ChainState``'s leaf order."""
    return [st.u, st.logp, st.g, *vars(st.da).values(), *vars(st.w).values(), st.inv_mass, st.eps_final]


def _state_from_leaves(leaves, t: int, device) -> _ChainState:
    x = [torch.from_numpy(np.array(a)).to(device) for a in leaves]  # copies: the mirror stays as it was
    return _ChainState(u=x[0], logp=x[1], g=x[2], da=_DAState(*x[3:8]), w=_Welford(*x[8:11]), inv_mass=x[11],
                       eps_final=x[12], t=t)


def _to_host(tensors) -> list:
    """The mirror's host copy: every tensor of ``tensors`` as a numpy array,
    through ONE device-to-host copy of their bytes packed end to end (so one
    synchronization, whatever the number of leaves), bit for bit."""
    # Standard strides: a one-row slice counts as contiguous whatever its stride, and a byte view needs stride 1.
    flat = [t.detach().clone(memory_format=torch.contiguous_format).view(-1) for t in tensors]
    span = metrics.begin("wait") if metrics.RECORDING else -1
    packed = torch.cat([f.view(torch.uint8) for f in flat]).cpu().numpy()
    if span >= 0:
        metrics.end(span)
    out, pos = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel() * f.element_size()
        dtype = np.dtype(str(t.dtype).replace("torch.", ""))
        out.append(packed[pos : pos + n].view(dtype).reshape(tuple(t.shape)).copy())
        pos += n
    return out


# Device-loss probe: how long to wait for the card, how often to ask, and how
# long one probe may hang before it counts as failed.
_PROBE_MAX_WAIT_S = 600.0
_PROBE_POLL_S = 30.0
_PROBE_TIMEOUT_S = 60.0


def _probe(device) -> bool:
    """One health check of ``device``: a small reduction read back."""
    return float(torch.ones(8, device=device).sum().item()) == 8.0


def _wait_for_device(device) -> bool:
    """Probe ``device`` until it answers or ``_PROBE_MAX_WAIT_S`` passes,
    each probe in a daemon thread with a timeout: a call into a device that
    is gone can hang rather than raise, and must not wedge the process."""

    def run(result):
        try:
            result.append(_probe(device))
        except Exception:
            result.append(False)

    t0 = time.monotonic()
    while True:
        result: list = []
        th = threading.Thread(target=run, args=(result,), daemon=True)
        th.start()
        th.join(_PROBE_TIMEOUT_S)
        if result and result[0]:
            return True
        if time.monotonic() - t0 >= _PROBE_MAX_WAIT_S:
            return False
        time.sleep(_PROBE_POLL_S)


def _run_fingerprint(seed: int, L: int, W: int, S: int, thin: int, max_depth: int, mode_hop, exchange,
                     shard=None) -> str:
    """The JAX ``run_nuts``'s run fingerprint, with the integer seed in place
    of the key's data: a checkpoint whose (chains, D) match but whose seed,
    segment length, warmup, draws, thinning, depth, extra move or ladder
    differ (or, on a rank of a sharded run, whose rows of the batch differ)
    is not spliced into this run."""
    ex_tag = "none"
    if exchange is not None:
        betas = np.asarray(exchange.betas.detach().cpu().numpy(), np.float32)
        ex_tag = (f"R={exchange.n_replicas}/every={exchange.swap_every}/"
                  + hashlib.sha256(betas.tobytes()).hexdigest()[:8])
    rows = b"" if shard is None else np.asarray(shard.rows.cpu().numpy(), np.int64).tobytes() + f"/{shard.n}".encode()
    return hashlib.sha256(
        np.asarray(seed, np.int64).tobytes()
        + f"L={L}/W={W}/S={S}/thin={thin}/depth={max_depth}/hop={mode_hop is not None}/ex={ex_tag}".encode()
        + rows
    ).hexdigest()[:16]


def run_nuts(
    seed: int,
    logp_fn: Callable[..., torch.Tensor],
    init_u: torch.Tensor,
    *,
    num_warmup: int,
    num_samples: int,
    max_depth: int = 10,
    target_accept: float = 0.8,
    thin: int = 1,
    data=None,
    segment_length: int = 50,
    checkpoint_dir: Optional[str] = None,
    device_retries: int = 2,
    mirror_every: Optional[int] = None,
    mode_hop=None,
    exchange: Optional[ReplicaExchange] = None,
    value_and_grad_fn: Optional[Callable] = None,
    shard=None,
) -> Tuple[torch.Tensor, dict]:
    """Run NUTS on every chain of ``init_u`` (C, D): warmup with step-size
    and diagonal-mass adaptation, then sampling. Returns (samples (C,
    num_samples, D), info dict), on ``init_u``'s device.

    ``data``: optional per-chain tensor (leading axis C); ``logp_fn(u,
    data)`` is then called with it. ``mode_hop``: optional move
    ``hop(gen, u, logp, g, vg_fn) -> (u, logp, g)`` run after every
    transition; it must preserve the target. ``exchange``: optional
    :class:`ReplicaExchange`, a DEO swap sweep after every
    ``exchange.swap_every`` transitions; ``samples`` then holds every rung.
    A sample is the state after the move and before the sweep, as in the
    JAX package. ``value_and_grad_fn``: optional ``(u[, data], need_grad)
    -> (logp, grad or None)`` of the same density, used in place of
    autograd through ``logp_fn`` (a closed-form gradient). ``shard``: a
    ``parallel.comm.RowShard`` when ``init_u`` holds this rank's rows of a
    batch split over ranks (``parallel.mesh.sharded_run_nuts``, which every
    rank of the group calls together): the draws, the loops' stopping and
    the swap acceptance are then the whole batch's, and a checkpoint whose
    next segment differs between the ranks is not resumed.

    Segments. The W + S transitions run in ``ceil((W + S) / L)`` segments of
    ``L = segment_length``; segment s draws from its own generator,
    ``child_seed(seed, 1000 + s)``, and its sweeps from ``child_seed(<the
    exchange stream>, s)``, so any segment can be run again from the state
    at its start and give the same draws. The warmup flags are per
    transition, so a segment may hold warmup and sampling.

    Host mirror. The sampler state (JAX's ``_ChainState``: u, logp, g, the
    dual-averaging and Welford states, inv_mass, eps_final) and the
    transitions' draws and statistics since the last mirror are copied to
    host numpy in one device-to-host copy every ``mirror_every`` segments
    (default 1 with ``checkpoint_dir``, else 8) and after the last one.

    Checkpoint. With ``checkpoint_dir`` each mirror is also written,
    atomically, to ``<checkpoint_dir>/nuts_segments.npz`` under the JAX
    package's keys (``run_fingerprint``, ``next_segment``, ``samples`` and
    the per-transition stats over every transition so far, warmup included,
    and ``state_{i}``); the two packages' files do not resume each other's
    runs, since their fingerprints hash a key and a seed. A later call with
    the same arguments resumes at ``next_segment`` and gives the samples of
    an uninterrupted run bit for bit; a finished checkpoint replays without
    one potential call. A checkpoint from other arguments is ignored with a
    printed line.

    Device-loss replay. A ``torch.AcceleratorError`` (the CUDA error type)
    raised in a segment or in the mirror's copy is retried up to
    ``device_retries`` times on the same device: once a probe in a daemon
    thread sees the device answer, the mirrored state is uploaded again and
    the run replays from the mirror's segment. Any other error raises at
    once, and so does this one after the retries or when the probe never
    succeeds. A sticky CUDA error (an illegal address, a device-side assert)
    leaves the process's context unusable: the probe fails until it gives up
    and the error is raised; the recovery is then the disk checkpoint and a
    new process. There is no fallback to the CPU.

    ``info``: ``accept_prob``, ``num_steps``, ``diverging`` (C, num_samples);
    ``step_size`` and ``inv_mass`` of the final (or resumed) state;
    ``swap_accept``, the mean sweep acceptance over the whole run, with
    ``exchange``; and ``potential_calls``, the batched potential calls this
    process made, each exchange sweep's call of ``exchange.ll_fn`` among
    them (a resumed run counts only its own, and a replay of a finished
    checkpoint 0).
    """
    num_chains, D = init_u.shape
    dev = init_u.device
    seed = as_seed(seed)
    L = max(int(segment_length), 1)
    if metrics.RECORDING:
        metrics.new_run()
    if exchange is not None:
        if num_chains % int(exchange.n_replicas) != 0:
            raise ValueError(f"num_chains={num_chains} not divisible by n_replicas={exchange.n_replicas}")
        if tuple(exchange.betas.shape) != (num_chains,):
            raise ValueError(f"exchange.betas must be ({num_chains},), got {tuple(exchange.betas.shape)}")
    seed_ex = child_seed(seed, 0x45584348)  # exchange-sweep stream
    groups = None if shard is None or exchange is None else shard.groups(int(exchange.n_replicas))

    def bind(gen, rows):
        """``gen`` drawing for the batch's ``rows`` (a RowShard) on a sharded run."""
        return gen if rows is None else ShardedGenerator(gen, rows)

    # Per-step warmup flags from the Stan-style schedule.
    W, S = int(num_warmup), int(num_samples)
    collect_flags = np.zeros((max(W, 1),), np.bool_)
    update_flags = np.zeros((max(W, 1),), np.bool_)
    pos = 0
    for length, is_window, update_mass in _warmup_schedule(W):
        collect_flags[pos : pos + length] = is_window
        pos += length
        if update_mass:
            update_flags[pos - 1] = True
    total = W + S
    n_segments = -(-total // L)

    if value_and_grad_fn is None:
        vg_once = value_and_grad(logp_fn, data)
    elif data is None:
        vg_once = value_and_grad_fn
    else:
        vg_once = lambda u, need_grad=True: value_and_grad_fn(u, data, need_grad)  # noqa: E731
    calls = [0]  # batched potential evaluations (one K3 launch with the gradient, one K2 without)

    def vg_fn(u, need_grad: bool = True):
        calls[0] += 1
        return vg_once(u, need_grad)

    # Per-transition records, warmup included, on the device; the host holds
    # those of the transitions up to the last mirror.
    rec_spec = {"samples": ((D,), torch.float32), "accept_prob": ((), torch.float32),
                "num_steps": ((), torch.int64), "diverging": ((), torch.bool), "depth": ((), torch.int64)}
    if exchange is not None:
        rec_spec["swap_accept"] = ((), torch.float32)  # -1 where no sweep ran
    rec = {k: torch.zeros((num_chains, total, *shape), dtype=dt, device=dev) for k, (shape, dt) in rec_spec.items()}
    host = {k: np.zeros(tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in rec.items()}

    run_fingerprint = _run_fingerprint(seed, L, W, S, thin, max_depth, mode_hop, exchange, shard)
    ckpt_file = None
    state = None
    start_segment = 0
    if checkpoint_dir is not None:
        ckpt_dir = Path(checkpoint_dir)
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        ckpt_file = ckpt_dir / "nuts_segments.npz"
        if ckpt_file.exists():
            with np.load(ckpt_file, allow_pickle=False) as blob:
                stale_reason = None
                c_, d_ = blob["samples"].shape[0], blob["samples"].shape[2]
                if c_ != num_chains or d_ != D:
                    stale_reason = f"chains/dim {c_}x{d_} != {num_chains}x{D}"
                elif "run_fingerprint" not in blob or str(blob["run_fingerprint"]) != run_fingerprint:
                    stale_reason = "run fingerprint mismatch (key/L/warmup/samples/thin)"
                if stale_reason is not None:
                    print(f"[run_nuts] ignoring stale checkpoint {ckpt_file} ({stale_reason})")
                else:
                    start_segment = int(blob["next_segment"])
        if shard is not None and not shard.all_equal(start_segment):
            print(f"[run_nuts] not resuming at segment {start_segment}: the ranks' checkpoints stop at different "
                  "segments")
            start_segment = 0
        if start_segment > 0:
            t_done = min(start_segment * L, total)
            with np.load(ckpt_file, allow_pickle=False) as blob:
                for k in host:
                    host[k][:, :t_done] = blob[k]
                state = _state_from_leaves([blob[f"state_{i}"] for i in range(_N_STATE_LEAVES)], t_done, dev)
            print(f"[run_nuts] resumed at segment {start_segment}/{n_segments}")

    if state is None:
        span = metrics.begin("nuts.init") if metrics.RECORDING else -1
        gen0 = bind(make_generator(child_seed(seed, 0), dev), shard)
        u = init_u.to(torch.float32)
        inv_mass = torch.ones((num_chains, D), device=dev)
        logp, g = vg_fn(u)
        eps0 = find_reasonable_step_size(gen0, vg_fn, u, inv_mass, logp=logp, g=g)
        if span >= 0:
            metrics.end(span)
        state = _ChainState(u=u, logp=logp, g=g, da=_da_init(eps0), w=_welford_init((num_chains, D), dev),
                            inv_mass=inv_mass, eps_final=eps0)
    state_host = _to_host(_state_leaves(state))

    def transition(st: _ChainState, gen, gen_ex) -> _ChainState:
        """Transition ``st.t`` (x thin), its move, adaptation and sweep;
        writes the transition's record."""
        span = metrics.begin("nuts.transition") if metrics.RECORDING else -1
        t = st.t
        warm = t < W
        u, logp, g = st.u, st.logp, st.g
        da, w, inv_mass, eps_final = st.da, st.w, st.inv_mass, st.eps_final
        eps = torch.exp(da.log_eps) if warm else eps_final
        for _ in range(thin):
            u, logp, g, info = nuts_step(gen, u, logp, g, vg_fn=vg_fn, eps=eps, inv_mass=inv_mass,
                                         max_depth=max_depth)
        if mode_hop is not None:
            u, logp, g = mode_hop(gen, u, logp, g, vg_fn)
        if warm:
            da = _da_update(da, info["accept_prob"], target_accept)
            if collect_flags[t]:
                w = _welford_update(w, u)
            if update_flags[t]:
                # New mass matrix from the window variance; reset Welford and
                # re-center dual averaging (Stan behavior at window ends).
                inv_mass = _welford_var(w)
                da = _da_init(torch.exp(da.log_eps_avg))
                w = _welford_init((num_chains, D), dev)
            eps_final = torch.exp(da.log_eps_avg)
        rec["samples"][:, t] = u
        for k in ("accept_prob", "num_steps", "diverging", "depth"):
            rec[k][:, t] = info[k]
        if exchange is not None:
            swap_every = max(int(exchange.swap_every), 1)
            if t % swap_every == 0:
                sweep = metrics.begin("nuts.exchange") if metrics.RECORDING else -1
                R = int(exchange.n_replicas)
                uni = draw(gen_ex, torch.rand, (num_chains // R, R), dev)
                calls[0] += 1  # the sweep's value-only call of ``exchange.ll_fn``
                perm, acc = _exchange_sweep(exchange, uni, t // swap_every, u, data, groups)
                u = u[perm]
                logp, g = vg_fn(u)
                rec["swap_accept"][:, t] = acc
                if sweep >= 0:
                    metrics.end(sweep)
            else:
                rec["swap_accept"][:, t] = -1.0
        if span >= 0:
            metrics.end(span)
        return _ChainState(u=u, logp=logp, g=g, da=da, w=w, inv_mass=inv_mass, eps_final=eps_final, t=t + 1)

    def save_checkpoint(next_segment: int) -> None:
        t_done = min(next_segment * L, total)
        tmp = ckpt_file.with_name(ckpt_file.stem + ".tmp.npz")
        with open(tmp, "wb") as f:  # a file object: np.savez adds no suffix
            np.savez(f, run_fingerprint=np.asarray(run_fingerprint), next_segment=np.asarray(next_segment),
                     **{k: v[:, :t_done] for k, v in host.items()},
                     **{f"state_{i}": leaf for i, leaf in enumerate(state_host)})
        os.replace(tmp, ckpt_file)

    if mirror_every is None:
        mirror_every = 1 if checkpoint_dir is not None else 8
    mirror_every = max(int(mirror_every), 1)
    mirror_seg = start_segment  # state_host is the state at this segment's start
    attempts = 0
    s = start_segment
    while s < n_segments:
        try:
            gen = bind(make_generator(child_seed(seed, 1000 + s), dev), shard)
            gen_ex = bind(make_generator(child_seed(seed_ex, s), dev), groups) if exchange is not None else None
            for _ in range(s * L, min((s + 1) * L, total)):
                state = transition(state, gen, gen_ex)
            if (s + 1 - start_segment) % mirror_every == 0 or s == n_segments - 1:
                t0, t1 = min(mirror_seg * L, total), state.t
                copied = _to_host(_state_leaves(state) + [v[:, t0:t1] for v in rec.values()])
                state_host = copied[:_N_STATE_LEAVES]
                for k, v in zip(rec, copied[_N_STATE_LEAVES:]):
                    host[k][:, t0:t1] = v
                mirror_seg = s + 1
                if ckpt_file is not None:
                    save_checkpoint(mirror_seg)
            attempts = 0
            s += 1
        except torch.AcceleratorError as e:
            attempts += 1
            if attempts > device_retries:
                raise
            print(f"[run_nuts] device lost near segment {s} ({type(e).__name__}); waiting for recovery, then "
                  f"replaying from segment {mirror_seg} (attempt {attempts}/{device_retries})", flush=True)
            if not _wait_for_device(dev):
                raise
            if metrics.RECORDING:
                metrics.new_run()  # the segment's open spans were cut; the replay records as a run of its own
            # Back to the mirror, on the same device; what ran past it is run again.
            state = _state_from_leaves(state_host, min(mirror_seg * L, total), dev)
            s = mirror_seg

    def out(k):
        return torch.from_numpy(np.ascontiguousarray(host[k][:, W:total])).to(dev)

    info = {
        "accept_prob": out("accept_prob"),
        "num_steps": out("num_steps"),
        "diverging": out("diverging"),
        "step_size": state.eps_final,
        "inv_mass": state.inv_mass,
        "potential_calls": calls[0],
    }
    if exchange is not None:
        # Mean DEO sweep acceptance over the whole run (warmup included; rows
        # are the same for every chain, -1 marks transitions with no sweep).
        sa = host["swap_accept"][0]
        info["swap_accept"] = float(sa[sa >= 0].mean()) if (sa >= 0).any() else 0.0
    return out("samples"), info
