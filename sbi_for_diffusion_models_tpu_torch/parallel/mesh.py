"""Mesh scale-out: sharded simulation, data-parallel training, chain sharding.

Counterpart of ``sbi_for_diffusion_models_tpu/parallel/mesh.py``, with its
names and arguments where they carry over. There one process holds a
``jax.sharding.Mesh`` and XLA partitions one program over it; here every
rank of a ``torch.distributed`` group calls the same function on the same
global inputs, works on its own block of the leading axis, and the
collectives (``parallel/comm.py``) are explicit. The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims.

The required property is that a sharded run gives the unsharded run's
result:

* **Trials** (``sharded_simulate``): each rank simulates its block with its
  trial offset, so K1 (and the plain scan) gives each trial the noise it has
  in one launch over the whole batch; the blocks are all-gathered.
* **Training** (``make_dp_train_step``): the batch is split, the weights
  replicated; the gradient is all-reduced, weighted by each block's rows, so
  ragged blocks give the whole batch's mean.
* **Chains** (``sharded_run_nuts``): each rank runs its block of chains, and
  the sampler draws its random numbers for the whole batch and stops its
  loops on the whole batch's test (``comm.RowShard``), so the chains take
  the unsharded run's draws and decisions; the draws are all-gathered.

Padding (``pad_to_multiple``) is appended where the JAX package pads, and
dropped after, as there.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .comm import RowShard, all_gather_rows, all_reduce, broadcast, rank, world_size

__all__ = [
    "default_mesh",
    "shard_leading",
    "replicate",
    "pad_to_multiple",
    "sharded_simulate",
    "make_dp_train_step",
    "sharded_run_nuts",
]


def default_mesh(n_devices: Optional[int] = None, axis_name: str = "data", *, device=None) -> DeviceMesh:
    """1-D mesh over the ranks of the default process group (``n_devices``,
    if given, must be their number: a rank is one device). Without a
    process group it starts a world of one on ``device`` (default: the
    card, over NCCL; the CPU over gloo), through an in-process store."""
    from .multihost import init_group

    if not dist.is_initialized():
        init_group(1, 0, store=dist.HashStore(), device=device)
    n = world_size()
    if n_devices is not None and int(n_devices) != n:
        raise ValueError(f"a mesh of {n_devices} devices needs as many ranks; this group has {n}")
    return init_device_mesh(_mesh_device_type(), (n,), mesh_dim_names=(axis_name,))


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _axis(mesh: DeviceMesh, axis_name: str):
    """(group, size, this rank's index) of ``mesh``'s dim ``axis_name``."""
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        raise ValueError(f"mesh has no axis {axis_name!r} (its axes: {names})")
    group = mesh.get_group(axis_name)
    return group, world_size(group), rank(group)


def shard_leading(arr: torch.Tensor, mesh: DeviceMesh, axis_name: str = "data") -> torch.Tensor:
    """This rank's block of ``arr``'s leading axis over ``mesh``'s
    ``axis_name`` (``torch.tensor_split``: blocks differ by at most one row)."""
    _, n, r = _axis(mesh, axis_name)
    return torch.tensor_split(arr, n)[r]


def replicate(tree, mesh: DeviceMesh):
    """Rank 0's values of ``tree`` (an ``nn.Module``'s parameters and
    buffers, or a tensor, or a dict/list/tuple of them) on every rank of
    ``mesh``, written in place; returns ``tree``."""
    group = mesh.get_group(0) if mesh.ndim == 1 else None
    tensors = list(tree.state_dict().values()) if isinstance(tree, torch.nn.Module) else _leaves(tree)
    for t in tensors:
        broadcast(t, 0, group)
    return tree


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def pad_to_multiple(arr: torch.Tensor, multiple: int, axis: int = 0):
    """Pad ``axis`` up to a multiple (edge-replicated); returns (padded,
    true_n), ``arr`` itself when nothing is padded. The padded rows are
    sliced away after the compute."""
    n = arr.shape[axis]
    rem = (-n) % int(multiple)
    if rem == 0:
        return arr, n
    edge = arr.narrow(axis, n - 1, 1)
    return torch.cat([arr, edge.expand(*[rem if d == axis % arr.dim() else -1 for d in range(arr.dim())])],
                     dim=axis), n


def sharded_simulate(
    simulate_fn: Callable,
    theta: torch.Tensor,
    pulse_sides: torch.Tensor,
    seed,
    mesh: Optional[DeviceMesh] = None,
    axis_name: str = "data",
    **kwargs,
) -> torch.Tensor:
    """A batched trial simulator with the trial axis split over a mesh.

    ``simulate_fn(theta, pulse_sides, seed, trial_offset=, n_total=,
    **kwargs) -> (N, 2)``: ``ops.ddm_cuda.ddm_rt_choice_cuda`` (K1) or the
    plain ``ops.ddm_scan.ddm_rt_choice_scan``. Every rank gives the same
    global (N, 5) ``theta`` and (N, P) ``pulse_sides``; the trials are padded
    (edge) to a multiple of the mesh size, each rank simulates its block
    from its trial offset, and every rank returns the whole (N, 2), as the
    unsharded call gives it."""
    if mesh is None:
        mesh = default_mesh(axis_name=axis_name, device=theta.device)
    group, n_dev, r = _axis(mesh, axis_name)
    theta_p, n = pad_to_multiple(theta, n_dev)
    pulses_p, _ = pad_to_multiple(pulse_sides, n_dev)
    block = theta_p.shape[0] // n_dev
    lo = r * block
    out = simulate_fn(theta_p[lo: lo + block].contiguous(), pulses_p[lo: lo + block].contiguous(), seed,
                      trial_offset=lo, n_total=n, **kwargs)
    return all_gather_rows(out, group)[:n]


def make_dp_train_step(estimator, state, mesh: DeviceMesh, axis_name: str = "data"):
    """Data-parallel training step, in the idiom of ``mnle.train_step``: the
    weights replicated (start every rank from ``replicate``), each rank's
    batch its block. Returns ``step(xb, zb, step) -> loss``: the loss
    -mean(log p) over every rank's rows, its gradient (each rank's mean
    gradient weighted by its share of the rows, all-reduced over the axis,
    so ragged blocks give the whole batch's mean), then ``state.apply``
    (the global-norm clip and Adam) on every rank alike."""
    group, _, _ = _axis(mesh, axis_name)

    def step(xb: torch.Tensor, zb: torch.Tensor, step: int) -> torch.Tensor:
        n_local = torch.tensor([float(xb.shape[0])], device=xb.device)
        n_all = all_reduce(n_local, "sum", group)
        share = n_local / n_all
        state.adam.zero_grad(set_to_none=True)
        loss = -estimator.log_prob_fn(estimator.net, xb, zb).mean()
        (loss * share[0]).backward()
        for p in state.params:
            if p.grad is not None:
                p.grad.copy_(all_reduce(p.grad, "sum", group))
        state.apply(step)
        return all_reduce((loss.detach() * share).reshape(1), "sum", group)[0]

    return step


def _sharded_rows(n: int, n_dev: int, r: int, group_size: int, device) -> tuple:
    """(rows, real) of rank ``r``'s block of ``n`` rows, padded so that the
    ranks' blocks are equal. Without groups the blocks are padded to a
    multiple of ``n_dev`` by repeating the last row (edge, as
    ``pad_to_multiple``). With groups (parallel tempering's replica groups
    of ``group_size`` rows) every block must hold whole groups, since a
    rank's swap sweep sees only its own rows: the groups are padded to a
    multiple of ``n_dev`` (the rows to a multiple of lcm(n_dev, group_size),
    the JAX package's padding, whenever the two are coprime) by whole groups
    from the front (wrap-around)."""
    mult = n_dev * group_size
    padded = -(-n // mult) * mult
    block = padded // n_dev
    pos = torch.arange(r * block, (r + 1) * block, device=device)
    rows = pos % n if group_size > 1 else torch.clamp(pos, max=n - 1)
    return rows, pos < n


def _sharded_run(sampler: Callable, seed, logp_fn, init_u: torch.Tensor, mesh: Optional[DeviceMesh],
                 axis_name: str, *, data=None, exchange=None, checkpoint_dir: Optional[str] = None, **kwargs):
    """``sampler`` (``run_nuts`` or ``run_slice``) on this rank's block of
    the chains of ``init_u`` (C, D) and of ``data`` (and the ladder's betas),
    padded as ``_sharded_rows`` pads; returns the samples and the info's
    per-chain arrays all-gathered and the padding dropped, on every rank."""
    from ..inference.nuts import ReplicaExchange

    if mesh is None:
        mesh = default_mesh(axis_name=axis_name, device=init_u.device)
    group, n_dev, r = _axis(mesh, axis_name)
    C = init_u.shape[0]
    R = int(exchange.n_replicas) if exchange is not None else 1
    rows, real = _sharded_rows(C, n_dev, r, R, init_u.device)
    shard = RowShard(rows, C, real, group)
    local = _map(lambda a: a[rows.to(a.device)], data)
    if exchange is not None:
        exchange = ReplicaExchange(n_replicas=R, betas=exchange.betas[rows.to(exchange.betas.device)],
                                   ll_fn=exchange.ll_fn, swap_every=exchange.swap_every)
        kwargs["exchange"] = exchange
    if checkpoint_dir is not None:
        kwargs["checkpoint_dir"] = f"{checkpoint_dir}/rank_{r}"
    samples, info = sampler(seed, logp_fn, init_u[rows], data=local, shard=shard, **kwargs)
    block = rows.shape[0]

    def gather(a):
        if isinstance(a, torch.Tensor) and a.dim() >= 1 and a.shape[0] == block:
            return all_gather_rows(a, group)[:C]
        return a

    return gather(samples), {k: gather(v) for k, v in info.items()}


def sharded_run_nuts(seed, logp_fn, init_u: torch.Tensor, mesh: Optional[DeviceMesh] = None,
                     axis_name: str = "chains", **nuts_kwargs):
    """``run_nuts`` with the chain axis split over a mesh: every rank gives
    the same global ``init_u`` (C, D) (and per-chain ``data``, and an
    ``exchange`` whose betas are (C,)) and gets the unsharded run's samples
    (C, S, D) and info. Chains are padded to a multiple of the mesh size
    (with parallel tempering, by whole replica groups, so that each rank
    holds whole groups: ``_sharded_rows``) and the padding is dropped. With ``checkpoint_dir`` each rank
    keeps its segments in ``checkpoint_dir/rank_{r}``. A sharded run does
    not replay after a device error (``device_retries`` is 0): a replay on
    one rank would leave the others' collectives waiting, so one rank's
    failure fails every rank's call."""
    from ..inference.nuts import run_nuts

    return _sharded_run(run_nuts, seed, logp_fn, init_u, mesh, axis_name, **{**nuts_kwargs, "device_retries": 0})
