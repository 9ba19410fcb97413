"""Collectives over a process group, and the row shard the samplers run on.

The JAX package runs one process over every device: XLA partitions a
program over a ``Mesh`` and inserts the collectives itself. The port runs one
process a device (a rank of ``torch.distributed``); each rank holds a block
of the rows and the collectives are written out here:

* ``all_reduce``, ``broadcast``, ``barrier`` and ``all_gather_rows`` (blocks
  of uneven length, concatenated in rank order), each over a group (default:
  the whole world). Under NCCL they run on the card. gloo takes CUDA tensors
  for ``broadcast`` and ``all_reduce`` only, so under gloo the others go
  through the host (as four ranks sharing one card do).
* ``RowShard``: this rank's rows of a batch split over a group, and the
  decisions the samplers share. A batched sampler draws its random numbers
  for the whole batch and keeps its own rows, and stops a loop on the
  batch's ``any`` over every rank, so a sharded run takes the draws and the
  decisions of the unsharded one. ``ShardedGenerator`` is a
  ``torch.Generator`` bound to such a shard: ``utils.rng.draw`` and
  ``batch_any`` take either.

Nothing here starts a process group (``multihost.initialize_multihost`` and
``mesh.default_mesh`` do). Without one, every collective is that of a world
of one rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["DEFAULT_TIMEOUT_S", "RowShard", "ShardedGenerator", "all_gather_rows", "all_reduce", "barrier",
           "broadcast", "rank", "world_size"]

DEFAULT_TIMEOUT_S = 600.0  # every process group's collective timeout: a rank that never arrives fails the others

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def world_size(group=None) -> int:
    """Ranks in ``group`` (1 without a process group)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank in ``group`` (0 without a process group)."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def _nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def _staged(t: torch.Tensor, group, cuda_ok: bool) -> torch.Tensor:
    """A copy of ``t`` where ``group``'s backend takes it: on the current card
    under NCCL; under gloo on ``t``'s device where ``cuda_ok``, else the host."""
    if _nccl(group):
        return t.to(torch.device("cuda", torch.cuda.current_device()), copy=True)
    return t.clone() if cuda_ok or not t.is_cuda else t.cpu()


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """The elementwise ``op`` ("sum", "max" or "min") of ``t`` over the
    ranks of ``group``: a new tensor on ``t``'s device, the same on every
    rank."""
    if world_size(group) == 1 and not dist.is_initialized():
        return t.clone()
    buf = _staged(t, group, cuda_ok=True)
    dist.all_reduce(buf, op=_OPS[op], group=group)
    return buf.to(t.device)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank ``src`` of ``group``'s ``t`` on every rank of it, written into
    ``t`` (which every rank gives with the same shape and type); returns ``t``."""
    if not dist.is_initialized():
        return t
    buf = _staged(t, group, cuda_ok=True)
    dist.broadcast(buf, src=dist.get_global_rank(group, src) if group is not None else src, group=group)
    with torch.no_grad():
        t.copy_(buf)
    return t


def barrier(group=None) -> None:
    """Wait until every rank of ``group`` has reached this call."""
    if dist.is_initialized():
        if _nccl(group):
            dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier(group=group)


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in rank order, on every
    rank, on ``t``'s device; the blocks may differ in length (their other
    dims and type must agree)."""
    n = world_size(group)
    if n == 1:
        return t.clone()
    lengths = torch.tensor([t.shape[0]], dtype=torch.int64)
    lengths = [int(v) for v in _gather(_staged(lengths, group, cuda_ok=False), group, n)]
    longest = max(lengths)
    buf = _staged(t, group, cuda_ok=False)
    if buf.shape[0] < longest:
        buf = torch.cat([buf, buf.new_zeros((longest - buf.shape[0], *buf.shape[1:]))])
    blocks = _gather(buf.contiguous(), group, n)
    return torch.cat([b[:m] for b, m in zip(blocks, lengths)]).to(t.device)


def _gather(buf: torch.Tensor, group, n: int) -> list:
    out = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(out, buf, group=group)
    return out


class RowShard:
    """This rank's block of the rows of a batch of ``n`` rows split over
    ``group``.

    ``rows`` (c,) int64 gives each local row's index in the batch; a padded
    row (one past the batch's n, appended so the blocks have equal length)
    gives the index of the row it copies, and ``real`` (c,) is False on it.
    A padded row then draws what its row draws, starts where it starts, and
    takes the same decisions (a batched potential's rows do not depend on
    each other), so it never changes a decision of the batch."""

    def __init__(self, rows: torch.Tensor, n: int, real: torch.Tensor, group=None):
        self.rows = rows.to(torch.int64)
        self.n = int(n)
        self.real = real.to(torch.bool)
        self.group = group
        if self.rows.shape != self.real.shape or self.rows.dim() != 1:
            raise ValueError(f"rows {tuple(self.rows.shape)} and real {tuple(self.real.shape)} must be (c,)")

    def groups(self, size: int) -> "RowShard":
        """The shard of the batch's groups of ``size`` contiguous rows (the
        replica groups of parallel tempering): this rank's rows must be
        whole groups."""
        c = self.rows.shape[0]
        if c % size or self.n % size:
            raise ValueError(f"{c} local rows of a batch of {self.n} are not whole groups of {size}")
        return RowShard(self.rows[::size] // size, self.n // size, self.real[::size], self.group)

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``full``, a tensor over the whole batch."""
        if full.shape[0] != self.n:
            raise ValueError(f"a batch tensor has {full.shape[0]} rows, the batch {self.n}")
        return full[self.rows.to(full.device)]

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank of the group."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        return bool(all_reduce(t, "max", self.group)[0])

    def all_equal(self, value: int) -> bool:
        """Whether every rank of the group gives the same integer."""
        t = torch.tensor([int(value), -int(value)], dtype=torch.int64)
        hi, neg_lo = (int(v) for v in all_reduce(t, "max", self.group))
        return hi == -neg_lo

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` (c, ...) over the batch's real rows, every rank
        contributing its own: what ``x.mean()`` over the whole batch gives."""
        local = torch.where(self.real.to(x.device).reshape(-1, *([1] * (x.dim() - 1))), x, 0).sum()
        total = all_reduce(local.reshape(1), "sum", self.group)[0]
        return total / torch.tensor(float(self.n * x[0].numel()), dtype=total.dtype, device=total.device)


class ShardedGenerator:
    """A ``torch.Generator`` that draws for a ``RowShard``: each draw is made
    for the whole batch, in its shape, and this rank keeps its rows
    (``utils.rng.draw``), so a row's numbers do not depend on the split."""

    def __init__(self, generator: torch.Generator, shard: RowShard):
        self.generator = generator
        self.shard = shard
