"""Seed threading with ``torch.Generator``s.

The JAX package threads ``jax.random`` keys and derives streams with
``fold_in``. The port threads plain integer seeds instead: ``child_seed``
plays the role of ``fold_in`` (a deterministic, well-mixed function of the
parent seed and the tags), and ``make_generator`` turns a seed into a
``torch.Generator`` on the device that will draw from it. The two frameworks
give different numbers for the same seed, so parity tests make their inputs
with numpy and hand them to both.

``draw`` and ``batch_any`` serve the batched samplers, whose rows may be
split over processes (``parallel.comm.RowShard``).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from . import metrics

SeedLike = Union[int, np.integer, np.random.Generator, None]

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def as_seed(seed: SeedLike) -> int:
    """Promote an int / numpy Generator / None to a non-negative 63-bit int.

    A numpy Generator contributes one draw, so reference-style call sites
    passing ``rng=np.random.default_rng(s)`` keep working.
    """
    if seed is None:
        return int(np.random.randint(0, 2**31 - 1))
    if isinstance(seed, np.random.Generator):
        return int(seed.integers(0, 2**63 - 1))
    if isinstance(seed, (int, np.integer)):
        return int(seed) & (2**63 - 1)
    raise TypeError(f"expected an int seed or numpy Generator, got {type(seed)}")


def child_seed(seed: SeedLike, *tags: int) -> int:
    """Derive an independent 63-bit seed from ``seed`` and integer tags (the
    port's ``fold_in``): the result depends on every tag and their order."""
    s = as_seed(seed)
    for t in tags:
        s = _splitmix64(s ^ _splitmix64(int(t) & _MASK64))
    return s & (2**63 - 1)


def make_generator(seed: SeedLike, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``seed``.

    A utility: its default stays the CPU, and every entry point of the port
    passes the device it runs on (by default the CUDA card,
    ``utils.device.default_device``)."""
    g = torch.Generator(device=torch.device(device) if device is not None else "cpu")
    g.manual_seed(as_seed(seed))
    return g


def draw(gen, sample, shape, device, **kwargs) -> torch.Tensor:
    """``sample(shape, generator=gen, device=device, **kwargs)`` (e.g.
    ``torch.rand``) for a batch of rows (the leading dim of ``shape``).
    ``gen`` is a ``torch.Generator``, or a ``parallel.comm.ShardedGenerator``
    whose rank holds some rows of a larger batch: it then draws for the
    whole batch, in its shape, and keeps its own rows, so every row gets the
    numbers an unsharded run gives it."""
    if isinstance(gen, torch.Generator):
        return sample(shape, generator=gen, device=device, **kwargs)
    if shape[0] != gen.shard.rows.shape[0]:
        raise ValueError(f"a draw of {shape[0]} rows for a shard of {gen.shard.rows.shape[0]}")
    return gen.shard.take(sample((gen.shard.n, *shape[1:]), generator=gen.generator, device=device, **kwargs))


def batch_any(gen, mask) -> bool:
    """Whether any row of the batch ``gen`` draws for has ``mask`` set (a
    tensor, or one bool for this process's rows): with a sharded generator,
    over every rank's rows, so that every rank leaves a loop when the
    unsharded run would. A tensor's read is a ``wait`` span of the
    recorder (``utils.metrics``)."""
    span = metrics.begin("wait") if metrics.RECORDING and isinstance(mask, torch.Tensor) else -1
    local = bool(mask.any()) if isinstance(mask, torch.Tensor) else bool(mask)
    out = local if isinstance(gen, torch.Generator) else gen.shard.any(local)
    if span >= 0:
        metrics.end(span)
    return out
