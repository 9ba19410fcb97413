"""Frozen operation and byte counts of the MNLE, from a saved estimator's shapes.

The shapes are read from the ``.npz`` with NumPy, so a count does not move
when a later change repacks, fuses or replaces a kernel: it is the work the
model needs, whatever computes it. Only the matrix products are counted, at
2 FLOP a multiply-add; the softmaxes, splines and other elementwise work are
not, so every share of a peak computed from these counts is a lower bound.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the 700 W limit):
FP32 outside the tensor cores 67 TFLOP/s, HBM3 3.35 TB/s. The port's kernels
run their products on the FP32 cores and training keeps TF32 off, so FP32 is
the peak of every count here.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

__all__ = ["FP32_FLOPS", "HBM_BYTES_PER_S", "Shapes", "shapes", "row_flops", "row_bytes", "train_flops",
           "bound_seconds"]

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
_KEY = re.compile(r"\['([^']*)'\]")


@dataclass(frozen=True)
class Shapes:
    """What the counts need of one estimator: every layer's (in, out) by group,
    the context width D, the categories C, the slot features F and the
    parameter count."""

    cat: tuple
    trunk: tuple
    heads: tuple  # the spline heads and the cond-affine head, each (in, out)
    slot: tuple | None
    D: int
    C: int
    F: int
    n_params: int


@lru_cache(maxsize=None)
def shapes(npz_path: str) -> Shapes:
    """The layer shapes of the estimator saved at ``npz_path``."""
    layers: dict = {}
    n_params = 0
    with np.load(npz_path, allow_pickle=False) as data:
        for name in data.files:
            if not name.startswith("param:"):
                continue
            parts = _KEY.findall(name[len("param:"):])
            shape = data[name].shape
            n_params += int(np.prod(shape))
            if parts[-1] == "kernel":
                layers["/".join(parts[:-1])] = tuple(int(s) for s in shape)

    def group(prefix):
        keys = sorted((k for k in layers if k.startswith(prefix + "/")), key=lambda k: int(k.rsplit("_", 1)[1]))
        return tuple(layers[k] for k in keys)

    heads = tuple(layers[k] for k in sorted(layers) if k.startswith("spline_head_"))
    if "affine_head" in layers:
        heads += (layers["affine_head"],)
    cat, trunk = group("cat_net"), group("flow_trunk")
    D, C = cat[0][0], cat[-1][1]
    hidden = trunk[-1][1]
    return Shapes(cat=cat, trunk=trunk, heads=heads, slot=layers.get("pulse_slot_head"), D=D, C=C,
                  F=heads[0][0] - hidden, n_params=n_params)


def _forward_macs(s: Shapes) -> int:
    layers = s.cat + s.trunk + s.heads + ((s.slot,) if s.slot else ())
    return sum(a * b for a, b in layers)


def row_flops(s: Shapes, backward: bool) -> float:
    """FLOP of one likelihood row: the forward products and, with
    ``backward``, the products of the gradient w.r.t. the row's inputs (the
    same matrices transposed; the first layers of the two MLPs to the D
    context columns only; no weight gradients)."""
    macs = _forward_macs(s)
    if backward:
        firsts = (s.cat[0], s.trunk[0])
        macs += _forward_macs(s) - sum(a * b for a, b in firsts) + sum(s.D * b for _, b in firsts)
    return 2.0 * macs


def row_bytes(s: Shapes, backward: bool) -> float:
    """Bytes of one row read and written once: the inputs (t or phi, the one-hot
    choice, the context, the slot features and slot), the cotangent, and the
    outputs (the value; with ``backward`` also the gradients w.r.t. t, the
    context and the slot features), all float32."""
    row_in = 1 + s.C + s.D + s.F + (1 if s.slot else 0)
    row_out = (2 + s.D + s.F) if backward else 1
    return 4.0 * (row_in + row_out + (1 if backward else 0))


def weight_bytes(s: Shapes) -> float:
    """Bytes of the weights, read once a launch."""
    return 4.0 * s.n_params


def train_flops(s: Shapes) -> float:
    """FLOP of one training pair: the forward products, the weight-gradient
    products (as many) and the input-gradient products of every layer but
    the first of each MLP (its input is data)."""
    fwd = _forward_macs(s)
    firsts = s.cat[0][0] * s.cat[0][1] + s.trunk[0][0] * s.trunk[0][1]
    return 2.0 * (fwd + fwd + fwd - firsts)


def bound_seconds(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of FLOP at the FP32 peak
    and bytes at the HBM peak, and which of the two bounds it."""
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (t_ops, "flops") if t_ops >= t_bytes else (t_bytes, "bytes")
