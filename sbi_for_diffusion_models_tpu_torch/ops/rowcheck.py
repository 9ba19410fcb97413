"""Hold a fused kernel's outputs against its plain version in float64, row
by row.

The fused MNLE kernels (K2/K3, K2p/K3p) compute in float32 a function whose
rows can be steep: near a spline knot, a ReLU kink or a sharp density the
exact function moves more under an input change of a few float32 ulps than
a fixed tolerance allows, and no float32 evaluation, the plain version's
included, meets it there. ``reference`` runs the plain version in float64 on
the kernel's float32 rows and measures that spread per row. ``row_check``
holds one output to its tolerance times the row's own scale, adds the spread
on steep rows only, and limits the share of rows over their allowance. A
fault in a term of the function breaks every row the term reaches, so it
shows in that share.

The value is also held on its worst row. The gradients are not: where a
float32 evaluation lands exactly on a spline knot, a clip bound or a ReLU
kink, the gradient takes the convention of that point (``jnp.clip`` passes
half the gradient at a bound; ReLU passes none at 0) and changes by O(1),
while the float64 reference, a few ulps away, never lands there. Any float32
implementation meets such ties on a few rows in a million, each on other
rows, so a worst-row limit on a gradient fails correct code.

``chip_smoke.py`` and the kernel tests use it. It runs on any device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

__all__ = ["PERTURB", "VALUE_TOL", "GRAD_TOL", "MAX_OVER_SHARE", "RowCheck", "reference", "row_check"]

PERTURB = 2.0**-20  # relative input change behind a row's spread (8 float32 ulps at 1)
VALUE_TOL = 1e-4  # per row: |d value| / max(1, |ref|)
GRAD_TOL = 1e-3  # per row: max |d grad| / max(1, the row's max |ref|)
MAX_OVER_SHARE = 1e-3  # share of rows whose error may exceed their allowance
PLAIN_FACTOR = 3.0  # the value's worst row may exceed its allowance by 3x what the plain float32 version's does ...
WORST_CAP = 10.0  # ... and never by more than 10x


def reference(run, rows, g, continuous):
    """``run(*rows, g)`` -> (value, *grads) of the plain version in float64
    on the same float32 rows, and per row how far each output moves when the
    row's continuous inputs move by PERTURB: ``rows[0]`` by PERTURB *
    max(|x|, 1) either way, then the rows at the indices ``continuous`` by a
    factor 1 -+ PERTURB. That spread is the row's conditioning at float32
    resolution."""
    R = [a.double() for a in rows]
    G = g.double()
    ref = run(*R, G)
    n = R[0].shape[0]
    spread = [torch.zeros_like(R[0]) for _ in ref]
    first = PERTURB * R[0].abs().clamp(min=1.0)
    variants = [[R[0] + first] + R[1:], [R[0] - first] + R[1:]]
    for f in (1 + PERTURB, 1 - PERTURB):
        variants.append([a * f if i in continuous else a for i, a in enumerate(R)])
    for v in variants:
        for i, x in enumerate(run(*v, G)):
            spread[i] = torch.maximum(spread[i], (x - ref[i]).abs().reshape(n, -1).amax(1))
    return ref, spread


@dataclass
class RowCheck:
    """One output of a kernel held against its float64 reference."""

    tol: float
    share: float  # share of the kernel's rows over their allowance
    plain_share: float  # the same for the plain version in float32
    worst: float  # the kernel's largest error / allowance over the rows
    worst_row: int
    plain_worst: float
    limit: Optional[float]  # the largest error / allowance the worst row may reach (values only)
    steep: int  # rows whose allowance includes their spread
    flat_err: float  # the kernel's largest relative error on the other rows
    over: torch.Tensor  # (N,) bool: the kernel's rows over their allowance
    ok: bool


def row_check(got, plain, ref, spread, value: bool) -> RowCheck:
    """``got`` (the kernel's output) and ``plain`` (the plain version's, in
    float32) against ``ref`` with the per-row ``spread`` of ``reference``;
    ``value`` says whether the output is the row value or a gradient.

    A row's scale is max(1, its largest |ref|), its allowance tol x scale
    (VALUE_TOL or GRAD_TOL), plus twice its spread where twice the spread
    exceeds tol x scale. The check fails if ``got`` is not finite or more
    than MAX_OVER_SHARE of its rows exceed their allowance; for the value
    also if its worst row exceeds it by more than min(WORST_CAP, max(1,
    PLAIN_FACTOR x the plain version's worst row))."""
    tol = VALUE_TOL if value else GRAD_TOL
    n = ref.shape[0]
    base = tol * ref.abs().reshape(n, -1).amax(1).clamp(min=1.0)
    steep = 2.0 * spread > base
    allow = base + torch.where(steep, 2.0 * spread, torch.zeros_like(base))

    def ratios(x):
        return (x.double() - ref).abs().reshape(n, -1).amax(1) / allow

    k_r, p_r = ratios(got), ratios(plain)
    over = k_r > 1.0
    share, plain_share = float(over.double().mean()), float((p_r > 1.0).double().mean())
    worst_row = int(k_r.argmax())
    worst, plain_worst = float(k_r[worst_row]), float(p_r.max())
    limit = min(WORST_CAP, max(1.0, PLAIN_FACTOR * plain_worst)) if value else None
    flat_err = float(k_r[~steep].max()) * tol if bool((~steep).any()) else 0.0
    ok = bool(torch.isfinite(got).all()) and share <= MAX_OVER_SHARE and (limit is None or worst <= limit)
    return RowCheck(tol, share, plain_share, worst, worst_row, plain_worst, limit, int(steep.sum()), flat_err,
                    over, ok)
