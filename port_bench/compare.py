"""The comparison that decides ``correct``: the port's outputs against the plain reference.

Sampler cells: every potential call the probe kept (a sample of the
window's calls drawn from the run's seed) is worked out again by
``reference.mnle`` in float64, from the saved estimator, the call's
parameter rows and its sessions' trials and stimuli. Each judged parameter
row (see ``_judged``) has a value gap |ll - ll_ref| / max(|ll_ref|, T), T
the trials the row sums, and on gradient calls a gradient gap max_j |g_j -
g_ref_j| / max(max_j |g_ref_j|, the median over the rows of max_j
|g_ref_j|). Numbers over the kept calls' rows:

* ``value_gap_median`` and ``grad_gap_median``: the medians, the rounding
  of a typical row, which the control (float32 with TF32 products) moves
  by two to three orders of magnitude;
* ``value_gap_p97`` and ``value_gap_p99``: high quantiles, which a share of
  answers altered where they are produced moves (one answer a call in the
  serving cells' 24 rows);
* ``value_gap_max``: the worst row, which one altered answer moves. The
  fold compares it, since one answer in its 2,304 rows a call moves no
  quantile; its limit leaves room for the rows where float32 itself is
  ill-conditioned (hot rungs far out in the prior's tail, B of 1e5 to 1e8).
  The serving cells compare a quantile instead: their worst row is set by
  such rows too (t_nd against the onset; the pulse phase's sharpest
  densities), where the control reads no worse.

Training cell: the first three optimizer steps of the timed call against
``reference.train`` in float64 from the same initial weights, batches and
training set. Three numbers:

* ``loss_gap``: the first step's |loss - loss_ref| / max(|loss_ref|, 1);
* ``grad_gap``: the worst leaf's | |g| - |g_ref| | / max(|g_ref|, the
  median leaf's |g_ref|), g the first step's clipped gradient;
* ``update_gap``: the median leaf's gap, so taken, of the weights' change
  over the three steps, over the leaves whose reference gradient is at
  least a thousandth of the median leaf's (the others move by round-off
  alone under Adam); ``update_gap_worst``, the worst such leaf's, is
  reported beside it. The median and not the worst leaf: after Adam's first
  step (every weight moves by about the learning rate) the trajectories of
  float32 and float64 part, so the later gradients of the sharp spline-head
  and affine-head elements differ by up to their own size in every float32
  computation, the reference's own included, and a small leaf's change
  reads up to a fifth on sound runs (``calibrate.py --look`` shows it);

and ``batch_rows_foreign``: the rows of the three batches that are not rows
of the benchmark's training pairs, or that repeat (0: the loader drew the
steps from the training set, on rows that all differ).

A parameter row at which the reference is not finite (a sampler
trajectory that ran off to an infinite or zero parameter) must be
non-finite in the port too; any other non-finite output makes its number
infinite. The limits are the cell's
``limits/<workload>.json``.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

from .reference import mnle as ref
from .reference import train as ref_train

__all__ = ["load_limits", "sampler_numbers", "train_numbers", "foreign_rows", "judge"]

_ROOT = Path(__file__).resolve().parent


def load_limits(workload: str) -> dict:
    return json.loads((_ROOT / "limits" / f"{workload}.json").read_text())


def _rows(cap):
    """Each parameter row's trials (N, T, 2) and stimuli (N, T, P)."""
    x, stim, s, n = cap["x"], cap["stim"], cap["sessions"], cap["theta"].shape[0]
    if s is None:
        return x[None].expand(n, *x.shape), stim[None].expand(n, *stim.shape)
    return x[s], stim[s]


def _judged(theta, want):
    """The parameter rows whose answer is judged: inside the prior's open
    support (a0 and t_nd in (0, 1); lam, v and B positive and finite), where
    the likelihood is defined and the potential uses it, and with a finite
    reference. Elsewhere the prior's log-density is -inf, so the sampler
    discards whatever the likelihood returns there (a trajectory that ran off
    to an infinite or zero parameter)."""
    a0, tnd, pos = theta[:, 0], theta[:, 4], theta[:, 1:4]
    inside = (a0 > 0) & (a0 < 1) & (tnd > 0) & (tnd < 1) & (pos > 0).all(1) & torch.isfinite(pos).all(1)
    return inside & torch.isfinite(want).reshape(want.shape[0], -1).all(1)


def _or_inf(gap, have):
    """Row gaps, inf where the port's row is not finite."""
    bad = ~torch.isfinite(have).reshape(have.shape[0], -1).all(1)
    return torch.where(bad, torch.full_like(gap, math.inf), gap)


def sampler_numbers(model: ref.Model, captures, against=None, detail: bool = False) -> dict:
    """``value_gap`` and ``grad_gap`` of the kept calls. ``against`` (a
    reference model in another type) takes the place of the port's outputs:
    the control. ``detail`` adds ``worst``: the rows behind each number."""
    v_rows, g_rows, rows = [], [], []
    judged = 0
    for cap in captures:
        x, stim = _rows(cap)
        theta = cap["theta"]
        ll_r, g_r = ref.log_lik_and_grad(model, x, stim, theta, cap["need_grad"])
        if against is None:
            ll, g = cap["ll"].to(ll_r.dtype), None if cap["grad"] is None else cap["grad"].to(ll_r.dtype)
        else:
            ll, g = ref.log_lik_and_grad(against, x, stim, theta, cap["need_grad"])
            ll, g = ll.to(ll_r.dtype), None if g is None else g.to(ll_r.dtype)
        T = x.shape[1]
        keep = _judged(theta, ll_r if g_r is None else torch.cat([ll_r[:, None], g_r], 1))
        judged += int(keep.sum())
        v = _or_inf((ll - ll_r).abs() / ll_r.abs().clamp(min=T), ll)[keep]
        v_rows.append(v)
        if g is not None:
            g_rows.append((_or_inf((g - g_r).abs().amax(1), g)[keep], g_r.abs().amax(1)[keep]))
        if detail:
            onset = (x[..., 0] - theta[:, None, 4]).amin(1)
            rows.append([t[keep] if t is not None else None for t in (theta, ll, ll_r, g, g_r, onset)])
    v_all = torch.cat(v_rows) if v_rows else torch.zeros(0)
    gap = None
    if g_rows:
        err = torch.cat([e for e, _ in g_rows])
        scale = torch.cat([s for _, s in g_rows])
        gap = err / torch.maximum(scale, scale.median())
    out = {
        "value_gap_median": _quantile(v_all, 0.5),
        "value_gap_p97": _quantile(v_all, 0.97),
        "value_gap_p99": _quantile(v_all, 0.99),
        "value_gap_max": _quantile(v_all, 1.0),
        "grad_gap_median": _quantile(gap, 0.5),
        "rows_judged": judged,
    }
    if detail:
        out.update(value_gap_p90=_quantile(v_all, 0.9),
                   grad_gap_max=_quantile(gap, 1.0), grad_gap_p90=_quantile(gap, 0.9), grad_gap_p99=_quantile(gap, 0.99))
        if rows:
            out["worst"] = _worst_rows(v_all, gap, rows)
    return out


def _quantile(t, q: float) -> float:
    """The q-quantile of the row gaps (linear interpolation); inf without rows."""
    if t is None or not t.numel():
        return math.inf
    t = torch.nan_to_num(t.double(), nan=math.inf, posinf=1e300)
    return float(torch.quantile(t, torch.tensor(q, dtype=t.dtype, device=t.device)))


def _worst_rows(v, gap, rows):
    """The parameter rows behind the worst value and gradient gaps."""
    theta, ll, ll_r, onset = (torch.cat([r[i] for r in rows]) for i in (0, 1, 2, 5))
    out = {}
    i = int(torch.nan_to_num(v, posinf=1e300).argmax())
    out["value"] = {"gap": float(v[i]), "theta": theta[i].tolist(), "ll": float(ll[i]), "ll_ref": float(ll_r[i]),
                    "min_rt_minus_tnd": float(onset[i])}
    grads = [r for r in rows if r[3] is not None]
    if gap is not None and grads:
        g, g_r = torch.cat([r[3] for r in grads]), torch.cat([r[4] for r in grads])
        th, on = torch.cat([r[0] for r in grads]), torch.cat([r[5] for r in grads])
        j = int(torch.nan_to_num(gap, posinf=1e300).argmax())
        out["grad"] = {"gap": float(gap[j]), "theta": th[j].tolist(), "g": g[j].tolist(), "g_ref": g_r[j].tolist(),
                       "min_rt_minus_tnd": float(on[j])}
    return out


def train_numbers(cfg: dict, capture: dict, initial: dict, z, x, *, lr0: float, total_steps: int,
                  dtype=torch.float64, against: dict | None = None, detail: bool = False) -> dict:
    """``loss_gap``, ``grad_gap`` and ``update_gap`` of the first three
    steps. ``capture`` holds the port's readings (losses, the first clipped
    gradient, the weights before the first step and after the third, and the
    batches), ``initial`` the benchmark's initial weights in the file's
    layout. ``against`` (the reference's readings in another type) takes the
    place of the port's: the control."""
    leaves = {k: v.to(dtype) for k, v in initial.items()}
    batches = capture["batches"][:3]
    want = ref_train.steps(cfg, leaves, z, x, batches, lr0=lr0, total_steps=total_steps)

    def file_layout(name, t):
        return t.T if name.endswith("/kernel") else t

    if against is None:
        losses = [float(v) for v in capture["losses"][:3]]
        grad1 = {k: file_layout(k, v) for k, v in capture["grad1"].items()}
        delta = {k: file_layout(k, capture["after3"][k] - capture["before"][k]) for k in capture["before"]}
    else:
        losses, grad1 = against["losses"], against["grad1"]
        delta = {k: against["weights"][k].to(dtype) - leaves[k] for k in leaves}
    want_delta = {k: want["weights"][k] - leaves[k] for k in leaves}

    worst = {}

    def leaf_gaps(label: str, have: dict, ref_: dict, names) -> dict:
        """Each leaf's gap of norms; a leaf the port has no reading of (no
        optimizer state, say) reads inf."""
        norms = {k: float(torch.linalg.vector_norm(ref_[k])) for k in names}
        med = sorted(norms.values())[len(norms) // 2]
        gaps = {k: abs(float(torch.linalg.vector_norm(have[k].to(dtype))) - norms[k]) / max(norms[k], med)
                if k in have else math.inf for k in names}
        gaps = {k: g if math.isfinite(g) else math.inf for k, g in gaps.items()}
        k = max(gaps, key=gaps.get)
        worst[label] = {"leaf": k, "gap": gaps[k], "norm_ref": norms[k], "median_norm_ref": med}
        return gaps

    g_norms = {k: float(torch.linalg.vector_norm(want["grad1"][k])) for k in leaves}
    g_med = sorted(g_norms.values())[len(g_norms) // 2]
    moving = [k for k in leaves if g_norms[k] >= 1e-3 * g_med]
    step_gaps = [abs(a - b) / max(abs(b), 1.0) if math.isfinite(a) else math.inf
                 for a, b in zip(losses, want["losses"])]
    update = sorted(leaf_gaps("update", delta, want_delta, moving).values())
    out = {
        "loss_gap": step_gaps[0],
        "grad_gap": max(leaf_gaps("grad", grad1, want["grad1"], list(leaves)).values()),
        "update_gap": update[len(update) // 2],
        "update_gap_worst": update[-1],
    }
    if detail:
        out["worst"] = dict(worst, step_loss_gaps=step_gaps, losses=losses, losses_ref=want["losses"],
                            leaves_left_out=sorted(set(leaves) - set(moving)))
    return out


def _row_keys(z, x):
    """An int64 key of each (z, x) row from the bits of rt, a0, lam and t_nd."""
    cols = torch.stack([x[:, 0], z[:, 0], z[:, 1], z[:, 4]], 1).float().contiguous().view(torch.int32).long()
    key = torch.zeros_like(cols[:, 0])
    for j, mult in enumerate((0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)):
        key = key * mult + cols[:, j]
    return key


def foreign_rows(z, x, batches) -> float:
    """Rows of ``batches`` [(xb, zb), ...] that are not rows of the pairs
    (z, x), or that are the same pair as another of their rows."""
    keys, order = _row_keys(z, x).sort()
    bad, found = 0, []
    for xb, zb in batches:
        k = _row_keys(zb, xb)
        at = torch.searchsorted(keys, k).clamp(max=keys.numel() - 1)
        idx = order[at]
        same = (keys[at] == k) & (z[idx] == zb).all(1) & (x[idx] == xb).all(1)
        bad += int((~same).sum())
        found.append(idx[same])
    idx = torch.cat(found)
    return float(bad + idx.numel() - idx.unique().numel())


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    checks = {k: {"value": numbers.get(k, math.inf), "limit": float(limits[k])} for k in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
