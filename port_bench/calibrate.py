"""Readings behind a cell's limits: the port's numbers over many seeds, the control's, and planted faults'.

    python3 -m port_bench.calibrate --workload <name> --seeds <n> [--first <seed>] [--seconds <s>]
        [--control-seeds <k>] [--faults] [--look]

For each seed, one run of the cell (``--seconds`` window, default 4) in this
one process, then the comparison of its kept calls (or first steps) with
the float64 reference: the port's readings. On the first ``--control-seeds``
seeds (default 3) the same comparison of the control (the driver's
``control``: the reference itself in float32 with TF32 products, the step
below the float32, TF32 off, that the configurations state). With
``--faults``, runs with a planted fault underneath the timed path on those
seeds: a sampler's answer replaced by another row's where the kernel
produces it; training's loss taken over half of the batch; a training step
that leaves the state unchanged. With ``--look`` (training), on those seeds
the leaves whose change departs most from float64, element by element
(``leaf_look``). ``--seed`` takes seeds as they are instead of drawing them
from ``--first``. Prints one JSON line per reading and a summary line; the
benchmark's own runs never run this. Needs the card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from . import drivers, generator, run
from .drivers import train
from .drivers.common import tf32
from .reference import train as ref_train

__all__ = ["fault", "leaf_look"]

EPS = 1e-8  # Adam's


def leaf_look(ctx, leaves: int = 3, elements: int = 6) -> list:
    """Training: the ``leaves`` leaves whose change over the three steps
    departs most (gap of norms) from the float64 reference, element by
    element. Beside the port, two witnesses: the reference's own steps in
    float32 (TF32 off: float32 rounding alone) and the control (TF32 on).
    For each leaf: each side's gap; the share of the squared-norm difference
    carried by the elements whose float64 first gradient lies under 10 and
    100 times Adam's eps; the elements whose first gradient's sign differs
    from float64's; and the ``elements`` elements that carry most of the
    difference, with their gradients (float64's three steps, the port's and
    the witnesses' first, float32's three) and changes, in units of the first
    learning rate. First in the list, over every leaf: the elements whose
    first gradient parts in sign from float64's, or lies within 10 eps of
    zero, and the witnesses' worst relative leaf gradient gap at each step."""
    cap = ctx.probe.train_capture
    cfg = train._file_config(ctx)
    lr0, total = train._schedule(ctx)
    z, x = ctx.data
    batches = cap["batches"][:3]

    def steps(dtype):
        return ref_train.steps(cfg, {k: v.to(dtype) for k, v in ctx.probe.weights.items()}, z, x, batches,
                               lr0=lr0, total_steps=total)

    want, f32 = steps(torch.float64), steps(torch.float32)
    with tf32():
        low = steps(torch.float32)
    start = {k: v.double() for k, v in ctx.probe.weights.items()}

    def lay(k, t):
        return (t.T if k.endswith("/kernel") else t).double().flatten()

    d = {"port": {k: lay(k, cap["after3"][k] - cap["before"][k]) for k in start},
         "f32": {k: (f32["weights"][k].double() - start[k]).flatten() for k in start},
         "control": {k: (low["weights"][k].double() - start[k]).flatten() for k in start}}
    g = {"port": {k: lay(k, v) for k, v in cap["grad1"].items()},
         "f32": {k: f32["grad1"][k].double().flatten() for k in start},
         "control": {k: low["grad1"][k].double().flatten() for k in start}}
    d64 = {k: (want["weights"][k] - start[k]).flatten() for k in start}
    g64 = [{k: gr[k].flatten() for k in start} for gr in want["grads"]]
    norm = {k: float(d64[k].norm()) for k in start}
    med = sorted(norm.values())[len(norm) // 2]

    def gap(side, k):
        return abs(float(d[side][k].norm()) - norm[k]) / max(norm[k], med)

    # Where the first step already parts: elements whose first gradient has
    # another sign than float64's, or lies within 10 eps of zero (Adam moves
    # them by a share of the learning rate that rounding decides), and how
    # far each witness's later gradients then stray from float64's.
    first = {"flips": {s: {k: int(((g[s][k] * g64[0][k]) < 0).sum()) for k in start} for s in g},
             "under_10_eps": {k: int((g64[0][k].abs() < 10 * EPS).sum()) for k in start}}
    first = {kind: {s: {k: n for k, n in by.items() if n} for s, by in sides.items()} if kind == "flips"
             else {k: n for k, n in sides.items() if n} for kind, sides in first.items()}

    def grad_gap(side, t):
        """The worst leaf's |g - g64| / max(|g64|, the median leaf's |g64|) at step t."""
        ref_n = {k: float(want["grads"][t][k].norm()) for k in start}
        m = sorted(ref_n.values())[len(ref_n) // 2]
        gaps = {k: float((side["grads"][t][k].double() - want["grads"][t][k]).norm()) / max(ref_n[k], m) for k in start}
        k = max(gaps, key=gaps.get)
        return [k, gaps[k]]

    out = [{"first_step": first, "worst_leaf_grad_gap_by_step": {
        "f32": [grad_gap(f32, t) for t in range(3)], "control": [grad_gap(low, t) for t in range(3)]}}]
    for k in sorted(start, key=lambda k: -gap("port", k))[:leaves]:
        c = d["port"][k] ** 2 - d64[k] ** 2
        a = g64[0][k].abs()
        top = c.abs().argsort(descending=True)[:elements]
        row = {"leaf": k, "size": int(c.numel()), "norm_ref": norm[k], "median_norm_ref": med,
               "gap": {s: gap(s, k) for s in d},
               "norm2_diff": float(c.sum()), "norm2_abs_diff": float(c.abs().sum()),
               "top_share": float(c[top].abs().sum() / c.abs().sum().clamp(min=1e-300)),
               "ref_first_grad_median": float(a.median()),
               "ref_sign_changes_over_steps": int(((g64[0][k] * g64[1][k] < 0) | (g64[1][k] * g64[2][k] < 0)).sum())}
        for m in (10, 100):
            small = a < m * EPS
            row[f"under_{m}_eps"] = {"count": int(small.sum()), "share": float(c[small].abs().sum() / c.abs().sum().clamp(min=1e-300))}
        for s in d:
            row[f"sign_flips_{s}"] = int(((g[s][k] * g64[0][k]) < 0).sum())
        row["top"] = [{"i": int(i), "g64": [float(gr[k][i]) for gr in g64],
                       **{f"g_{s}": float(g[s][k][i]) for s in g},
                       "g_f32_steps": [float(gr[k].flatten()[i]) for gr in f32["grads"]],
                       "d64_lr": float(d64[k][i]) / lr0, **{f"d_{s}_lr": float(d[s][k][i]) / lr0 for s in d}}
                      for i in top.tolist()]
        out.append(row)
    return out


@contextlib.contextmanager
def fault(name: str):
    """Plant the fault ``name`` underneath the benchmark's wrappers."""
    from sbi_for_diffusion_models_tpu_torch import mnle
    from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda

    undo = []
    if name == "answer_altered":
        for fn in ("rows_logp", "rows_logp_pulse", "rows_logp_and_vjp", "rows_logp_pulse_and_vjp"):
            real = getattr(mnle_cuda, fn)

            def altered(*args, _real=real, **kwargs):
                out = _real(*args, **kwargs)
                lp = (out[0] if isinstance(out, tuple) else out).clone()
                lp[0] = lp[1]  # the first row's answer is the second row's
                return (lp, *out[1:]) if isinstance(out, tuple) else lp

            setattr(mnle_cuda, fn, altered)
            undo.append(lambda fn=fn, real=real: setattr(mnle_cuda, fn, real))
    elif name == "half_batch":
        real = mnle.train_step

        def half(estimator, state, xb, zb, step):
            n = xb.shape[0] // 2
            return real(estimator, state, xb[:n], zb[:n], step)

        mnle.train_step = half
        undo.append(lambda: setattr(mnle, "train_step", real))
    elif name == "state_unchanged":
        real = mnle.TrainState.apply
        mnle.TrainState.apply = lambda self, step: None
        undo.append(lambda: setattr(mnle.TrainState, "apply", real))
    else:
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        for u in undo:
            u()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=4_100_000_000)
    ap.add_argument("--seed", type=int, action="append", default=[])
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--look", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    _, _, mix = run.cell(args.workload)
    driver = drivers.load(mix["kind"])
    seeds = args.seed or [generator.child(args.first, i) for i in range(args.seeds)]
    readings = {"port": [], "control": [], **{f: [] for f in driver.FAULTS}}
    for i, seed in enumerate(seeds):
        keep = {}
        res = run.execute(args.workload, seed, args.seconds, False, "cuda", keep=keep)
        port = keep["numbers"]
        line = {"seed": seed, "port": port, "metrics": res["metrics"]}
        readings["port"].append(port)
        if i < args.control_seeds:
            line["control"] = driver.control(keep["ctx"])
            readings["control"].append(line["control"])
            if args.look:
                line["look"] = leaf_look(keep["ctx"])
        print(json.dumps(line), flush=True)
        del keep
        if args.faults and i < args.control_seeds:
            for f in driver.FAULTS:
                keep = {}
                with fault(f):
                    run.execute(args.workload, seed, args.seconds, False, "cuda", keep=keep)
                readings[f].append(keep["numbers"])
                print(json.dumps({"seed": seed, "fault": f, "numbers": keep["numbers"]}), flush=True)
                del keep
    summary = {}
    for who, rows in readings.items():
        if rows:
            keys = [k for k in rows[0] if isinstance(rows[0][k], float)]
            summary[who] = {k: {"min": min(r[k] for r in rows), "max": max(r[k] for r in rows)} for k in keys}
    print(json.dumps({"workload": args.workload, "summary": summary}, default=lambda v: None), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
