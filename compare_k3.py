#!/usr/bin/env python3
"""Time a fused MNLE kernel (K2, K2p, K3 or K3p), or one gradient call of the
potential, of two checkouts in turns on one CUDA card: the "before" and the
"after" of a change.

Kernel mode (``--kernel``). The rows are made once, by this checkout
(``chip_smoke.session_rows`` on the kernel's committed model, at 1,200 and
115,200 rows, with a cotangent): the flagship for K2 and K3, the pulse-grid
model ``mnle_1m_pulseabs.npz`` for K2p and K3p. They are saved to a
temporary file. Each checkout then runs in a process of its own (both hold a
package of one name) from its own root: it loads the model through its own
``load_model``, calls its own wrapper (``ops.mnle_cuda.rows_logp`` for K2,
``rows_logp_pulse`` for K2p, ``rows_logp_vjp`` for K3,
``rows_logp_pulse_vjp`` for K3p) once (which builds its kernels in its own
``build/``) and times it with CUDA events. The two sides' outputs (the
value; dt and dctx; dphi, dctx and dkf) are compared: the largest difference
of each, and the row it is on.

Call mode (``--call grad`` on the flagship, ``--call grad_pulse`` on the
pulse-grid model). Each checkout times one synchronized
``ConditionedMNLELogLikelihood.log_lik_and_grad(x, theta, need_grad=True)``
at 1,200 rows (24 prior draws of theta against the 50 trials of
``chip_smoke``'s observed session, the rows of one PT6 x 4 leapfrog step) on
the host's clock, the mean of REPS_CALL calls after 20 warm-up calls, and
the two sides' (ll, grad) are compared.

The order is parent, this, this, parent, and each side's time is the mean
of its two turns. Run from the root of a checkout, on a machine with one
CUDA card and nvcc: ``python3 compare_k3.py --parent DIR [--kernel
k2|k2p|k3|k3p | --call grad|grad_pulse]``, where DIR holds a checkout of
the earlier commit (``git archive <commit> | tar -x -C DIR``). The last line
is one JSON object; the script exits with 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SIZES = (1_200, 115_200)
REPS = {1_200: 50, 115_200: 10}
REPS_CALL = 200
# kernel -> (its wrapper in ops.mnle_cuda, whether it takes a cotangent, the names of its outputs, the pulse model?)
KERNELS = {
    "k2": ("rows_logp", False, ("value",), False),
    "k2p": ("rows_logp_pulse", False, ("value",), True),
    "k3": ("rows_logp_vjp", True, ("dt", "dctx"), False),
    "k3p": ("rows_logp_pulse_vjp", True, ("dphi", "dctx", "dkf"), True),
}
CALLS = {"grad": False, "grad_pulse": True}  # call -> the pulse model?

CHILD = """
import json, sys, torch
from sbi_for_diffusion_models_tpu_torch.mnle import load_model
from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda as mc
dev = torch.device("cuda", 0)
data = torch.load(sys.argv[1])
w = mc.pack_mnle_weights(load_model(data["model"], device=dev))
fn = getattr(mc, data["wrapper"])
outs, ms = {}, {}
for n, (rows, reps) in data["rows"].items():
    rows = [a.to(dev) for a in rows]
    args = (*rows[:-1], w, rows[-1]) if data["cotangent"] else (*rows[:-1], w)
    out = fn(*args)
    outs[n] = [a.cpu() for a in (out if isinstance(out, tuple) else (out,))]
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    ms[n] = start.elapsed_time(end) / reps
torch.save(outs, sys.argv[2])
print(json.dumps(ms))
"""

CHILD_CALL = """
import json, sys, time, torch
from sbi_for_diffusion_models_tpu_torch.mnle import load_model
from sbi_for_diffusion_models_tpu_torch.potentials import ConditionedMNLELogLikelihood
dev = torch.device("cuda", 0)
data = torch.load(sys.argv[1])
lik = ConditionedMNLELogLikelihood(load_model(data["model"], device=dev), data["pulses"].to(dev),
                                   logprob_kernel="pallas")
x, theta = data["x"].to(dev), data["theta"].to(dev)
for _ in range(20):
    ll, g = lik.log_lik_and_grad(x, theta, need_grad=True)
torch.cuda.synchronize()
total = 0.0
for _ in range(data["reps"]):
    t0 = time.perf_counter()
    ll, g = lik.log_lik_and_grad(x, theta, need_grad=True)
    torch.cuda.synchronize()
    total += time.perf_counter() - t0
torch.save({data["n"]: [ll.cpu(), g.cpu()]}, sys.argv[2])
print(json.dumps({data["n"]: total * 1e3 / data["reps"]}))
"""


def _model(pulse: bool) -> str:
    import chip_smoke as cs

    return cs.PULSE_MODEL_FILE if pulse else cs.MODEL_FILE


def _rows(path: Path, device, kernel: str) -> None:
    """The session rows of the kernel's model at every size of SIZES, saved
    for the children with the model's file name and the wrapper's name."""
    import torch

    import chip_smoke as cs
    from sbi_for_diffusion_models_tpu_torch.mnle import load_model
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta

    wrapper, cotangent, _, pulse = KERNELS[kernel]
    model = _model(pulse)
    os.environ["MODEL_DIR"] = str(cs.MODEL_DIR)
    est = load_model(model, device=device)
    rows = cs.session_rows(est, build_prior_theta(), device, -(-max(SIZES) // cs.ROWS_MAIN))
    out = {}
    for n in SIZES:
        g = torch.randn((n,), generator=torch.Generator(device).manual_seed(5), device=device)
        out[n] = ([a[:n].contiguous().cpu() for a in rows] + [g.cpu()], REPS[n])
    torch.save({"model": model, "wrapper": wrapper, "cotangent": cotangent, "rows": out}, path)


def _session(path: Path, device, call: str) -> int:
    """chip_smoke's observed session and 24 prior draws of theta, saved for
    the children; returns the rows a call evaluates."""
    import torch

    import chip_smoke as cs
    from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

    prior, x_o, pulses_o = cs._observed_session(device)
    theta = prior.sample(make_generator(17, device), (24,))
    n = theta.shape[0] * x_o.shape[0]
    torch.save({"model": _model(CALLS[call]), "x": x_o.cpu(), "pulses": pulses_o.cpu(), "theta": theta.cpu(),
                "reps": REPS_CALL, "n": n}, path)
    return n


def _run_side(root: Path, child: str, data: Path, outs: Path) -> dict:
    env = {**os.environ, "MODEL_DIR": str(root / "artifacts" / "models")}
    proc = subprocess.run([sys.executable, "-c", child, str(data), str(outs)], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"the run of {root} failed (rc {proc.returncode}):\n{proc.stdout}\n{proc.stderr[-4000:]}")
    return {int(n): ms for n, ms in json.loads(proc.stdout.strip().splitlines()[-1]).items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True, help="checkout of the commit that is the 'before'")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--kernel", choices=sorted(KERNELS), default="k3", help="the kernel to time")
    mode.add_argument("--call", choices=sorted(CALLS), help="time log_lik_and_grad(need_grad=True) instead")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("compare_k3: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi} torch={torch.__version__} cuda={torch.version.cuda}", flush=True)
    sides = {"parent": args.parent.resolve(), "this": ROOT}
    device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "data.pt"
        if args.call:
            label, child, names = f"log_lik_and_grad ({args.call})", CHILD_CALL, ("ll", "grad")
            sizes = (_session(data, device, args.call),)
        else:
            label, child, names = args.kernel.upper().replace("P", "p"), CHILD, KERNELS[args.kernel][2]
            sizes = SIZES
            _rows(data, device, args.kernel)
        ms = {name: {n: [] for n in sizes} for name in sides}
        for turn, name in enumerate(("parent", "this", "this", "parent")):
            got = _run_side(sides[name], child, data, Path(tmp) / f"{name}{turn}.pt")
            for n in sizes:
                ms[name][n].append(got[n])
            print(f"[time] turn {turn} {name}: " + ", ".join(f"n={n} {got[n]:.4f} ms" for n in sizes), flush=True)
        outs = {name: torch.load(Path(tmp) / f"{name}{turn}.pt") for turn, name in ((0, "parent"), (1, "this"))}
    report = {"device": smi, "timed": label, "ms": {}, "speedup": {}, "max_abs_diff": {}}
    for n in sizes:
        mean = {name: sum(ms[name][n]) / len(ms[name][n]) for name in sides}
        report["ms"][str(n)] = {name: {"turns": ms[name][n], "mean": mean[name]} for name in sides}
        report["speedup"][str(n)] = mean["parent"] / mean["this"]
        diff = {}
        for what, a, b in zip(names, outs["parent"][n], outs["this"][n]):
            d = (a - b).abs().reshape(a.shape[0], -1).amax(1)
            diff[what] = {"max": float(d.max()), "row": int(d.argmax())}
        report["max_abs_diff"][str(n)] = diff
        print(f"[{label}] n={n}: parent {mean['parent']:.4f} ms, this {mean['this']:.4f} ms, "
              f"{report['speedup'][str(n)]:.3f}x; max |diff| {report['max_abs_diff'][str(n)]}", flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
