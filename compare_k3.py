#!/usr/bin/env python3
"""Time a fused MNLE kernel (K2, K2p, K3 or K3p), the simulator kernel K1, or
one gradient call of the potential, of two checkouts in turns on one CUDA
card: the "before" and the "after" of a change.

Kernel mode (``--kernel``). The rows are made once, by this checkout
(``tests/card_common.session_rows`` on the kernel's committed model, at
1,200 and 115,200 rows, with a cotangent): the flagship for K2 and K3, the
pulse-grid model ``mnle_1m_pulseabs.npz`` for K2p and K3p. They are saved to a
temporary file. Each checkout then runs in a process of its own (both hold a
package of one name) from its own root: it loads the model through its own
``load_model``, calls its own wrapper (``ops.mnle_cuda.rows_logp`` for K2,
``rows_logp_pulse`` for K2p, ``rows_logp_vjp`` for K3,
``rows_logp_pulse_vjp`` for K3p) once (which builds its kernels in its own
``build/``) and times it with CUDA events. The two sides' outputs (the
value; dt and dctx; dphi, dctx and dkf) are compared: the largest difference
of each, and the row it is on.

K1 mode (``--kernel k1``). The trials are made once, by this checkout:
``chip_smoke.py``'s prior draws (seed 7) at 4,096 (the main path's launch)
and 131,072, and the roofline path's 524,288 fixed-theta trials
(``roofline.simulator_inputs``). Each checkout calls its own
``ops.ddm_cuda.ddm_rt_choice_cuda`` (seed 1) and times it with CUDA events;
the report gives the rows whose outputs differ between the two (a redesign
that keeps K1's random stream gives 0) and the executed trial-steps/s. Each
side also times the flagship path's simulation of 131,072 training pairs
(``simulate_training_set_with_conditions``, one K1 launch a batch of
4,096, on the host's clock after one warm-up call) and gives K1's share of
it: its launches x its time at 4,096 over the wall.

Call mode (``--call grad`` on the flagship, ``--call grad_pulse`` on the
pulse-grid model). Each checkout times one synchronized
``ConditionedMNLELogLikelihood.log_lik_and_grad(x, theta, need_grad=True)``
at 1,200 rows (24 prior draws of theta against the 50 trials of
``card_common``'s observed session, the rows of one PT6 x 4 leapfrog step) on
the host's clock, the mean of REPS_CALL calls after 20 warm-up calls, and
the two sides' (ll, grad) are compared.

Sampler mode (``--call sampler`` on the flagship, ``--call sampler_pulse``
on the pulse-grid model). Each checkout samples the posterior of
``card_common``'s observed session through its own ``run_inference_mcmc``
under ``CALIBRATED_CONFIG`` (PT6 x 4 chains, grid hop, t_nd slice: 1,200
rows a call), cut to SAMPLER_WARMUP / SAMPLER_DRAWS draws a chain, after a
short untimed run that builds and loads its kernels, and gives the wall
over its potential calls (ms per call, on the host's clock). The two
sides' draws are not compared: checkouts whose sampler draws from other
streams take other paths.

The order is parent, this, this, parent, and each side's time is the mean
of its two turns. Run from the root of a checkout, on a machine with one
CUDA card and nvcc: ``python3 compare_k3.py --parent DIR [--kernel
k1|k2|k2p|k3|k3p | --call grad|grad_pulse|sampler|sampler_pulse]``, where DIR holds a checkout of
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
MODEL_DIR = ROOT / "artifacts" / "models"
MODEL_FILE, PULSE_MODEL_FILE = "mnle_10m_shifted_logt_affine.npz", "mnle_1m_pulseabs.npz"
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
CALLS = {"grad": False, "grad_pulse": True, "sampler": False, "sampler_pulse": True}  # call -> the pulse model?
SAMPLER_WARMUP, SAMPLER_DRAWS = 10, 20
K1_SIZES = (4_096, 131_072, 524_288)
K1_REPS = {4_096: 20, 131_072: 10, 524_288: 5}
K1_SIM_PAIRS = 131_072

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


CHILD_SAMPLER = """
import json, sys, time, torch
from sbi_for_diffusion_models_tpu_torch.mnle import load_model, run_inference_mcmc
from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
from sbi_for_diffusion_models_tpu_torch.run_config import CALIBRATED_CONFIG
dev = torch.device("cuda", 0)
data = torch.load(sys.argv[1])
est = load_model(data["model"], device=dev)
x, pulses = data["x"].to(dev), data["pulses"].to(dev)
def run(warmup, draws):
    cfg = CALIBRATED_CONFIG.replace(WARMUP_STEPS=warmup, POSTERIOR_SAMPLES=draws * CALIBRATED_CONFIG.NUM_CHAINS)
    t0 = time.perf_counter()
    _, info = run_inference_mcmc(cfg, build_prior_theta(), est, x, pulses, device=dev, seed=0, return_info=True,
                                 verbose=False)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, info["potential_calls"]
run(1, 2)
wall, calls = run(data["warmup"], data["draws"])
torch.save({data["n"]: []}, sys.argv[2])
print(json.dumps({data["n"]: wall * 1e3 / calls, "calls": calls, "wall_s": wall}))
"""


CHILD_K1 = """
import json, sys, time, torch
from sbi_for_diffusion_models_tpu_torch.data_simulator import simulate_training_set_with_conditions
from sbi_for_diffusion_models_tpu_torch.models.rt_choice_model import n_pulses_max_from_schedule, pulse_schedule
from sbi_for_diffusion_models_tpu_torch.ops import ddm_cuda
from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
from sbi_for_diffusion_models_tpu_torch.proposals import ExtendedProposal, PulseSequenceProposal
from sbi_for_diffusion_models_tpu_torch.run_config import CALIBRATED_CONFIG
dev = torch.device("cuda", 0)
data = torch.load(sys.argv[1])
outs, ms = {}, {}
for n, (theta, s, reps) in data["trials"].items():
    theta, s = theta.to(dev), s.to(dev)
    run = lambda: ddm_cuda.ddm_rt_choice_cuda(theta, s, 1, n_max=data["n_max"], steps_per_pulse=data["spp"])
    outs[n] = [run().cpu()]
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    ms[n] = start.elapsed_time(end) / reps
P = n_pulses_max_from_schedule(*pulse_schedule())
proposal = ExtendedProposal(build_prior_theta(), PulseSequenceProposal(P, CALIBRATED_CONFIG.P_SUCCESS, device=dev))
simulate = lambda: simulate_training_set_with_conditions(CALIBRATED_CONFIG, proposal, num_simulations=data["pairs"],
                                                         device=dev, verbose=False)
simulate()
torch.cuda.synchronize()
before = ddm_cuda.K1.launches
t0 = time.perf_counter()
simulate()
torch.cuda.synchronize()
ms["simulate"] = (time.perf_counter() - t0) * 1e3
ms["simulate_k1_launches"] = ddm_cuda.K1.launches - before
torch.save(outs, sys.argv[2])
print(json.dumps(ms))
"""


def _k1_trials(path: Path, device) -> None:
    """K1's trials at every size of K1_SIZES, saved for the children."""
    import torch

    from sbi_for_diffusion_models_tpu_torch import roofline
    from sbi_for_diffusion_models_tpu_torch.models.rt_choice_model import (
        generate_pulse_matrix,
        n_pulses_max_from_schedule,
        pulse_schedule,
    )
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

    n_max, spp = pulse_schedule()
    gen = make_generator(7, device)
    theta = build_prior_theta().sample(gen, (K1_SIZES[1],))
    s = generate_pulse_matrix(gen, K1_SIZES[1], n_pulses_max_from_schedule(n_max, spp))
    rt, rs, _, _ = roofline.simulator_inputs(K1_SIZES[2], device)
    trials = {K1_SIZES[0]: (theta[:K1_SIZES[0]], s[:K1_SIZES[0]]), K1_SIZES[1]: (theta, s), K1_SIZES[2]: (rt, rs)}
    torch.save({"n_max": n_max, "spp": spp, "pairs": K1_SIM_PAIRS,
                "trials": {n: (a.contiguous().cpu(), b.contiguous().cpu(), K1_REPS[n]) for n, (a, b) in trials.items()}},
               path)


def _executed_steps(path: Path, n: int, out) -> int:
    """The trial-steps K1 executed: (rt - t_nd) / dt a trial (dt 5e-4, t_max 8)."""
    import torch

    theta = torch.load(path)["trials"][n][0]
    return int(torch.round((out[:, 0] - theta[:, 4].clamp(0.0, 8.0 - 1e-6)) / 5e-4).clamp(min=0).sum())


def _model(pulse: bool) -> str:
    return PULSE_MODEL_FILE if pulse else MODEL_FILE


def _card_common():
    """``tests/card_common.py``: the session rows and the observed session."""
    sys.path.insert(0, str(ROOT / "tests"))
    import card_common

    return card_common


def _rows(path: Path, device, kernel: str) -> None:
    """The session rows of the kernel's model at every size of SIZES, saved
    for the children with the model's file name and the wrapper's name."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.mnle import load_model
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta

    wrapper, cotangent, _, pulse = KERNELS[kernel]
    model = _model(pulse)
    os.environ["MODEL_DIR"] = str(MODEL_DIR)
    est = load_model(model, device=device)
    rows = _card_common().session_rows(est, build_prior_theta(), device, -(-max(SIZES) // 1_200))
    out = {}
    for n in SIZES:
        g = torch.randn((n,), generator=torch.Generator(device).manual_seed(5), device=device)
        out[n] = ([a[:n].contiguous().cpu() for a in rows] + [g.cpu()], REPS[n])
    torch.save({"model": model, "wrapper": wrapper, "cotangent": cotangent, "rows": out}, path)


def _session(path: Path, device, call: str) -> int:
    """The observed session (``card_common.observed_session``) and 24 prior
    draws of theta, saved for the children; returns the rows a call
    evaluates."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

    prior, x_o, pulses_o = _card_common().observed_session(device)
    theta = prior.sample(make_generator(17, device), (24,))
    n = theta.shape[0] * x_o.shape[0]
    torch.save({"model": _model(CALLS[call]), "x": x_o.cpu(), "pulses": pulses_o.cpu(), "theta": theta.cpu(),
                "reps": REPS_CALL, "n": n, "warmup": SAMPLER_WARMUP, "draws": SAMPLER_DRAWS}, path)
    return n


def _run_side(root: Path, child: str, data: Path, outs: Path) -> dict:
    env = {**os.environ, "MODEL_DIR": str(root / "artifacts" / "models")}
    proc = subprocess.run([sys.executable, "-c", child, str(data), str(outs)], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"the run of {root} failed (rc {proc.returncode}):\n{proc.stdout}\n{proc.stderr[-4000:]}")
    return {int(n) if n.isdigit() else n: ms for n, ms in json.loads(proc.stdout.strip().splitlines()[-1]).items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True, help="checkout of the commit that is the 'before'")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--kernel", choices=sorted(KERNELS) + ["k1"], default="k3", help="the kernel to time")
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
        if args.call in ("sampler", "sampler_pulse"):
            label, child, names = f"ms per potential call ({args.call})", CHILD_SAMPLER, ()
            sizes = (_session(data, device, args.call),)
        elif args.call:
            label, child, names = f"log_lik_and_grad ({args.call})", CHILD_CALL, ("ll", "grad")
            sizes = (_session(data, device, args.call),)
        elif args.kernel == "k1":
            label, child, names, sizes = "K1", CHILD_K1, ("rt, choice",), K1_SIZES
            _k1_trials(data, device)
        else:
            label, child, names = args.kernel.upper().replace("P", "p"), CHILD, KERNELS[args.kernel][2]
            sizes = SIZES
            _rows(data, device, args.kernel)
        timed = (*sizes, "simulate") if args.kernel == "k1" and not args.call else sizes
        ms = {name: {n: [] for n in timed} for name in sides}
        sim_launches = {}
        for turn, name in enumerate(("parent", "this", "this", "parent")):
            got = _run_side(sides[name], child, data, Path(tmp) / f"{name}{turn}.pt")
            for n in timed:
                ms[name][n].append(got[n])
            sim_launches[name] = got.get("simulate_k1_launches")
            extra = {k: got[k] for k in ("calls", "wall_s") if k in got}
            print(f"[time] turn {turn} {name}: " + ", ".join(f"n={n} {got[n]:.4f} ms" for n in timed)
                  + (f" {json.dumps(extra)}" if extra else ""), flush=True)
        outs = {name: torch.load(Path(tmp) / f"{name}{turn}.pt") for turn, name in ((0, "parent"), (1, "this"))}
        if label == "K1":
            steps = {n: _executed_steps(data, n, outs["this"][n][0]) for n in sizes}
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
        line = (f"[{label}] n={n}: parent {mean['parent']:.4f} ms, this {mean['this']:.4f} ms, "
                f"{report['speedup'][str(n)]:.3f}x; max |diff| {report['max_abs_diff'][str(n)]}")
        if label == "K1":
            differ = int((outs["parent"][n][0] != outs["this"][n][0]).any(1).sum())
            report.setdefault("rows_differing", {})[str(n)] = differ
            report.setdefault("executed_trial_steps_per_s", {})[str(n)] = {
                name: steps[n] / (mean[name] * 1e-3) for name in sides}
            line += f"; rows differing {differ}; executed trial-steps {steps[n]}"
        print(line, flush=True)
    if label == "K1":
        for name in sides:
            wall = sum(ms[name]["simulate"]) / 2
            k1_ms = report["ms"][str(K1_SIZES[0])][name]["mean"]
            report.setdefault("simulate", {})[name] = {
                "pairs": K1_SIM_PAIRS, "wall_ms": wall, "turns": ms[name]["simulate"],
                "k1_launches": sim_launches[name], "k1_share": sim_launches[name] * k1_ms / wall}
        print(f"[K1] simulate {K1_SIM_PAIRS} pairs: {json.dumps(report['simulate'])}", flush=True)
    print(json.dumps(report))
    return 1 if any(report.get("rows_differing", {}).values()) else 0


if __name__ == "__main__":
    sys.exit(main())
