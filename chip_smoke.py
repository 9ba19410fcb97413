#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

Builds the port's CUDA kernels from ``sbi_for_diffusion_models_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, then drives the
port's main path once through its public entry points:

1. build K1 (pulse-DDM simulator), K2/K3 (fused MNLE log-prob forward and
   backward) with nvcc for sm_90a;
2. K1 against its plain version at N = 131,072 prior draws: equal outputs
   without noise; with noise a two-sample KS test on RT per choice and a
   chi-square test on the choice counts (p > 1e-3); the same seed twice
   gives the same output;
3. K2/K3 against their plain version on the committed flagship model
   (``artifacts/models/mnle_10m_shifted_logt_affine.npz``) at 1,200 rows
   (4 chains x 6 replicas x 50 trials) and 115,200 rows (96 such sessions):
   values to 1e-4 x max(1, |ref|) and gradients to 1e-3 relative L-inf
   against the plain version in float64, with a per-row allowance where
   float32 cannot resolve the function (see ``phase_k2k3``);
4. simulate 131,072 training pairs, an observed 50-trial session, load the
   flagship model and sample its posterior with the calibrated sampler
   (PT6 NUTS, grid hop, t_nd slice; warmup and draws cut to 50 and 200).
   Every kernel must have launched during this phase.

Run from the root of a checkout: ``python3 chip_smoke.py`` (one CUDA card,
``nvcc`` under /usr/local/cuda or on PATH). The last line of its output is
``{"ok": true, "device": {...}}``; the line before it lists the kernels with
their launches, errors and times. Any failed check raises, and the script
exits non-zero without that line. There is no CPU fallback: without a CUDA
card the script exits with status 2.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "sbi_for_diffusion_models_tpu_torch"
MODEL_FILE = "mnle_10m_shifted_logt_affine.npz"

N_SIM = 131_072  # K1 check size and the main path's training-set size
ROWS_MAIN = 1_200  # 4 chains x 6 replicas x 50 trials
ROWS_SBC = 115_200  # 96 sessions of the above
K2_VALUE_TOL = 1e-4  # |dvalue| / max(1, |ref|)
K3_GRAD_TOL = 1e-3  # max |dgrad| / max |ref| (relative L-infinity)
PERTURB = 2.0**-20  # relative input change behind a row's conditioning allowance (8 float32 ulps at 1)
PLAIN_FACTOR = 3.0  # the kernel's worst row may exceed its allowance by 3x what the plain float32 version's does
P_MIN = 1e-3  # K1 distribution tests


def _log(*args) -> None:
    print(*args, flush=True)


def _time_ms(fn, reps: int, device) -> float:
    """Mean milliseconds per call of ``fn`` after one warm-up call: CUDA
    events around ``reps`` calls on a card, the host clock on the CPU."""
    import torch

    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build() -> dict:
    from sbi_for_diffusion_models_tpu_torch.ops import _cuda, ddm_cuda, mnle_cuda  # noqa: F401

    t0 = time.perf_counter()
    per_file = _cuda.build_all()
    _log(f"[build] {json.dumps(per_file)} total_s={time.perf_counter() - t0:.3f}")
    return per_file


def phase_k1(device, n: int, seed: int = 7) -> dict:
    """K1 against its plain version at ``n`` prior draws."""
    import numpy as np
    import torch
    from scipy import stats

    from sbi_for_diffusion_models_tpu_torch.models.rt_choice_model import (
        generate_pulse_matrix,
        n_pulses_max_from_schedule,
        pulse_schedule,
    )
    from sbi_for_diffusion_models_tpu_torch.ops.ddm_cuda import ddm_rt_choice_cuda
    from sbi_for_diffusion_models_tpu_torch.ops.ddm_scan import ddm_rt_choice_scan
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

    n_max, spp = pulse_schedule()
    P = n_pulses_max_from_schedule(n_max, spp)
    gen = make_generator(seed, device)
    theta = build_prior_theta().sample(gen, (n,))
    s = generate_pulse_matrix(gen, n, P)
    kw = dict(steps_per_pulse=spp, n_max=n_max)

    def kernel(mu, sd, th=theta, st=s):
        return ddm_rt_choice_cuda(th, st, sd, mu_sensory=mu, **kw)

    def plain(mu, sd, th=theta, st=s):
        return ddm_rt_choice_scan(th, st, sd, mu_sensory=mu, chunk_steps=spp, **kw)

    a, b = kernel(0.0, 1), plain(0.0, 2)
    n_diff = int((a != b).any(1).sum())
    max_abs = float((a - b).abs().max())
    _log(f"[K1] zero noise n={n}: rows differing={n_diff} max_abs_err={max_abs}")
    if n_diff:
        raise AssertionError(f"K1 differs from its plain version without noise on {n_diff} rows")

    a1, a2, b = kernel(1.0, 11), kernel(1.0, 11), plain(1.0, 12)
    if not torch.equal(a1, a2):
        raise AssertionError("K1 gives different outputs for the same seed")
    an, bn = a1.cpu().numpy(), b.cpu().numpy()
    counts = np.array([[np.sum(x[:, 1] == c) for c in range(3)] for x in (an, bn)])
    chi2_p = float(stats.chi2_contingency(counts)[1])
    ks_p = [float(stats.ks_2samp(an[an[:, 1] == c, 0], bn[bn[:, 1] == c, 0]).pvalue) for c in (0, 1)]
    _log(f"[K1] noise n={n}: choice counts kernel={counts[0].tolist()} plain={counts[1].tolist()} "
         f"chi2_p={chi2_p:.4g} ks_p(rt|choice 0,1)={[round(p, 4) for p in ks_p]} same_seed_equal=True")
    if min([chi2_p] + ks_p) <= P_MIN:
        raise AssertionError(f"K1 and its plain version differ in distribution (p <= {P_MIN})")

    # Times at the main path's batch (TRAIN_BATCH_SIZE = 4,096) and at n.
    times = {}
    for m in (4096, n):
        k_ms = _time_ms(lambda: kernel(1.0, 3, theta[:m], s[:m]), 5, device)
        p_ms = _time_ms(lambda: plain(1.0, 4, theta[:m], s[:m]), 1, device)
        times[m] = (k_ms, p_ms)
        _log(f"[K1] time n={m}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
             f"nominal_trial_steps_per_s(kernel)={m * n_max / (k_ms * 1e-3):.4g}")
    return {"max_abs_err": max_abs, "ms": times[4096][0], "plain_ms": times[4096][1], "times": times}


def _session_rows(est, prior, device, n_sessions: int, seed: int = 11):
    """Standardized rows as the posterior potential builds them: per session
    a prior draw theta_true, its simulated 50-trial session, and 24 thetas
    (theta_true and 23 prior draws) against every trial."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.data_simulator import simulate_observed_session
    from sbi_for_diffusion_models_tpu_torch.utils.rng import child_seed, make_generator

    ts, ohs, cs = [], [], []
    for i in range(n_sessions):
        gen = make_generator(child_seed(seed, i), device)
        theta = prior.sample(gen, (24,))
        x, s = simulate_observed_session(theta[0], 50, seed=child_seed(seed, 1000 + i), device=device)
        cond = torch.cat([theta[:, None, :].expand(24, 50, 5), s[None].expand(24, 50, s.shape[1])], -1)
        t, oh, c, _, _, _ = est.standardize(x[None].expand(24, 50, 2).reshape(-1, 2), cond.reshape(-1, cond.shape[-1]))
        ts.append(t)
        ohs.append(oh)
        cs.append(c)
    return torch.cat(ts).contiguous(), torch.cat(ohs).contiguous(), torch.cat(cs).contiguous()


def _reference(t, oh, c, w64, g):
    """The plain version in float64 on the same float32 rows: (value, dt,
    dctx), and per row how far each moves when the row's inputs move by
    PERTURB (t by PERTURB * max(|t|, 1), then ctx by a factor 1 -+ PERTURB).
    That spread is the row's conditioning at float32 resolution."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda as mc

    T, O, C, G = t.double(), oh.double(), c.double(), g.double()

    def run(tt, cc):
        return (mc.rows_logp_plain(tt, O, cc, w64), *mc.rows_logp_vjp_plain(tt, O, cc, w64, G))

    ref = run(T, C)
    spread = [torch.zeros_like(T) for _ in ref]
    dt_in = PERTURB * T.abs().clamp(min=1.0)
    for tt, cc in ((T + dt_in, C), (T - dt_in, C), (T, C * (1 + PERTURB)), (T, C * (1 - PERTURB))):
        for i, x in enumerate(run(tt, cc)):
            spread[i] = torch.maximum(spread[i], (x - ref[i]).abs().reshape(T.shape[0], -1).amax(1))
    return ref, spread


def phase_k2k3(device, sizes=(ROWS_MAIN, ROWS_SBC)) -> dict:
    """K2/K3 against their plain version on the same rows.

    The reference is the plain version run in float64 on the kernels'
    float32 inputs and weights. Each row's allowance is the stated
    tolerance plus twice the row's spread (see ``_reference``): where the
    exact function moves more than the tolerance under an input change of a
    few float32 ulps (steep densities, spline knots, ReLU kinks), no
    float32 evaluation can be held to the fixed tolerance. The plain version
    in float32 is measured the same way, and the kernel passes when its
    worst row is within max(1, PLAIN_FACTOR x the plain version's worst
    row) of its allowance: the stated tolerance wherever float32 can meet
    it, and the plain version's own accuracy elsewhere. The kernel's direct
    difference from the plain float32 version is printed beside."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.mnle import load_model
    from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda as mc
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta

    os.environ["MODEL_DIR"] = str(ROOT / "artifacts" / "models")
    est = load_model(MODEL_FILE, device=device)
    w32 = mc.pack_mnle_weights(est)
    w64 = w32.astype(torch.float64)
    prior = build_prior_theta()
    out = {}
    for n in sizes:
        t, oh, c = _session_rows(est, prior, device, max(1, n // 1200))
        g = torch.randn(t.shape, generator=torch.Generator(device).manual_seed(5), device=device)
        kern = (mc.rows_logp(t, oh, c, w32), *mc.rows_logp_vjp(t, oh, c, w32, g))
        plain = (mc.rows_logp_plain(t, oh, c, w32), *mc.rows_logp_vjp_plain(t, oh, c, w32, g))
        ref, spread = _reference(t, oh, c, w64, g)
        for name, x in zip(("K2 value", "K3 dt", "K3 dctx"), kern):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"{name} has non-finite values at {n} rows")
        for i, (what, tol) in enumerate((("value", K2_VALUE_TOL), ("dt", K3_GRAD_TOL), ("dctx", K3_GRAD_TOL))):
            # value: |d| / max(1, |ref|) per row; gradients: relative L-infinity.
            scale = ref[i].abs().clamp(min=1.0) if i == 0 else ref[i].abs().max()
            allow = tol * scale + 2.0 * spread[i]
            steep = int((2.0 * spread[i] > tol * scale).sum())

            def row_err(x):
                return (x.double() - ref[i]).abs().reshape(n, -1).amax(1)

            k_ratio = float((row_err(kern[i]) / allow).max())
            p_ratio = float((row_err(plain[i]) / allow).max())
            flat = (2.0 * spread[i] <= tol * scale)
            k_flat = float((row_err(kern[i]) / scale)[flat].max()) if bool(flat.any()) else 0.0
            direct = float(((kern[i] - plain[i]).abs().reshape(n, -1).amax(1)
                            / (plain[i].abs().clamp(min=1.0) if i == 0 else plain[i].abs().max())).max())
            _log(f"[K2/K3] n={n} {what}: max err/allowance kernel={k_ratio:.3f} plain_f32={p_ratio:.3f} "
                 f"(tol={tol:g}; rows steeper than tol at {PERTURB:.2g} input change: {steep}); "
                 f"kernel rel err on the other rows={k_flat:.3e}; kernel vs plain f32={direct:.3e}")
            bound = max(1.0, PLAIN_FACTOR * p_ratio)
            if k_ratio > bound:
                raise AssertionError(
                    f"K2/K3 {what} at {n} rows: error {k_ratio:.3f}x its allowance, above {bound:.3f} "
                    f"(max(1, {PLAIN_FACTOR:g} x the plain float32 version's {p_ratio:.3f}))"
                )
        reps = 20 if n <= ROWS_MAIN else 5
        times = {
            "K2": (_time_ms(lambda: mc.rows_logp(t, oh, c, w32), reps, device),
                   _time_ms(lambda: mc.rows_logp_plain(t, oh, c, w32), reps, device)),
            "K3": (_time_ms(lambda: mc.rows_logp_vjp(t, oh, c, w32, g), reps, device),
                   _time_ms(lambda: mc.rows_logp_vjp_plain(t, oh, c, w32, g), reps, device)),
        }
        for name, (k_ms, p_ms) in times.items():
            _log(f"[{name}] time n={n}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                 f"rows_per_s(kernel)={n / (k_ms * 1e-3):.4g}")
        out[n] = {
            "K2_max_abs_err": float((kern[0] - plain[0]).abs().max()),
            "K3_max_abs_err": max(float((kern[1] - plain[1]).abs().max()), float((kern[2] - plain[2]).abs().max())),
            "times": times,
        }
    return out


def phase_main(device, n_sim: int = N_SIM, warmup: int = 50, draws: int = 200) -> dict:
    """The port's main path through its public entry points."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.data_simulator import (
        simulate_observed_session,
        simulate_training_set_with_conditions,
        summarize_trials,
    )
    from sbi_for_diffusion_models_tpu_torch.inference.diagnostics import effective_sample_size, split_r_hat
    from sbi_for_diffusion_models_tpu_torch.mnle import load_model, run_inference_mcmc
    from sbi_for_diffusion_models_tpu_torch.models.rt_choice_model import (
        n_pulses_max_from_schedule,
        pulse_schedule,
    )
    from sbi_for_diffusion_models_tpu_torch.ops._cuda import KERNELS
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu_torch.proposals import ExtendedProposal, PulseSequenceProposal
    from sbi_for_diffusion_models_tpu_torch.run_config import CALIBRATED_CONFIG
    from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    for k in KERNELS.values():
        k.launches = 0
    walls = {}
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    P = n_pulses_max_from_schedule(*pulse_schedule())
    prior = build_prior_theta()
    proposal = ExtendedProposal(prior, PulseSequenceProposal(P, CALIBRATED_CONFIG.P_SUCCESS, device=device))
    z, x = simulate_training_set_with_conditions(CALIBRATED_CONFIG, proposal, num_simulations=n_sim, device=device)
    sync()
    walls["simulate"] = time.perf_counter() - t0
    summarize_trials("train", x)
    if tuple(x.shape) != (n_sim, 2) or tuple(z.shape) != (n_sim, 5 + P):
        raise AssertionError(f"training set shapes {tuple(z.shape)}, {tuple(x.shape)}")

    t0 = time.perf_counter()
    theta_true = prior.sample(make_generator(3, device), (1,))[0]
    x_o, pulses_o = simulate_observed_session(theta_true, CALIBRATED_CONFIG.NUM_TRIALS_OBS, seed=123, device=device)
    sync()
    walls["observe"] = time.perf_counter() - t0
    _log(f"[main] theta_true={[round(v, 4) for v in theta_true.tolist()]}")
    summarize_trials("observed", x_o)

    t0 = time.perf_counter()
    os.environ["MODEL_DIR"] = str(ROOT / "artifacts" / "models")
    est = load_model(MODEL_FILE, device=device)
    walls["load"] = time.perf_counter() - t0

    cfg = CALIBRATED_CONFIG.replace(WARMUP_STEPS=warmup, POSTERIOR_SAMPLES=draws)
    t0 = time.perf_counter()
    samples, info = run_inference_mcmc(cfg, prior, est, x_o, pulses_o, device=device, seed=0, return_info=True)
    sync()
    walls["mcmc"] = time.perf_counter() - t0
    walls["total"] = time.perf_counter() - t_all
    launches = {name: k.launches for name, k in KERNELS.items()}

    if tuple(samples.shape) != (draws, 5):
        raise AssertionError(f"posterior samples have shape {tuple(samples.shape)}, expected ({draws}, 5)")
    if not bool(torch.isfinite(samples).all()):
        raise AssertionError("non-finite posterior samples")
    if not bool(torch.isfinite(prior.log_prob(samples)).all()):
        raise AssertionError("posterior samples outside the prior's support")
    C, R = cfg.NUM_CHAINS, cfg.MCMC_PT_REPLICAS
    div = info["diverging"]
    cold_div = int(div.reshape(C, R, -1)[:, 0].sum())
    # Pooled draws interleave the cold chains: draw k of chain c is row k*C + c.
    chains = samples.reshape(-1, C, samples.shape[-1]).transpose(0, 1)
    diag = {"r_hat": split_r_hat(chains), "ess": effective_sample_size(chains)}
    steps = info["num_steps"].to(torch.float64)
    _log(f"[main] walls_s={json.dumps({k: round(v, 3) for k, v in walls.items()})}")
    _log(f"[main] divergences(all rungs)={int(div.sum())} divergences(cold chains)={cold_div} "
         f"mean_tree_leaves={float(steps.mean()):.2f} swap_accept={info.get('swap_accept', float('nan')):.3f} "
         f"potential_calls={info['potential_calls']} ms_per_call={walls['mcmc'] * 1e3 / info['potential_calls']:.3f}")
    _log(f"[main] split_r_hat={[round(float(v), 4) for v in diag['r_hat']]} "
         f"ess={[round(float(v), 1) for v in diag['ess']]} "
         f"posterior_mean={[round(v, 4) for v in samples.mean(0).tolist()]}")
    _log(f"[main] launches={json.dumps(launches)}")
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    return {"walls": walls, "launches": launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    if not (ROOT / PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG}/csrc not found next to this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _log(f"[device] torch={torch.__version__} cuda={torch.version.cuda} device={name}")

    phase_build()
    k1 = phase_k1(device, N_SIM)
    k23 = phase_k2k3(device)
    main_path = phase_main(device)

    from sbi_for_diffusion_models_tpu_torch.ops import _cuda

    src = f"{PKG}/csrc"
    replaces = {
        "ddm_rt_choice": ("ddm_rt_choice.cu", "sbi_for_diffusion_models_tpu/ops/ddm_pallas.py:60"),
        "mnle_logprob_fwd": ("mnle_logprob.cu", "sbi_for_diffusion_models_tpu/ops/mnle_pallas.py:269"),
        "mnle_logprob_bwd": ("mnle_logprob.cu", "sbi_for_diffusion_models_tpu/ops/mnle_pallas.py:275"),
    }
    main_rows = k23[ROWS_MAIN]
    numbers = {
        "ddm_rt_choice": (k1["max_abs_err"], k1["ms"], k1["plain_ms"]),
        "mnle_logprob_fwd": (main_rows["K2_max_abs_err"], *main_rows["times"]["K2"]),
        "mnle_logprob_bwd": (main_rows["K3_max_abs_err"], *main_rows["times"]["K3"]),
    }
    kernels = []
    for kname in _cuda.KERNELS:
        f, rep = replaces[kname]
        err, ms, plain_ms = numbers[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": f"{src}/{f}", "replaces": rep,
            "launches": main_path["launches"][kname], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
