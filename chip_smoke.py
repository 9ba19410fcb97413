#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

Builds the port's CUDA kernels from ``sbi_for_diffusion_models_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, then drives the
port's two serving paths once each through their public entry points:

1. build K1 (pulse-DDM simulator), K2/K3 (fused MNLE log-prob forward and
   backward) and K2p/K3p (the same for the pulse-grid RT representation)
   with nvcc for sm_90a, one nvcc per source, side by side;
2. K1 against its plain version at N = 131,072 prior draws: equal outputs
   without noise; with noise a two-sample KS test on RT per choice and a
   chi-square test on the choice counts (p > 1e-3); the same seed twice
   gives the same output;
3. K2/K3 against their plain version on the committed flagship model
   (``artifacts/models/mnle_10m_shifted_logt_affine.npz``) at 1,200 rows
   (4 chains x 6 replicas x 50 trials) and 115,200 rows (96 such sessions):
   each row's value to 1e-4 x max(1, |ref|) and its gradients to 1e-3 x
   max(1, the row's largest |ref|) against the plain version in float64,
   with an allowance on rows where float32 cannot resolve the function and
   a limit on the share of rows over their allowance (see ``phase_k2k3``);
4. K2p/K3p against their plain version on the committed pulse-grid model
   (``artifacts/models/mnle_1m_pulseabs.npz``, absolute anchor) at the same
   two sizes, held the same way (values, dphi, dctx and dkf);
5. the flagship path: simulate 131,072 training pairs, an observed 50-trial
   session, load the flagship model and sample its posterior with the
   calibrated sampler (PT6 NUTS, grid hop, t_nd slice; warmup and draws cut
   to 50 and 200). K1, K2 and K3 must have launched during this phase;
6. the pulse path: the same observed session, the pulse-grid model loaded
   and sampled by the same sampler at the same cut. K2p and K3p must have
   launched during this phase.

Each kernel's bound is the larger of its FP32 operations over 67 TFLOP/s
and its bytes (inputs read once, outputs written once) over 3.35 TB/s, the
H100 SXM's published rates, counted from this run's shapes (K1: from the
steps its trials executed). No single PyTorch call computes any of these
kernels, so ``library_ms`` is null.

Run from the root of a checkout: ``python3 chip_smoke.py`` (one CUDA card,
``nvcc`` under /usr/local/cuda or on PATH). The last line of its output is
``{"ok": true, "device": {...}}``; the line before it lists the kernels with
their launches, errors, times and bounds. Any failed check raises, and the
script exits non-zero without that line. There is no CPU fallback: without
a CUDA card the script exits with status 2.
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
PULSE_MODEL_FILE = "mnle_1m_pulseabs.npz"
FP32_OPS_PER_S = 67e12  # H100 SXM, FP32 outside the tensor cores (an FMA counts 2)
HBM_BYTES_PER_S = 3.35e12
K1_OPS_PER_STEP = 40  # see k1_bound

N_SIM = 131_072  # K1 check size and the main path's training-set size
ROWS_MAIN = 1_200  # 4 chains x 6 replicas x 50 trials
ROWS_SBC = 115_200  # 96 sessions of the above
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


def _bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of the operation and byte times."""
    t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def k1_bound(theta, out, n_chunks: int, dt: float = 5e-4, t_max: float = 8.0) -> tuple[float, str, int]:
    """K1's bound from the steps its trials executed: a trial runs to its
    hit step, or to the end of its window if it timed out, and both equal
    (rt - t_nd) / dt. Per step ``csrc/ddm_rt_choice.cu`` does 5 FP32 ops of
    Euler-Maruyama update and 2 bound compares, half a Box-Muller pair (about
    8 ops with its log, sqrt and sincos) and a quarter of a Philox4x32-10
    call (10 rounds of 2 mulhi, 2 mullo, 4 xor and 2 adds: 25 integer ops):
    K1_OPS_PER_STEP = 40, all counted at the FP32 rate. Bytes: theta (5) and
    the stimulus's n_chunks columns in, (rt, choice) out, float32."""
    import torch

    tnd = theta[:, 4].clamp(0.0, t_max - 1e-6)
    steps = int(torch.round((out[:, 0] - tnd) / dt).clamp(min=0).sum())
    n = theta.shape[0]
    ms, by = _bound(K1_OPS_PER_STEP * steps, 4 * n * (5 + n_chunks + 2))
    return ms, by, steps


def mnle_bound(w, n: int, backward: bool) -> tuple[float, str]:
    """K2/K3 (K2p/K3p) bound at n rows: 2 FLOP per multiply-add of the
    forward products (categorical MLP, trunk, slot head, head on [emb, kf])
    and, for the backward kernel, of its input-gradient products (the same
    matrices transposed; the first layers only to the D context columns; no
    weight gradients). The per-row softmaxes and splines are not counted.
    Bytes: the packed weights once, the row inputs, the cotangent and the
    outputs."""
    D = w.cat[0][0].shape[0]
    H = w.trunk[-1][0].shape[1]
    HF, HO = w.head_w.shape
    layers = [W.shape for W, _ in w.cat + w.trunk] + ([w.slot[0].shape] if w.pulse else []) + [(HF, HO)]
    macs = sum(a * b for a, b in layers)
    if backward:
        first = {0, len(w.cat)}  # first layers of the two MLPs: gradients to the D context columns only
        macs += sum((D if i in first else a) * b for i, (a, b) in enumerate(layers))
    C, F = w.cat[-1][0].shape[1], HF - H
    row_in = (1 + C + D + F + (1 if w.pulse else 0)) * 4
    row_out = (1 + D + F) * 4 if backward else 4
    nbytes = 4 * sum(a.numel() for a in w.as_list()) + n * (row_in + row_out + (4 if backward else 0))
    return _bound(2.0 * macs * n, nbytes)


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

    # Times at the main path's batch (TRAIN_BATCH_SIZE = 4,096) and at n,
    # with the bound from the steps the timed call's trials executed.
    times = {}
    for m in (4096, n):
        k_ms = _time_ms(lambda: kernel(1.0, 3, theta[:m], s[:m]), 5, device)
        p_ms = _time_ms(lambda: plain(1.0, 4, theta[:m], s[:m]), 1, device)
        b_ms, b_by, steps = k1_bound(theta[:m], kernel(1.0, 3, theta[:m], s[:m]), n_max // spp)
        times[m] = (k_ms, p_ms, b_ms, b_by)
        _log(f"[K1] time n={m}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={b_ms:.4g} ({b_by}) "
             f"executed_trial_steps={steps} ({steps / (m * n_max):.4f} of nominal) "
             f"executed_trial_steps_per_s(kernel)={steps / (k_ms * 1e-3):.4g}")
    return {"max_abs_err": max_abs, "ms": times[4096][0], "plain_ms": times[4096][1],
            "bound_ms": times[4096][2], "bound_by": times[4096][3], "times": times}


def _session_rows(est, prior, device, n_sessions: int, seed: int = 11):
    """Standardized rows as the posterior potential builds them: per session
    a prior draw theta_true, its simulated 50-trial session, and 24 thetas
    (theta_true and 23 prior draws) against every trial. Returns the
    kernels' row inputs: (t, onehot, ctx), or for the pulse rep (phi,
    onehot, ctx, kf, kv)."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.data_simulator import simulate_observed_session
    from sbi_for_diffusion_models_tpu_torch.utils.rng import child_seed, make_generator

    parts = []
    for i in range(n_sessions):
        gen = make_generator(child_seed(seed, i), device)
        theta = prior.sample(gen, (24,))
        x, s = simulate_observed_session(theta[0], 50, seed=child_seed(seed, 1000 + i), device=device)
        cond = torch.cat([theta[:, None, :].expand(24, 50, 5), s[None].expand(24, 50, s.shape[1])], -1)
        xr, cr = x[None].expand(24, 50, 2).reshape(-1, 2), cond.reshape(-1, cond.shape[-1])
        if est.cfg.rt_rep == "pulse":
            phi, oh, c, kf, kv, _, _ = est.standardize_pulse(xr, cr)
            parts.append((phi, oh, c, kf, kv))
        else:
            t, oh, c, _, _, _ = est.standardize(xr, cr)
            parts.append((t, oh, c))
    return tuple(torch.cat(col).contiguous() for col in zip(*parts))


def _check_against_reference(label, names, kern, plain, ref, spread, n) -> None:
    """Each output of the kernel against the float64 reference, row by row
    (``ops/rowcheck.row_check``: the value to 1e-4 and the gradients to
    1e-3, each times the row's own scale, on all but 0.1 % of the rows; the
    value also on its worst row); logs every output with its worst row,
    then raises if one failed."""
    from sbi_for_diffusion_models_tpu_torch.ops.rowcheck import MAX_OVER_SHARE, PERTURB, row_check

    failed = []
    for i, name in enumerate(names):
        c = row_check(kern[i], plain[i], ref[i], spread[i], value=i == 0)
        r = c.worst_row
        col = int((kern[i][r].double() - ref[i][r]).abs().reshape(-1).argmax())
        at = [float(x[r].reshape(-1)[col]) for x in (kern[i], plain[i], ref[i])]
        limit = f"{c.limit:.3f}" if c.limit is not None else "none"
        _log(f"[{label}] n={n} {name}: rows over their allowance kernel={c.share:.3e} "
             f"({int(c.over.sum())} rows) plain_f32={c.plain_share:.3e} (limit {MAX_OVER_SHARE:g}); "
             f"worst err/allowance kernel={c.worst:.3f} plain_f32={c.plain_worst:.3f} (limit {limit}) "
             f"at row {r} (kernel {at[0]:.7g} plain_f32 {at[1]:.7g} float64 {at[2]:.7g}); "
             f"tol={c.tol:g} x max(1, row max |ref|); steep rows at {PERTURB:.2g} input change: {c.steep}; "
             f"kernel rel err on the other rows={c.flat_err:.3e}")
        if not c.ok:
            failed.append(f"{name} ({c.share:.3e} of the rows over their allowance, worst {c.worst:.3f}, "
                          f"limit {limit}, finite {bool(kern[i].isfinite().all())})")
    if failed:
        raise AssertionError(f"{label} at {n} rows fails its float64 check: {'; '.join(failed)}")


def _phase_fused(device, model_file, fwd, bwd, sizes) -> dict:
    """A fused forward/backward pair against its plain versions on the
    committed model ``model_file``, at each row count of ``sizes``.
    ``fwd``/``bwd`` are (label, kernel wrapper, plain version)."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.mnle import load_model
    from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda as mc
    from sbi_for_diffusion_models_tpu_torch.ops.rowcheck import reference
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta

    os.environ["MODEL_DIR"] = str(ROOT / "artifacts" / "models")
    est = load_model(model_file, device=device)
    w32 = mc.pack_mnle_weights(est)
    w64 = w32.astype(torch.float64)
    prior = build_prior_theta()
    (f_label, f_kernel, f_plain), (b_label, b_kernel, b_plain) = fwd, bwd
    grad_names = ("dphi", "dctx", "dkf") if w32.pulse else ("dt", "dctx")
    out = {}
    for n in sizes:
        rows = _session_rows(est, prior, device, max(1, n // 1200))
        g = torch.randn(rows[0].shape, generator=torch.Generator(device).manual_seed(5), device=device)
        kern = (f_kernel(*rows, w32), *b_kernel(*rows, w32, g))
        plain = (f_plain(*rows, w32), *b_plain(*rows, w32, g))
        continuous = (2, 3) if w32.pulse else (2,)  # ctx (and kf); never the one-hot or the slot index
        ref, spread = reference(
            lambda *a: (f_plain(*a[:-1], w64), *b_plain(*a[:-1], w64, a[-1])), rows, g, continuous)
        _check_against_reference(f"{f_label}/{b_label}", ("value",) + grad_names, kern, plain, ref, spread, n)
        reps = 20 if n <= ROWS_MAIN else 5
        times = {
            f_label: (_time_ms(lambda: f_kernel(*rows, w32), reps, device),
                      _time_ms(lambda: f_plain(*rows, w32), reps, device), *mnle_bound(w32, n, False)),
            b_label: (_time_ms(lambda: b_kernel(*rows, w32, g), reps, device),
                      _time_ms(lambda: b_plain(*rows, w32, g), reps, device), *mnle_bound(w32, n, True)),
        }
        for name, (k_ms, p_ms, b_ms, b_by) in times.items():
            _log(f"[{name}] time n={n}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={b_ms:.4g} ({b_by}, "
                 f"{b_ms / k_ms:.3f} of it) rows_per_s(kernel)={n / (k_ms * 1e-3):.4g}")
        out[n] = {
            f_label: {"max_abs_err": float((kern[0] - plain[0]).abs().max()), "times": times[f_label]},
            b_label: {"max_abs_err": max(float((k - pl).abs().max()) for k, pl in zip(kern[1:], plain[1:])),
                      "times": times[b_label]},
        }
    return out


def phase_k2k3(device, sizes=(ROWS_MAIN, ROWS_SBC)) -> dict:
    """K2/K3 against their plain version on the same rows.

    The reference is the plain version run in float64 on the kernels'
    float32 inputs and weights. Each row is held to the stated tolerance
    times its own scale, max(1, its largest |ref|); where the exact function
    moves more than that under an input change of a few float32 ulps (steep
    densities, spline knots, ReLU kinks: the row's spread), no float32
    evaluation can be held to the fixed tolerance, and twice the spread is
    added. The kernel fails when more than 0.1 % of the rows exceed their
    allowance, or when the value's worst row exceeds it by more than
    min(10, max(1, 3 x the plain float32 version's worst row)); the plain
    version's share and worst row are printed beside. A gradient is not
    held on its worst row: a float32 evaluation that lands exactly on a
    knot or a clip bound takes the clip's half gradient there, and the
    float64 reference never lands on it (``ops/rowcheck.py``)."""
    from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda as mc

    return _phase_fused(device, MODEL_FILE, ("K2", mc.rows_logp, mc.rows_logp_plain),
                        ("K3", mc.rows_logp_vjp, mc.rows_logp_vjp_plain), sizes)


def phase_k2pk3p(device, sizes=(ROWS_MAIN, ROWS_SBC)) -> dict:
    """K2p/K3p against their plain version on the pulse-grid model, held as
    K2/K3 are (``phase_k2k3``) over the value and dphi, dctx and dkf."""
    from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda as mc

    return _phase_fused(device, PULSE_MODEL_FILE,
                        ("K2p", mc.rows_logp_pulse, mc.rows_logp_pulse_plain),
                        ("K3p", mc.rows_logp_pulse_vjp, mc.rows_logp_pulse_vjp_plain), sizes)


def _sample_posterior(label, device, model_file, prior, x_o, pulses_o, warmup: int, draws: int) -> dict:
    """Load ``model_file`` and sample the posterior of the session (x_o,
    pulses_o) with the calibrated sampler (warmup and draws cut), through the
    public entry points; checks the draws and prints the sampler's numbers."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.inference.diagnostics import effective_sample_size, split_r_hat
    from sbi_for_diffusion_models_tpu_torch.mnle import load_model, run_inference_mcmc
    from sbi_for_diffusion_models_tpu_torch.run_config import CALIBRATED_CONFIG

    walls = {}
    t0 = time.perf_counter()
    os.environ["MODEL_DIR"] = str(ROOT / "artifacts" / "models")
    est = load_model(model_file, device=device)
    walls["load"] = time.perf_counter() - t0

    cfg = CALIBRATED_CONFIG.replace(WARMUP_STEPS=warmup, POSTERIOR_SAMPLES=draws)
    t0 = time.perf_counter()
    samples, info = run_inference_mcmc(cfg, prior, est, x_o, pulses_o, device=device, seed=0, return_info=True)
    torch.cuda.synchronize()
    walls["mcmc"] = time.perf_counter() - t0

    if tuple(samples.shape) != (draws, 5):
        raise AssertionError(f"{label}: posterior samples have shape {tuple(samples.shape)}, expected ({draws}, 5)")
    if not bool(torch.isfinite(samples).all()):
        raise AssertionError(f"{label}: non-finite posterior samples")
    if not bool(torch.isfinite(prior.log_prob(samples)).all()):
        raise AssertionError(f"{label}: posterior samples outside the prior's support")
    C, R = cfg.NUM_CHAINS, cfg.MCMC_PT_REPLICAS
    div = info["diverging"]
    cold_div = int(div.reshape(C, R, -1)[:, 0].sum())
    # Pooled draws interleave the cold chains: draw k of chain c is row k*C + c.
    chains = samples.reshape(-1, C, samples.shape[-1]).transpose(0, 1)
    diag = {"r_hat": split_r_hat(chains), "ess": effective_sample_size(chains)}
    steps = info["num_steps"].to(torch.float64)
    _log(f"[{label}] divergences(all rungs)={int(div.sum())} divergences(cold chains)={cold_div} "
         f"mean_tree_leaves={float(steps.mean()):.2f} swap_accept={info.get('swap_accept', float('nan')):.3f} "
         f"potential_calls={info['potential_calls']} ms_per_call={walls['mcmc'] * 1e3 / info['potential_calls']:.3f}")
    _log(f"[{label}] split_r_hat={[round(float(v), 4) for v in diag['r_hat']]} "
         f"ess={[round(float(v), 1) for v in diag['ess']]} "
         f"posterior_mean={[round(v, 4) for v in samples.mean(0).tolist()]}")
    return walls


def _observed_session(device):
    """The observed session both paths sample: theta_true from the prior
    (seed 3) and its 50-trial session (seed 123)."""
    from sbi_for_diffusion_models_tpu_torch.data_simulator import simulate_observed_session, summarize_trials
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu_torch.run_config import CALIBRATED_CONFIG
    from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

    prior = build_prior_theta()
    theta_true = prior.sample(make_generator(3, device), (1,))[0]
    x_o, pulses_o = simulate_observed_session(theta_true, CALIBRATED_CONFIG.NUM_TRIALS_OBS, seed=123, device=device)
    _log(f"[session] theta_true={[round(v, 4) for v in theta_true.tolist()]}")
    summarize_trials("observed", x_o)
    return prior, x_o, pulses_o


def _launches_on(label, required, run) -> tuple:
    """Run ``run()`` with every kernel's count set to 0 just before and read
    just after; fail unless each kernel in ``required`` launched."""
    from sbi_for_diffusion_models_tpu_torch.ops._cuda import KERNELS

    for k in KERNELS.values():
        k.launches = 0
    result = run()
    launches = {name: k.launches for name, k in KERNELS.items()}
    _log(f"[{label}] launches={json.dumps(launches)}")
    missing = [name for name in required if launches[name] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {label} path: {missing}")
    return result, launches


def phase_main(device, n_sim: int = N_SIM, warmup: int = 50, draws: int = 200) -> dict:
    """The flagship serving path through its public entry points: simulate
    a training set and the observed session (K1), load the flagship model
    and sample its posterior (K2/K3 at every gradient)."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.data_simulator import (
        simulate_training_set_with_conditions,
        summarize_trials,
    )
    from sbi_for_diffusion_models_tpu_torch.models.rt_choice_model import (
        n_pulses_max_from_schedule,
        pulse_schedule,
    )
    from sbi_for_diffusion_models_tpu_torch.proposals import ExtendedProposal, PulseSequenceProposal
    from sbi_for_diffusion_models_tpu_torch.run_config import CALIBRATED_CONFIG

    def run():
        walls = {}
        t_all = time.perf_counter()
        t0 = time.perf_counter()
        P = n_pulses_max_from_schedule(*pulse_schedule())
        prior, x_o, pulses_o = _observed_session(device)
        proposal = ExtendedProposal(prior, PulseSequenceProposal(P, CALIBRATED_CONFIG.P_SUCCESS, device=device))
        z, x = simulate_training_set_with_conditions(CALIBRATED_CONFIG, proposal, num_simulations=n_sim,
                                                     device=device)
        torch.cuda.synchronize()
        walls["simulate"] = time.perf_counter() - t0
        summarize_trials("train", x)
        if tuple(x.shape) != (n_sim, 2) or tuple(z.shape) != (n_sim, 5 + P):
            raise AssertionError(f"training set shapes {tuple(z.shape)}, {tuple(x.shape)}")
        walls.update(_sample_posterior("main", device, MODEL_FILE, prior, x_o, pulses_o, warmup, draws))
        walls["total"] = time.perf_counter() - t_all
        _log(f"[main] walls_s={json.dumps({k: round(v, 3) for k, v in walls.items()})}")
        return walls

    walls, launches = _launches_on("main", ("ddm_rt_choice", "mnle_logprob_fwd", "mnle_logprob_bwd"), run)
    return {"walls": walls, "launches": launches}


def phase_pulse(device, warmup: int = 50, draws: int = 200) -> dict:
    """The pulse-grid serving path: the same observed session, the
    committed pulse-grid model loaded and sampled by the same sampler
    (K2p/K3p at every gradient)."""

    def run():
        t_all = time.perf_counter()
        prior, x_o, pulses_o = _observed_session(device)
        walls = _sample_posterior("pulse", device, PULSE_MODEL_FILE, prior, x_o, pulses_o, warmup, draws)
        walls["total"] = time.perf_counter() - t_all
        _log(f"[pulse] walls_s={json.dumps({k: round(v, 3) for k, v in walls.items()})}")
        return walls

    walls, launches = _launches_on("pulse", ("mnle_pulse_fwd", "mnle_pulse_bwd"), run)
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
    _log(f"[device] torch={torch.__version__} cuda={torch.version.cuda} device={name} ({smi})")

    t_start = time.perf_counter()
    phase_build()
    k1 = phase_k1(device, N_SIM)
    k23 = phase_k2k3(device)
    k23p = phase_k2pk3p(device)
    main_path = phase_main(device)
    pulse_path = phase_pulse(device)
    _log(f"[time] whole script after start-up: {time.perf_counter() - t_start:.1f} s")

    src = f"{PKG}/csrc"
    jax_ops = "sbi_for_diffusion_models_tpu/ops"
    fused = {**k23[ROWS_MAIN], **k23p[ROWS_MAIN]}
    kernels = [{
        "name": "ddm_rt_choice", "route": "cuda", "source": f"{src}/ddm_rt_choice.cu",
        "replaces": f"{jax_ops}/ddm_pallas.py:60", "launches": main_path["launches"]["ddm_rt_choice"],
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": None,
    }]
    for kname, label, f, rep, path in (
        ("mnle_logprob_fwd", "K2", "mnle_logprob.cu", "mnle_pallas.py:269", main_path),
        ("mnle_logprob_bwd", "K3", "mnle_logprob.cu", "mnle_pallas.py:275", main_path),
        ("mnle_pulse_fwd", "K2p", "mnle_pulse.cu", "mnle_pallas.py:333", pulse_path),
        ("mnle_pulse_bwd", "K3p", "mnle_pulse.cu", "mnle_pallas.py:361", pulse_path),
    ):
        ms, plain_ms, bound_ms, bound_by = fused[label]["times"]
        kernels.append({
            "name": kname, "route": "cuda", "source": f"{src}/{f}", "replaces": f"{jax_ops}/{rep}",
            "launches": path["launches"][kname], "max_abs_err": fused[label]["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
