#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

Builds the port's CUDA kernels from ``sbi_for_diffusion_models_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, then drives the
port's paths once each through their public entry points:

1. build K1 (pulse-DDM simulator), K2/K3 (fused MNLE log-prob forward and
   backward), K2p/K3p (the same for the pulse-grid RT representation) and
   K4 (the issue-ceiling microkernel) with nvcc for sm_90a, one nvcc per
   source, side by side;
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
5. K4, both kinds, at chains of 64 and 1,024 steps against its plain version
   in float64 (``phase_k4``), then the roofline path: the entry point
   ``roofline.main`` times K4 at its full shape (2,097,152 elements, chains
   of 2^14 and 2^17) and gives the card's two achievable issue ceilings,
   which must not exceed 105 % of the datasheet's FMA rate, then K1's and
   K2's demand against them. K4, K1 and K2 must have launched. Then each
   is held at the shape that path gave it: K4 at 2,097,152 elements and both
   chain lengths against float64 and its plain version, K1 at 524,288 trials
   and K2/K3 at 65,536 rows on that path's model against theirs;
6. the flagship path: simulate 131,072 training pairs, an observed 50-trial
   session, load the flagship model and sample its posterior with the
   calibrated sampler (PT6 NUTS, grid hop, t_nd slice; warmup and draws cut
   to 50 and 100). K1, K2 and K3 must have launched during this phase;
7. the pulse path: the same observed session, the pulse-grid model loaded
   and sampled by the same sampler at the same cut. K2p and K3p must have
   launched during this phase;
8. the training path, at the flagship's full width on the pairs of phase 6:
   ``train_mnle`` under ``CALIBRATED_CONFIG`` with the cond-affine head
   (only the epochs are cut, to TRAIN_EPOCHS), ``save_model`` into a
   temporary directory, ``load_model`` back (weights bit-equal, the same
   fingerprint), and ``run_inference_mcmc`` with the loaded model on the
   observed session (warmup 20 / draws 20). The validation loss must be
   finite at every epoch and end at least TRAIN_MIN_DROP below the first
   epoch's; K2 and K3 must have launched. Then K2/K3 on the trained model
   against their plain version at 1,200 and 115,200 rows, held as in
   phase 3, and one more epoch under ``torch.profiler`` for the card's busy
   share of an optimizer step.

Each kernel's bound is the larger of its FP32 operations over 67 TFLOP/s
and its bytes (inputs read once, outputs written once) over 3.35 TB/s, the
H100 SXM's published rates, counted from this run's shapes (K1: from the
steps its trials executed; K4: its chained FMAs). No single PyTorch call
computes any of these kernels, so ``library_ms`` is null.

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
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "sbi_for_diffusion_models_tpu_torch"
MODEL_FILE = "mnle_10m_shifted_logt_affine.npz"
PULSE_MODEL_FILE = "mnle_1m_pulseabs.npz"
MODEL_DIR = ROOT / "artifacts" / "models"  # the committed models
FP32_OPS_PER_S = 67e12  # H100 SXM, FP32 outside the tensor cores (an FMA counts 2)
MAX_CEILING_SHARE = 1.05  # a measured ceiling above this share of the datasheet's FMA rate is a fault
HBM_BYTES_PER_S = 3.35e12

N_SIM = 131_072  # K1 check size and the main path's training-set size
ROWS_MAIN = 1_200  # 4 chains x 6 replicas x 50 trials
ROWS_SBC = 115_200  # 96 sessions of the above
P_MIN = 1e-3  # K1 distribution tests
TRAIN_EPOCHS = 10  # the training path's cut of TRAIN_MAX_EPOCHS (and of the patience)
TRAIN_MIN_DROP = 0.5  # nats the last validation loss must lie below the first epoch's
K4_SHAPE = (64, 256, 128)  # the roofline path's K4 input: 2,097,152 float32 elements


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
    (rt - t_nd) / dt. Per step ``csrc/ddm_rt_choice.cu`` does 43.5
    FMA-class operations (the update, compares and selects 13, a quarter of
    a Philox4x32-10 call 25, half a Box-Muller pair's plain operations 5.5)
    and 2 special functions, counted in ``roofline.py``; here all 45.5 go
    at the FP32 rate. Bytes: theta (5) and the stimulus's n_chunks columns
    in, (rt, choice) out, float32."""
    import torch

    tnd = theta[:, 4].clamp(0.0, t_max - 1e-6)
    steps = int(torch.round((out[:, 0] - tnd) / dt).clamp(min=0).sum())
    n = theta.shape[0]
    from sbi_for_diffusion_models_tpu_torch.roofline import K1_FMA_CLASS_OPS, K1_TRANSCENDENTAL_CLASS_OPS

    ms, by = _bound((K1_FMA_CLASS_OPS + K1_TRANSCENDENTAL_CLASS_OPS) * steps, 4 * n * (5 + n_chunks + 2))
    return ms, by, steps


def mnle_bound(w, n: int, backward: bool) -> tuple[float, str]:
    """K2/K3 (K2p/K3p) bound at n rows: 2 FLOP per multiply-add of the
    forward products (categorical MLP, trunk, slot head, head on [emb, kf])
    and, for the backward kernel, of its input-gradient products (the same
    matrices transposed; the first layers only to the D context columns; no
    weight gradients). The per-row softmaxes and splines are not counted.
    Bytes: the packed weights once, the row inputs, the cotangent and the
    outputs."""
    from sbi_for_diffusion_models_tpu_torch.roofline import mnle_layer_shapes

    D = w.cat[0][0].shape[0]
    H = w.trunk[-1][0].shape[1]
    HF = w.head_w.shape[0]
    layers = mnle_layer_shapes(w)
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
    from sbi_for_diffusion_models_tpu_torch.ops import _cuda, ceiling_cuda, ddm_cuda, mnle_cuda  # noqa: F401

    t0 = time.perf_counter()
    per_file = _cuda.build_all()
    _log(f"[build] {json.dumps(per_file)} total_s={time.perf_counter() - t0:.3f}")
    for lib in _cuda._LIBRARIES.values():  # registers, stack and spills of every kernel, as ptxas -v reports them
        entry = ""
        for line in lib.build_log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "bytes stack frame" in line or line.lstrip().startswith("ptxas info    : Used"):
                _log(f"[build] {lib.source.name} {entry}: {line.strip()}")
    return per_file


def _k1_against_plain(label: str, theta, s, n_max: int, spp: int) -> tuple:
    """K1 against its plain version on the trials (theta, s): equal outputs
    without noise, the same output for the same seed, and with noise the
    same distribution (chi-square on the choice counts, two-sample KS on RT
    per choice that both sides produced). Returns (kernel, plain,
    max_abs_err), the two as functions of (mu_sensory, seed, theta, s)."""
    import numpy as np
    import torch
    from scipy import stats

    from sbi_for_diffusion_models_tpu_torch.ops.ddm_cuda import ddm_rt_choice_cuda
    from sbi_for_diffusion_models_tpu_torch.ops.ddm_scan import ddm_rt_choice_scan

    n = theta.shape[0]
    kw = dict(steps_per_pulse=spp, n_max=n_max)

    def kernel(mu, sd, th=theta, st=s):
        return ddm_rt_choice_cuda(th, st, sd, mu_sensory=mu, **kw)

    def plain(mu, sd, th=theta, st=s):
        return ddm_rt_choice_scan(th, st, sd, mu_sensory=mu, chunk_steps=spp, **kw)

    a, b = kernel(0.0, 1), plain(0.0, 2)
    n_diff = int((a != b).any(1).sum())
    max_abs = float((a - b).abs().max())
    _log(f"[{label}] zero noise n={n}: rows differing={n_diff} max_abs_err={max_abs}")
    if n_diff:
        raise AssertionError(f"{label}: K1 differs from its plain version without noise on {n_diff} rows")

    a1, a2, b = kernel(1.0, 11), kernel(1.0, 11), plain(1.0, 12)
    if not torch.equal(a1, a2):
        raise AssertionError(f"{label}: K1 gives different outputs for the same seed")
    an, bn = a1.cpu().numpy(), b.cpu().numpy()
    counts = np.array([[np.sum(x[:, 1] == c) for c in range(3)] for x in (an, bn)])
    seen = counts.sum(0) > 0  # a choice neither side produced has no row in the table
    chi2_p = float(stats.chi2_contingency(counts[:, seen])[1]) if seen.sum() > 1 else 1.0
    ks_p = [float(stats.ks_2samp(an[an[:, 1] == c, 0], bn[bn[:, 1] == c, 0]).pvalue)
            for c in (0, 1) if counts[:, c].min() > 0]
    _log(f"[{label}] noise n={n}: choice counts kernel={counts[0].tolist()} plain={counts[1].tolist()} "
         f"chi2_p={chi2_p:.4g} ks_p(rt|choice)={[round(p, 4) for p in ks_p]} same_seed_equal=True")
    if min([chi2_p] + ks_p) <= P_MIN:
        raise AssertionError(f"{label}: K1 and its plain version differ in distribution (p <= {P_MIN})")
    return kernel, plain, max_abs


def phase_k1(device, n: int, seed: int = 7) -> dict:
    """K1 against its plain version at ``n`` prior draws, then its times."""
    from sbi_for_diffusion_models_tpu_torch.models.rt_choice_model import (
        generate_pulse_matrix,
        n_pulses_max_from_schedule,
        pulse_schedule,
    )
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

    n_max, spp = pulse_schedule()
    gen = make_generator(seed, device)
    theta = build_prior_theta().sample(gen, (n,))
    s = generate_pulse_matrix(gen, n, n_pulses_max_from_schedule(n_max, spp))
    kernel, plain, max_abs = _k1_against_plain("K1", theta, s, n_max, spp)

    # Times at the main path's batch (TRAIN_BATCH_SIZE = 4,096) and at n,
    # with the bound from the steps the timed call's trials executed.
    times = {}
    for m in (4096, n):
        k_ms = _time_ms(lambda: kernel(1.0, 3, theta[:m], s[:m]), 5, device)
        p_ms = _time_ms(lambda: plain(1.0, 4, theta[:m], s[:m]), 1, device)
        b_ms, b_by, steps = k1_bound(theta[:m], kernel(1.0, 3, theta[:m], s[:m]), n_max // spp)
        times[m] = (k_ms, p_ms, b_ms, b_by, steps)
        _log(f"[K1] time n={m}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={b_ms:.4g} ({b_by}) "
             f"executed_trial_steps={steps} ({steps / (m * n_max):.4f} of nominal) "
             f"executed_trial_steps_per_s(kernel)={steps / (k_ms * 1e-3):.4g}")
    return {"max_abs_err": max_abs, "ms": times[4096][0], "plain_ms": times[4096][1],
            "bound_ms": times[4096][2], "bound_by": times[4096][3], "steps": times[4096][4], "times": times}


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


def _phase_fused(device, model_file, fwd, bwd, sizes, model_dir=MODEL_DIR) -> dict:
    """A fused forward/backward pair against its plain versions on the
    model ``model_dir/model_file`` (default: the committed models), at each
    row count of ``sizes``. ``fwd``/``bwd`` are (label, kernel wrapper,
    plain version)."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.mnle import load_model
    from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda as mc
    from sbi_for_diffusion_models_tpu_torch.ops.rowcheck import reference
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta

    os.environ["MODEL_DIR"] = str(model_dir)
    est = load_model(model_file, device=device)
    w32 = mc.pack_mnle_weights(est)
    w64 = w32.astype(torch.float64)
    prior = build_prior_theta()
    (f_label, f_kernel, f_plain), (b_label, b_kernel, b_plain) = fwd, bwd
    grad_names = ("dphi", "dctx", "dkf") if w32.pulse else ("dt", "dctx")
    out = {}
    for n in sizes:
        rows = tuple(a[:n].contiguous() for a in _session_rows(est, prior, device, -(-n // ROWS_MAIN)))
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


def phase_k2k3(device, sizes=(ROWS_MAIN, ROWS_SBC), model_file=MODEL_FILE, model_dir=MODEL_DIR) -> dict:
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

    return _phase_fused(device, model_file, ("K2", mc.rows_logp, mc.rows_logp_plain),
                        ("K3", mc.rows_logp_vjp, mc.rows_logp_vjp_plain), sizes, model_dir)


def phase_k2pk3p(device, sizes=(ROWS_MAIN, ROWS_SBC)) -> dict:
    """K2p/K3p against their plain version on the pulse-grid model, held as
    K2/K3 are (``phase_k2k3``) over the value and dphi, dctx and dkf."""
    from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda as mc

    return _phase_fused(device, PULSE_MODEL_FILE,
                        ("K2p", mc.rows_logp_pulse, mc.rows_logp_pulse_plain),
                        ("K3p", mc.rows_logp_pulse_vjp, mc.rows_logp_pulse_vjp_plain), sizes)


def _sample_posterior(label, device, model_file, prior, x_o, pulses_o, warmup: int, draws: int,
                      model_dir=MODEL_DIR) -> dict:
    """Load ``model_dir/model_file`` and sample the posterior of the session
    (x_o, pulses_o) with the calibrated sampler (warmup and draws cut),
    through the public entry points; checks the draws and prints the
    sampler's numbers."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.inference.diagnostics import effective_sample_size, split_r_hat
    from sbi_for_diffusion_models_tpu_torch.mnle import load_model, run_inference_mcmc
    from sbi_for_diffusion_models_tpu_torch.run_config import CALIBRATED_CONFIG

    walls = {}
    t0 = time.perf_counter()
    os.environ["MODEL_DIR"] = str(model_dir)
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


def phase_main(device, n_sim: int = N_SIM, warmup: int = 50, draws: int = 100) -> dict:
    """The flagship serving path through its public entry points: simulate
    a training set and the observed session (K1), load the flagship model
    and sample its posterior (K2/K3 at every gradient). The simulated pairs
    are returned for the training path."""
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
        return walls, proposal, z, x

    (walls, proposal, z, x), launches = _launches_on(
        "main", ("ddm_rt_choice", "mnle_logprob_fwd", "mnle_logprob_bwd"), run)
    return {"walls": walls, "launches": launches, "proposal": proposal, "z": z, "x": x}


def phase_pulse(device, warmup: int = 50, draws: int = 100) -> dict:
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


def phase_k4(device) -> dict:
    """K4, both kinds, against its plain version in float64 at chains of 64
    and 1,024 steps on 32,768 values in [0.25, 1).

    fma: the kernel rounds once a step (an FMA), so it is held within
    ``fma_tolerance`` at one rounding a step, K x 2^-24 x the value, which
    every value's own movement over the chain exceeds (a chain not run
    fails); the plain float32 version rounds twice and is printed beside.
    It is also held within FUSED_ULPS ulps (of 2^-24: the values lie below
    1) of the plain chain rounded once a step (``fused=True``), from which a
    chain one turn short or long is about 21 ulps away.
    transcendental: the chain contracts towards a fixed point, so only the
    last turn's exp, log, sqrt and sin count: 8 float32 ulps (8 x 2^-23)."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.ops.ceiling_cuda import (
        FUSED_ULPS,
        KINDS,
        ceiling_chain,
        ceiling_plain,
        fma_tolerance,
    )

    gen = torch.Generator(device).manual_seed(13)
    x = torch.rand((4, 64, 128), generator=gen, device=device) * 0.75 + 0.25
    max_abs = 0.0
    for kind in KINDS:
        for K in (64, 1024):
            got = ceiling_chain(x, K, kind)
            torch.cuda.synchronize()
            exact = ceiling_plain(x.double(), K, kind)
            plain = ceiling_plain(x, K, kind)
            if kind == "fma":
                tol = fma_tolerance(K, exact.abs())
                if not bool(((exact - x).abs() > tol).all()):
                    raise AssertionError(f"K4 fma K={K}: the tolerance exceeds the chain's own movement")
            else:
                tol = torch.full_like(exact, 8 * 2.0**-23)
            err = (got.double() - exact).abs()
            plain_err = (plain.double() - exact).abs()
            vs_plain = float((got - plain).abs().max())
            max_abs = max(max_abs, vs_plain)
            _log(f"[K4] {kind} K={K} n={x.numel()}: max |kernel - float64|={float(err.max()):.3e} "
                 f"(tolerance {float(tol.min()):.3e} to {float(tol.max()):.3e}, worst err/tolerance "
                 f"{float((err / tol).max()):.3f}); plain_f32 vs float64={float(plain_err.max()):.3e}; "
                 f"kernel vs plain_f32={vs_plain:.3e}")
            if not bool((err <= tol).all()) or not bool(got.isfinite().all()):
                raise AssertionError(f"K4 {kind} at K={K} differs from its float64 evaluation by "
                                     f"{float((err / tol).max()):.3f} x its tolerance")
            if kind == "fma":
                ulps = float(((got - ceiling_plain(x, K, kind, fused=True)).abs() / 2.0**-24).max())
                _log(f"[K4] fma K={K}: kernel vs the plain chain rounded once a step: {ulps:.1f} ulps of 2^-24 "
                     f"(limit {FUSED_ULPS})")
                if not ulps <= FUSED_ULPS:
                    raise AssertionError(f"K4 fma at K={K} is {ulps:.1f} ulps from the chain rounded once a step")
    return {"max_abs_err": max_abs}


def _k4_at_the_roofline_shape(device, report: dict) -> dict:
    """K4 at the shape and chain lengths the roofline path launches it with:
    (64, 256, 128) elements of 0.5, both kinds, chains of K_lo and K_hi.
    Every element runs the same chain, so the float64 evaluation of one
    element is the reference of all: the fma kind is held within
    ``fma_tolerance`` at one rounding a step, which the chain's own movement
    must exceed, and within FUSED_ULPS ulps of the plain chain rounded once a
    step (a single turn short or long fails); the transcendental kind, whose
    chain settles on a fixed point, within 8 float32 ulps. The plain float32 version runs once at the full shape for
    each kind (fma at K_hi, where it is timed; transcendental at K_lo) and
    the kernel is held to it within both sides' roundings."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.ops.ceiling_cuda import (
        FUSED_ULPS,
        KINDS,
        ceiling_chain,
        ceiling_plain,
        fma_tolerance,
    )

    x = torch.full(K4_SHAPE, 0.5, dtype=torch.float32, device=device)
    one = torch.full((1,), 0.5, dtype=torch.float64)
    max_abs, plain_ms = 0.0, None
    for kind in KINDS:
        r = report[f"issue_{kind}"]
        if r["elements"] != x.numel():
            raise AssertionError(f"roofline: K4 ran on {r['elements']} elements, the check on {x.numel()}")
        K_plain = r["K_hi"] if kind == "fma" else r["K_lo"]
        for K in (r["K_lo"], r["K_hi"]):
            got = ceiling_chain(x, K, kind)
            exact = float(ceiling_plain(one, K, kind))
            ulps = 8 * 2.0**-23
            tol = fma_tolerance(K, abs(exact)) if kind == "fma" else ulps
            if kind == "fma" and not abs(exact - 0.5) > tol:
                raise AssertionError(f"K4 fma K={K}: the tolerance exceeds the chain's own movement")
            err = float((got.double() - exact).abs().max())
            line = (f"[K4] {kind} K={K} n={x.numel()}: float64={exact:.9g} max |kernel - float64|={err:.3e} "
                    f"(tolerance {tol:.3e}, err/tolerance {err / tol:.3f})")
            ok = bool(got.isfinite().all()) and err <= tol
            if kind == "fma":
                fused = float(ceiling_plain(one.float(), K, kind, fused=True))
                ulps = float((got.double() - fused).abs().max()) / 2.0**-24
                line += f"; vs the plain chain rounded once a step: {ulps:.1f} ulps of 2^-24 (limit {FUSED_ULPS})"
                ok = ok and ulps <= FUSED_ULPS
            if K == K_plain:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                plain = ceiling_plain(x, K, kind)
                end.record()
                torch.cuda.synchronize()
                vs_plain = float((got - plain).abs().max())
                # The kernel rounds once a step and the plain version twice: three roundings between them.
                plain_tol = fma_tolerance(K, abs(exact), roundings=3) if kind == "fma" else 2 * ulps
                max_abs = max(max_abs, vs_plain)
                ok = ok and vs_plain <= plain_tol
                line += (f"; plain_f32 vs float64={float((plain.double() - exact).abs().max()):.3e}; "
                         f"kernel vs plain_f32={vs_plain:.3e} (tolerance {plain_tol:.3e})")
                if kind == "fma":
                    plain_ms = start.elapsed_time(end)
            _log(line)
            if not ok:
                raise AssertionError(f"K4 {kind} at K={K} and {x.numel()} elements differs from its float64 "
                                     f"evaluation or its plain version: {line}")
    return {"max_abs_err": max_abs, "plain_ms": plain_ms}


def phase_roofline(device) -> dict:
    """The roofline path through its entry point (``roofline.main``): K4 at
    its full shape and both chain lengths, the two ceilings, then K1 at
    524,288 trials and K2 at 65,536 rows against them. A ceiling above
    MAX_CEILING_SHARE of the datasheet's FMA rate means the chain was folded
    or the timing is wrong. After the counts are read, each kernel of the
    path is held against its plain version at the shape the path gave it:
    K4 (``_k4_at_the_roofline_shape``), K1 on the path's trials, and K2/K3
    at the path's row count on the path's model."""
    from sbi_for_diffusion_models_tpu_torch import roofline
    from sbi_for_diffusion_models_tpu_torch.ops.ceiling_cuda import KINDS

    os.environ["MODEL_DIR"] = str(MODEL_DIR)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "roofline_h100.json"
        report, launches = _launches_on("roofline", ("issue_ceiling", "ddm_rt_choice", "mnle_logprob_fwd"),
                                        lambda: roofline.main(["--out", str(out)]))
        if json.loads(out.read_text()) != report:
            raise AssertionError("roofline: the written report differs from the returned one")
    for kind in KINDS:
        r = report[f"issue_{kind}"]
        if not (0.0 < r["share_of_datasheet_fma"] <= MAX_CEILING_SHARE):
            raise AssertionError(f"roofline: the {kind} ceiling is {r['share_of_datasheet_fma']:.3f} of the "
                                 f"datasheet's FMA rate (limit {MAX_CEILING_SHARE})")
    k4 = _k4_at_the_roofline_shape(device, report)
    _k1_against_plain("K1 roofline", *roofline.simulator_inputs(report["sim_batch"], device))
    phase_k2k3(device, sizes=(report["mnle_rows"],), model_file=report["mnle_model"])
    fma = report["issue_fma"]
    bound_ms, bound_by = _bound(2.0 * fma["elements"] * fma["K_hi"], 8 * fma["elements"])
    _log(f"[K4] time fma K={fma['K_hi']} n={fma['elements']}: kernel_ms={fma['seconds_hi'] * 1e3:.4f} "
         f"plain_ms={k4['plain_ms']:.4f} bound_ms={bound_ms:.4g} ({bound_by}, "
         f"{bound_ms / (fma['seconds_hi'] * 1e3):.3f} of it)")
    return {"report": report, "launches": launches, "ms": fma["seconds_hi"] * 1e3, "plain_ms": k4["plain_ms"],
            "max_abs_err": k4["max_abs_err"], "bound_ms": bound_ms, "bound_by": bound_by}


def _train_epoch_device_time(cfg, proposal, z, x, step_ms: float) -> None:
    """One epoch of ``train_mnle`` (its optimizer steps and one validation
    pass) under ``torch.profiler``: the card's time and launches per
    optimizer step, and the card's busy share of ``step_ms``, the ms per
    step of the run that was not profiled. Prints; checks nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import sbi_for_diffusion_models_tpu_torch as port

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        meta = port.train_mnle(cfg.replace(TRAIN_MAX_EPOCHS=1), proposal, z, x, seed=0, verbose=False).train_meta
        torch.cuda.synchronize()
    events = [(e.count, getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))
              for e in prof.key_averages()]
    steps = meta["steps_per_epoch"]
    device_ms = sum(us for _, us in events) / 1e3 / steps
    _log(f"[train] one epoch under torch.profiler ({steps} steps and a validation pass): "
         f"device_ms_per_step={device_ms:.3f} device_launches_per_step={sum(c for c, us in events if us > 0) / steps:.0f} "
         f"ms_per_step(profiled)={meta['step_ms']:.3f}; device busy share of the unprofiled step "
         f"({step_ms:.3f} ms) = {device_ms / step_ms:.3f}")


def phase_train(device, proposal, z, x, warmup: int = 20, draws: int = 20) -> dict:
    """The training path at the flagship's full width: ``train_mnle`` on the
    simulated pairs, ``save_model``, ``load_model``, ``run_inference_mcmc``
    with the loaded model, through the public entry points; then K2/K3 on
    the trained model against their plain version at 1,200 rows (one
    leapfrog; 0.1 % of them is a single row) and at 115,200."""
    import numpy as np
    import torch

    import sbi_for_diffusion_models_tpu_torch as port
    from sbi_for_diffusion_models_tpu_torch.run_config import CALIBRATED_CONFIG

    cfg = CALIBRATED_CONFIG.replace(MNLE_COND_AFFINE=True, TRAIN_MAX_EPOCHS=TRAIN_EPOCHS,
                                    TRAIN_STOP_AFTER_EPOCHS=TRAIN_EPOCHS)
    model_file = "mnle_chip_smoke.npz"

    with tempfile.TemporaryDirectory() as model_dir:
        def run():
            walls = {}
            t_all = time.perf_counter()
            t0 = time.perf_counter()
            est = port.train_mnle(cfg, proposal, z, x, seed=0)
            torch.cuda.synchronize()
            walls["train"] = time.perf_counter() - t0
            meta = est.train_meta
            mc_ = est.cfg
            width = (mc_.rt_rep, mc_.censor_rt, mc_.cond_affine, mc_.log_condition_dims, mc_.hidden_features,
                     mc_.num_transforms, mc_.num_bins, mc_.condition_dim)
            if width != ("shifted_log", True, True, (1, 2, 3), 128, 10, 24, 85):
                raise AssertionError(f"train: not the flagship's width: {width}")
            steps = meta["epochs_run"] * meta["steps_per_epoch"]
            _log(f"[train] n={meta['num_train']} epochs={meta['epochs_run']} steps_per_epoch={meta['steps_per_epoch']} "
                 f"ms_per_optimizer_step={meta['step_ms']:.3f} ({steps} steps) train_wall_s={walls['train']:.3f}")
            _log(f"[train] train_losses={[round(v, 4) for v in meta['train_losses']]}")
            _log(f"[train] val_losses={[round(v, 4) for v in meta['val_losses']]} best={meta['best_val_loss']:.4f}")
            vl = meta["val_losses"]
            if meta["epochs_run"] != TRAIN_EPOCHS or not bool(np.isfinite(vl).all()):
                raise AssertionError(f"train: {meta['epochs_run']} epochs, validation losses {vl}")
            if not vl[-1] < vl[0] - TRAIN_MIN_DROP:
                raise AssertionError(f"train: the validation loss went from {vl[0]:.4f} to {vl[-1]:.4f}, "
                                     f"less than the {TRAIN_MIN_DROP} it must fall")

            os.environ["MODEL_DIR"] = model_dir
            t0 = time.perf_counter()
            path = port.save_model(est, cfg, model_file)
            loaded = port.load_model(model_file, device=device)
            walls["save_load"] = time.perf_counter() - t0
            if not all(torch.equal(a, b) for a, b in zip(est.net.parameters(), loaded.net.parameters())):
                raise AssertionError("train: the loaded weights differ from the saved ones")
            if any(p.requires_grad for p in loaded.net.parameters()):
                raise AssertionError("train: the loaded weights require gradients")
            with np.load(path) as data:
                fingerprint = json.loads(str(data["__meta__"]))["param_fingerprint"]
            port.save_model(loaded, cfg, "again.npz")
            with np.load(Path(model_dir) / "again.npz") as data:
                again = json.loads(str(data["__meta__"]))["param_fingerprint"]
            if fingerprint != again:
                raise AssertionError(f"train: fingerprint {fingerprint} became {again} after a reload")
            _log(f"[train] saved {path.name} ({path.stat().st_size} bytes) fingerprint={fingerprint}; reloaded bit-equal")

            prior, x_o, pulses_o = _observed_session(device)
            walls.update(_sample_posterior("train", device, model_file, prior, x_o, pulses_o, warmup, draws,
                                           model_dir=model_dir))
            walls["total"] = time.perf_counter() - t_all
            _log(f"[train] walls_s={json.dumps({k: round(v, 3) for k, v in walls.items()})}")
            return walls, meta

        (walls, meta), launches = _launches_on("train", ("mnle_logprob_fwd", "mnle_logprob_bwd"), run)
        # After the counts are read: comparison launches do not count.
        check = phase_k2k3(device, model_file=model_file, model_dir=model_dir)
    _train_epoch_device_time(cfg, proposal, z, x, meta["step_ms"])
    return {"walls": walls, "launches": launches, "train_meta": meta, "check": check}


def measured_bounds(kernels: list, k1_steps: int, report: dict) -> None:
    """Add ``measured_bound_ms`` to every kernel of the line: its operations
    over the issue rates K4 measured in this run (``roofline.main``'s
    report) instead of the datasheet's. The fused kernels' FLOP are FMAs, two
    each, at the fma ceiling; K1's executed steps take their FMA-class
    operations at the fma ceiling and their special functions at the
    transcendental-mix ceiling, as ``roofline.py`` states its demand."""
    from sbi_for_diffusion_models_tpu_torch.roofline import K1_FMA_CLASS_OPS, K1_TRANSCENDENTAL_CLASS_OPS

    fma, tra = report["issue_fma"]["ops_per_s"], report["issue_transcendental"]["ops_per_s"]
    for k in kernels:
        if k["name"] == "ddm_rt_choice":
            k["measured_bound_ms"] = k1_steps * (K1_FMA_CLASS_OPS / fma + K1_TRANSCENDENTAL_CLASS_OPS / tra) * 1e3
        elif k["bound_by"] == "operations":
            k["measured_bound_ms"] = k["bound_ms"] * (FP32_OPS_PER_S / 2.0) / fma
        else:  # bytes: no issue rate enters
            k["measured_bound_ms"] = k["bound_ms"]
        _log(f"[ceilings] {k['name']}: kernel_ms={k['ms']:.4f} datasheet_bound_ms={k['bound_ms']:.4g} "
             f"({k['bound_ms'] / k['ms']:.4f} of the kernel's time) measured_bound_ms={k['measured_bound_ms']:.4g} "
             f"({k['measured_bound_ms'] / k['ms']:.4f})")


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
    k4 = phase_k4(device)
    roof = phase_roofline(device)
    main_path = phase_main(device)
    pulse_path = phase_pulse(device)
    phase_train(device, main_path["proposal"], main_path["z"], main_path["x"])
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
    kernels.append({
        "name": "issue_ceiling", "route": "cuda", "source": f"{src}/issue_ceiling.cu",
        "replaces": "benchmarks/roofline.py:105", "launches": roof["launches"]["issue_ceiling"],
        "max_abs_err": max(k4["max_abs_err"], roof["max_abs_err"]), "ms": roof["ms"], "plain_ms": roof["plain_ms"],
        "bound_ms": roof["bound_ms"], "bound_by": roof["bound_by"], "library_ms": None,
        "kinds": {kind: roof["report"][f"issue_{kind}"] for kind in ("fma", "transcendental")},
    })
    measured_bounds(kernels, k1["steps"], roof["report"])
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
