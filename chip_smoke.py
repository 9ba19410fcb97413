#!/usr/bin/env python3
"""Time the port's CUDA kernels on one GPU: the numbers of PERF.md §6's kernel table.

For each kernel, its time, its plain PyTorch version's time on the same
inputs, its bound and what bounds it, and what ptxas said of its build
(registers, stack, spills):

- K1 (``ddm_rt_choice``) at the main path's 4,096 prior draws and at
  131,072 (seed 7), after a warm-up of the card, with the launch shape it
  ran at and the trial-steps its trials executed; its per-trial noise-scale
  instances at 4,096 trials on a 1,600-step window, in turns against the
  scalar launch on the same work;
- K2/K3 (``mnle_logprob_fwd``/``_bwd``) on the committed flagship
  (``mnle_10m_shifted_logt_affine.npz``) at 1,200 rows (4 chains x 6 rungs x
  50 trials), 9,600 (the SBC fold's launch) and 115,200 (96 sessions), on the
  tail-sharp model at 1,200 and 9,600 and on ``mnle_1m_censor.npz`` at the
  hierarchical coverage fold's 7,680; K2p/K3p (``mnle_pulse_fwd``/``_bwd``)
  on ``mnle_1m_pulseabs.npz`` at 1,200 and 115,200. Rows as the posterior
  potential builds them (``tests/card_common.session_rows``);
- K4 (``issue_ceiling``) through the roofline entry point (``roofline.main``:
  2,097,152 elements, chains of 2^14 and 2^17, the card's two issue
  ceilings), its plain chain at 2^17;
- the NUTS leaf kernel (``nuts_leaf``) at 24 chains (D = 5), 2,304 (the SBC
  fold's) and 24 at D = 330 (the hierarchical sampler at 64 subjects): device
  time a launch (``torch.profiler``) and host time a leaf over LEAF_TIMED
  leaves on which every chain stays live, against the plain leaf's;
- the u-space density's pair (``density_pre``, ``density_post``) at 24 and
  2,304 chains: device time, host time and device operations a call over
  DENSITY_TIMED calls around a potential that launches nothing, against the
  plain composition's.

A bound is the larger of the kernel's FP32 operations over 67 TFLOP/s and
its bytes over 3.35 TB/s (the H100 SXM's datasheet): K2/K3/K2p/K3p from
``port_bench/counts.py`` (the count the benchmark's ``k3_roofline`` reads),
K1 from the steps its trials executed at ``roofline.K1_*`` operations a
step, K4 from its chained FMAs. ``measured_bound_ms`` puts the same
operations at the issue rates K4 measured in this run. No single PyTorch
call computes any of these kernels, so ``library_ms`` is null.

Each timer also holds the kernel's outputs on its inputs against its plain
version's, so that a wrong kernel is not timed: K1 without noise bit for
bit against the plain scan, and its per-trial instances at sigma_i = 1
against the scalar launch; K2/K3 and K2p/K3p against float64 row by row
(``tests/card_common.hold_rows``); K4 against the plain chain within both
sides' roundings; the leaf state after the timed leaves and the density
pair's value and gradient bit for bit against the plain leaf's and
composition's. It asserts that each timed kernel launched, and that the
profiler saw nearly every timed leaf and density call. Then the flagship
serving path runs once (``run_inference_mcmc`` on the observed session at
the serving cells' warmup 10 and 40 draws), every kernel's launch count
zeroed just before it; the ``kernels`` line gives each kernel's launches
there (``main_path_launches``). The card tests hold the kernels and paths
in full (``python -m pytest -m requires_cuda tests/test_torch_cuda*.py``).

Run from the root of a checkout on one CUDA card with ``nvcc``:
``python3 chip_smoke.py``. The line before the last is ``{"kernels":
[...]}``, the last ``{"ok": true, "device": {...}}``; without a CUDA card it
exits with status 2.
"""

from __future__ import annotations

import json
import os
import re
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
HBM_BYTES_PER_S = 3.35e12

N_SIM = 131_072  # K1's large size and the main path's training-set size
ROWS_MAIN = 1_200  # 4 chains x 6 rungs x 50 trials
ROWS_FOLD = 9_600  # one launch of the SBC fold: 8 datasets x the above
ROWS_SBC = 115_200  # 96 sessions: all of the calibrated preset's SBC datasets in one launch
ROWS_HIER = 7_680  # the hierarchical coverage fold: 4 datasets x 4 chains x 6 rungs x 4 subjects x 20 trials
# The fused pairs' timings: (forward label, backward label, model file, row counts).
FUSED = (("K2", "K3", MODEL_FILE, (ROWS_MAIN, ROWS_FOLD, ROWS_SBC)),
         ("K2p", "K3p", PULSE_MODEL_FILE, (ROWS_MAIN, ROWS_SBC)),
         ("K2", "K3", "mnle_10m_shifted_logt_sharp.npz", (ROWS_MAIN, ROWS_FOLD)),
         ("K2", "K3", "mnle_1m_censor.npz", (ROWS_HIER,)))
# The leaf kernel: the serving cells' chains (4 x 6 rungs) and the SBC fold's (96 datasets of them), D = 5, then
# the serving chains at the hierarchical sampler's D = 330.
LEAF_SHAPES = ((24, 5), (2_304, 5), (24, 330))
LEAF_DEPTH = 10  # CALIBRATED_CONFIG's MCMC_MAX_TREE_DEPTH: the timed leaves cycle through one such subtree
LEAF_TIMED = 1_024  # leaves timed a side
DENSITY_CHAINS = (24, 2_304)  # the serving cells' chains, the SBC fold's
DENSITY_TIMED = 512  # calls timed a side
MISSED = 4  # timed leaves or density calls the profiler may miss at the ends of its window
SERVE_WARMUP, SERVE_DRAWS = 10, 40  # the serving cells' sampler run (port_bench/traffic/serve.json)
WARM_S = 2.0  # host seconds of K1 launches before the first timing: a cold card reads high


def _log(*args) -> None:
    print(*args, flush=True)


def _time_ms(fn, reps: int) -> float:
    """Mean milliseconds a call of ``fn`` after one warm-up call: CUDA
    events around ``reps`` calls."""
    import torch

    fn()
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


def _launched(kernel, since: int, label: str) -> None:
    """Fail unless ``kernel`` launched after its count read ``since``."""
    if kernel.launches <= since:
        raise AssertionError(f"{label}: {kernel.name} did not launch while it was timed")


def build() -> dict:
    """Build every kernel (one nvcc per source, side by side); returns
    ``card_common.ptxas_report()``."""
    import card_common
    from sbi_for_diffusion_models_tpu_torch.ops import (  # noqa: F401 (every kernel's library)
        _cuda, ceiling_cuda, ddm_cuda, density_cuda, mnle_cuda, nuts_cuda)

    t0 = time.perf_counter()
    per_file = _cuda.build_all()
    _log(f"[build] {json.dumps(per_file)} total_s={time.perf_counter() - t0:.3f}")
    report = card_common.ptxas_report()
    for entry, v in sorted(report.items()):
        _log(f"[build] {entry}: {json.dumps(v)}")
    return report


def k1_bound(theta, out, n_chunks: int, dt: float = 5e-4, t_max: float = 8.0) -> tuple[float, str, int]:
    """K1's bound from the steps its trials executed: a trial runs to its
    hit step, or to the end of its window if it timed out, and both equal
    (rt - t_nd) / dt. Per step ``csrc/ddm_rt_choice.cu`` does
    ``roofline.K1_FMA_CLASS_OPS`` FMA-class operations and
    ``K1_TRANSCENDENTAL_CLASS_OPS`` special functions, all at the FP32 rate
    here. Bytes: theta (5) and the stimulus's n_chunks columns in, (rt,
    choice) out, float32."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.roofline import K1_FMA_CLASS_OPS, K1_TRANSCENDENTAL_CLASS_OPS

    tnd = theta[:, 4].clamp(0.0, t_max - 1e-6)
    steps = int(torch.round((out[:, 0] - tnd) / dt).clamp(min=0).sum())
    n = theta.shape[0]
    ms, by = _bound((K1_FMA_CLASS_OPS + K1_TRANSCENDENTAL_CLASS_OPS) * steps, 4 * n * (5 + n_chunks + 2))
    return ms, by, steps


def time_k1(device, seed: int = 7) -> dict:
    """K1 and its plain scan at 4,096 and N_SIM prior draws, each at its own
    launch shape, after WARM_S of untimed launches at 4,096; at each size
    K1 without noise equals the plain scan bit for bit. Then the per-trial
    noise-scale instances at 4,096 trials on a 1,600-step window against the
    scalar launch on the same work (sigma_i = 1, the same bits), in turns."""
    import numpy as np
    import torch

    from sbi_for_diffusion_models_tpu_torch.models.rt_choice_model import (
        generate_pulse_matrix,
        n_pulses_max_from_schedule,
        pulse_schedule,
    )
    from sbi_for_diffusion_models_tpu_torch.ops.ddm_cuda import (
        K1,
        K1_LAST_LAUNCH,
        K1_THREADS,
        _card_capacity,
        ddm_rt_choice_cuda,
    )
    from sbi_for_diffusion_models_tpu_torch.ops.ddm_scan import ddm_rt_choice_scan
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

    n_max, spp = pulse_schedule()
    gen = make_generator(seed, device)
    theta = build_prior_theta().sample(gen, (N_SIM,))
    s = generate_pulse_matrix(gen, N_SIM, n_pulses_max_from_schedule(n_max, spp))
    sm, resident = _card_capacity(device, False)
    end = time.perf_counter() + WARM_S
    while time.perf_counter() < end:
        ddm_rt_choice_cuda(theta[:4096], s[:4096], 3, n_max=n_max, steps_per_pulse=spp)
        torch.cuda.synchronize()
    out = {}
    for m in (4096, N_SIM):
        th, st = theta[:m], s[:m]
        since = K1.launches
        k_ms = _time_ms(lambda: ddm_rt_choice_cuda(th, st, 3, n_max=n_max, steps_per_pulse=spp), 5)
        p_ms = _time_ms(lambda: ddm_rt_choice_scan(th, st, 4, n_max=n_max, steps_per_pulse=spp, chunk_steps=spp), 1)
        b_ms, b_by, steps = k1_bound(th, ddm_rt_choice_cuda(th, st, 3, n_max=n_max, steps_per_pulse=spp), n_max // spp)
        _launched(K1, since, f"K1 n={m}")
        if K1_LAST_LAUNCH["n"] != m:
            raise AssertionError(f"K1's last launch was not the timed one at n={m}: {K1_LAST_LAUNCH}")
        G, blocks = K1_LAST_LAUNCH["G"], K1_LAST_LAUNCH["blocks"]
        exact = (ddm_rt_choice_cuda(th, st, 1, mu_sensory=0.0, n_max=n_max, steps_per_pulse=spp)
                 != ddm_rt_choice_scan(th, st, 2, mu_sensory=0.0, n_max=n_max, steps_per_pulse=spp,
                                       chunk_steps=spp)).any(1)
        if bool(exact.any()):
            raise AssertionError(f"K1 n={m} without noise: {int(exact.sum())} rows differ from the plain scan")
        shape = {"G": G, "blocks": blocks, "resident_groups": blocks * K1_THREADS // G,
                 "resident_blocks_per_sm": resident[G], "sm_count": sm}
        out[m] = {"n": m, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "steps": steps,
                  "launch_shape": shape}
        _log(f"[K1] n={m} launch shape {json.dumps(shape)}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
             f"bound_ms={b_ms:.4g} ({b_by}) executed_trial_steps={steps} ({steps / (m * n_max):.4f} of nominal) "
             f"executed_trial_steps_per_s(kernel)={steps / (k_ms * 1e-3):.4g}; without noise the plain scan's bits")

    # The per-trial instances against the scalar one on the same work (sigma_i = 1: the same bits), in turns
    # (scalar, per-trial, per-trial, scalar, twice; the median of each side); then at sigma_i in [0.5, 1.5].
    n, n_max7, spp7 = 4096, 1_600, 200
    gen = make_generator(29, device)
    th = build_prior_theta().sample(gen, (n,))
    st = generate_pulse_matrix(gen, n, n_max7 // spp7)
    sigma = 0.5 + torch.rand((n,), generator=gen, device=device)
    ones = torch.ones((n,), device=device)

    def kernel(mu):
        return ddm_rt_choice_cuda(th, st, 3, mu_sensory=mu, steps_per_pulse=spp7, n_max=n_max7)

    order = "sppsspps"
    turns = [_time_ms(lambda: kernel(1.0 if side == "s" else ones), 50) for side in order]
    scalar_ms = float(np.median([t for t, side in zip(turns, order) if side == "s"]))
    k_ms = float(np.median([t for t, side in zip(turns, order) if side == "p"]))
    varied_ms = _time_ms(lambda: kernel(sigma), 50)
    p_ms = _time_ms(lambda: ddm_rt_choice_scan(th, st, 4, mu_sensory=ones, steps_per_pulse=spp7, n_max=n_max7,
                                               chunk_steps=spp7), 1)
    per_trial = kernel(ones)
    if not torch.equal(per_trial, kernel(1.0)):
        raise AssertionError("K1's per-trial instances at sigma_i = 1 differ from the scalar launch")
    b_ms, b_by, steps = k1_bound(th, per_trial, n_max7 // spp7)
    out["per_trial_sigma"] = {"n": n, "n_max": n_max7, "ms": k_ms, "scalar_ms": scalar_ms, "varied_sigma_ms": varied_ms,
                              "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "steps": steps}
    _log(f"[K1 per-trial sigma] n={n} window={n_max7} at sigma_i = 1 in turns ({order}: s scalar, p per-trial) "
         f"{[round(t, 4) for t in turns]}: medians kernel_ms={k_ms:.4f} scalar_ms={scalar_ms:.4f} plain_ms={p_ms:.4f} "
         f"bound_ms={b_ms:.4g} ({b_by}); at sigma_i in [0.5, 1.5]: kernel_ms={varied_ms:.4f}")
    return out


def time_fused(device) -> dict:
    """Each fused pair of FUSED on session rows of its model at each row
    count: the forward kernel against the plain forward, the backward kernel
    (which writes the value too) against the plain value and gradients;
    then the pair on those rows against float64 (``hold_rows``). Returns
    {(model file, label): [entries by row count]}."""
    import torch

    from card_common import hold_rows, session_rows
    from port_bench import counts
    from sbi_for_diffusion_models_tpu_torch.mnle import load_model
    from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda as mc
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta

    os.environ["MODEL_DIR"] = str(MODEL_DIR)
    prior = build_prior_theta()
    wrappers = {"K2": (mc.K2, mc.rows_logp, mc.rows_logp_plain),
                "K3": (mc.K3, mc.rows_logp_and_vjp, mc.rows_logp_vjp_plain),
                "K2p": (mc.K2P, mc.rows_logp_pulse, mc.rows_logp_pulse_plain),
                "K3p": (mc.K3P, mc.rows_logp_pulse_and_vjp, mc.rows_logp_pulse_vjp_plain)}
    out: dict = {}
    for f_label, b_label, model, sizes in FUSED:
        est = load_model(model, device=device)
        w = mc.pack_mnle_weights(est)
        shapes = counts.shapes(str(MODEL_DIR / model))
        all_rows = session_rows(est, prior, device, -(-max(sizes) // ROWS_MAIN))
        for n in sizes:
            rows = tuple(a[:n].contiguous() for a in all_rows)
            g = torch.randn(rows[0].shape, generator=torch.Generator(device).manual_seed(5), device=device)
            f_plain = wrappers[f_label][2]
            for label, backward in ((f_label, False), (b_label, True)):
                kern, wrapper, plain = wrappers[label]
                since = kern.launches
                reps = 20 if n <= ROWS_FOLD else 5
                if backward:
                    k_ms = _time_ms(lambda: wrapper(*rows, w, g), reps)
                    p_ms = _time_ms(lambda: (f_plain(*rows, w), plain(*rows, w, g)), reps)
                else:
                    k_ms = _time_ms(lambda: wrapper(*rows, w), reps)
                    p_ms = _time_ms(lambda: plain(*rows, w), reps)
                _launched(kern, since, f"{label} n={n}")
                seconds, by = counts.bound_seconds(n * counts.row_flops(shapes, backward),
                                                   counts.weight_bytes(shapes) + n * counts.row_bytes(shapes, backward))
                entry = {"n": n, "D": shapes.D, "ms": k_ms, "plain_ms": p_ms, "bound_ms": seconds * 1e3,
                         "bound_by": "operations" if by == "flops" else by}
                out.setdefault((model, label), []).append(entry)
                _log(f"[{label}] {model} n={n}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                     f"bound_ms={entry['bound_ms']:.4g} ({entry['bound_by']}, {entry['bound_ms'] / k_ms:.3f} of it) "
                     f"rows_per_s(kernel)={n / (k_ms * 1e-3):.4g}")
            _, checks = hold_rows(w, rows, g)
            _log(f"[{f_label}/{b_label}] {model} n={n}: against float64 row by row, share of rows over their "
                 f"allowance {[c.share for c in checks]}, the backward kernel's value the forward kernel's bits")
    return out


def time_k4(device) -> dict:
    """K4 through the roofline entry point (``roofline.main``: both kinds at
    (64, 256, 128) elements of 0.5, chains of K_lo and K_hi, the two issue
    ceilings, then K1's and K2's demand against them), and the plain fma
    chain at K_hi on the same elements, which the kernel's chain there
    meets within both sides' roundings (three a step: the kernel's FMA
    rounds once, the plain chain twice)."""
    import torch

    from sbi_for_diffusion_models_tpu_torch import roofline
    from sbi_for_diffusion_models_tpu_torch.ops.ceiling_cuda import K4, ceiling_chain, ceiling_plain, fma_tolerance

    os.environ["MODEL_DIR"] = str(MODEL_DIR)
    since = K4.launches
    with tempfile.TemporaryDirectory() as tmp:
        report = roofline.main(["--out", str(Path(tmp) / "roofline_h100.json")])
    _launched(K4, since, "K4")
    fma = report["issue_fma"]
    x = torch.full((64, 256, 128), 0.5, dtype=torch.float32, device=device)
    if x.numel() != fma["elements"]:
        raise AssertionError(f"the roofline path ran K4 on {fma['elements']} elements, the plain chain on {x.numel()}")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    plain = ceiling_plain(x, fma["K_hi"], "fma")
    end.record()
    torch.cuda.synchronize()
    err = float((ceiling_chain(x, fma["K_hi"], "fma") - plain).abs().max())
    exact = float(ceiling_plain(torch.full((1,), 0.5, dtype=torch.float64), fma["K_hi"], "fma"))
    if not err <= fma_tolerance(fma["K_hi"], abs(exact), roundings=3):
        raise AssertionError(f"K4 at K={fma['K_hi']}: {err} from the plain chain, past both sides' roundings")
    out = {"report": report, "ms": fma["seconds_hi"] * 1e3, "plain_ms": start.elapsed_time(end)}
    out["bound_ms"], out["bound_by"] = _bound(2.0 * fma["elements"] * fma["K_hi"], 8 * fma["elements"])
    out["short_chain"] = {"K": fma["K_lo"], "ms": fma["seconds_lo"] * 1e3,
                          **dict(zip(("bound_ms", "bound_by"),
                                     _bound(2.0 * fma["elements"] * fma["K_lo"], 8 * fma["elements"])))}
    _log(f"[K4] fma K={fma['K_hi']} n={fma['elements']}: kernel_ms={out['ms']:.4f} plain_ms={out['plain_ms']:.4f} "
         f"bound_ms={out['bound_ms']:.4g} ({out['bound_by']}, {out['bound_ms'] / out['ms']:.3f} of it)")
    return out


def leaf_bound(C: int, D: int, leaves) -> tuple[float, str]:
    """The leaf kernel's bound per launch, averaged over leaf indices
    ``leaves``, as ``csrc/nuts_leaf.cu`` does a leaf for each of C live
    chains. Operations: p_new's D FMAs (2 each), the kinetic energy's 3D,
    about 12 for the energy error, logaddexp and the take (each special
    function one), rho's D, the next half step's 2D FMAs, and at an odd
    leaf 8D for each checkpoint slot of its U-turn test. Bytes, float32
    unless said, each tensor read once and written once: read p_half,
    g_new, u_new, inv_mass, e_im, rho (D each), half_e, logp_new, H0,
    log_w, uni, sum_accept, the odd leaf's 2D a slot of checkpoints, the
    int64 count and three bools; write edge (3D + 1), prop (2D + 1), rho,
    p_half, u_next (D each), log_w, sum_accept, the even leaf's 2D of
    checkpoints, the count and the three bools."""
    from sbi_for_diffusion_models_tpu_torch.inference import nuts as tn

    ops = nbytes = 0.0
    for n in leaves:
        store, lo, hi = tn._leaf_slots(n)
        k = hi - lo + 1 if lo >= 0 else 0
        ops += C * (2 * D + 3 * D + 12 + D + 4 * D + 8 * D * k)
        read = 4 * (6 * D + 6 + 2 * D * k) + 8 + 3
        write = 4 * ((3 * D + 1) + (2 * D + 1) + 3 * D + 2 + (2 * D if store >= 0 else 0)) + 8 + 3
        nbytes += C * (read + write)
    return _bound(ops / len(leaves), nbytes / len(leaves))


def _device_ms(fn, mark: str, calls: int) -> tuple[float, float, int]:
    """``fn()``, which makes ``calls`` calls, under ``torch.profiler``, the
    window opened and closed by ``warm_window``: (device ms and device
    operations a call, calls seen), a call being each event whose name holds
    ``mark``. Fails unless the profiler saw all but at most MISSED calls."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.utils.metrics import device_intervals, warm_window

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        warm_window()  # the profiler can miss the events at the ends of its window; spins, not counted
        fn()
        warm_window()
    ev = [e for e in device_intervals(prof) if "spin" not in e[2]]
    seen = sum(1 for *_, name in ev if mark in name)
    if not calls - MISSED <= seen <= calls:
        raise AssertionError(f"the profiler saw {seen} of {calls} timed calls by {mark}, {len(ev)} events: "
                             f"{sorted({name[:80] for *_, name in ev})}")
    return sum(b - a for a, b, _ in ev) / 1e6 / seen, len(ev) / seen, seen


def _host_ms(fn, calls: int) -> float:
    """Host ms a call of ``fn()``'s ``calls`` calls, after a warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def time_leaf(device) -> dict:
    """The leaf kernel and the plain leaf at each of LEAF_SHAPES over
    LEAF_TIMED leaves from one start on a flat potential (logp 0, g 0: every
    chain moves in a straight line and stays live): device time a leaf (the
    kernel's launches; the plain leaf's half step, body and flag copy, as
    ``_build_subtree`` runs it) and host time a leaf; one launch a leaf,
    and after the timed leaves the kernel's state equals the plain leaf's
    bit for bit. Returns {(C, D): times}."""
    import numpy as np
    import torch

    from sbi_for_diffusion_models_tpu_torch.inference import nuts as tn
    from sbi_for_diffusion_models_tpu_torch.ops import nuts_cuda
    from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

    S = LEAF_DEPTH + 1
    timed = [n % (1 << LEAF_DEPTH) for n in range(LEAF_TIMED)]
    out = {}
    for C, D in LEAF_SHAPES:
        rng = np.random.default_rng(C)
        f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        u, p = f32(rng.normal(size=(C, D))), f32(rng.normal(size=(C, D)))
        inv_mass = f32(rng.uniform(0.5, 2.0, (C, D)))
        eps = f32(rng.uniform(0.02, 0.6, C))
        direction = torch.where(f32(rng.uniform(size=C)) < 0.5, 1.0, -1.0)
        half_e, e_im = (0.5 * eps * direction)[:, None], (eps * direction)[:, None] * inv_mass
        logp0, g0 = torch.zeros((C,), device=device), torch.zeros((C, D), device=device)
        H0 = tn._kinetic(p, inv_mass)
        edge = torch.cat([u, p, g0, logp0[:, None]], dim=1)
        s = dict(edge=edge, prop=torch.cat([edge[:, :D], edge[:, 2 * D:]], dim=1),
                 rho=torch.zeros((C, D), device=device), log_w=torch.full((C,), -float("inf"), device=device),
                 sum_accept=torch.zeros((C,), device=device),
                 n_leaves=torch.zeros((C,), dtype=torch.int64, device=device),
                 turning=torch.zeros((C,), dtype=torch.bool, device=device),
                 diverging=torch.zeros((C,), dtype=torch.bool, device=device),
                 live=torch.ones((C,), dtype=torch.bool, device=device),
                 r_ckpts=torch.zeros((C, S, D), device=device), rsum_ckpts=torch.zeros((C, S, D), device=device))
        uni = torch.rand((C,), generator=make_generator(1, device), device=device)
        plain = {k: v.clone() for k, v in s.items()}
        flag = torch.zeros((2,), dtype=torch.bool, pin_memory=True)
        kernel = nuts_cuda.LeafKernel(s, half_e, e_im, inv_mass, H0, flag)
        torch.addcmul(edge[:, D:2 * D], half_e, edge[:, 2 * D:3 * D], out=kernel.p_half)
        state = {"u": torch.addcmul(edge[:, :D], e_im, kernel.p_half), "plain": plain}

        def kernel_leaves():
            for n in timed:
                state["u"] = kernel.leaf(state["u"], logp0, g0, uni, tn._leaf_slots(n), n % 2)

        def plain_leaves():
            sp = state["plain"]
            for n in timed:
                e = sp["edge"]
                p_half = torch.addcmul(e[:, D:2 * D], half_e, e[:, 2 * D:3 * D])
                u_new = torch.addcmul(e[:, :D], e_im, p_half)
                sp = tn._leaf_plain(n, sp, u_new, p_half, logp0, g0, uni, half_e, inv_mass, H0)
                flag[n % 2].copy_(sp["live"].any(), non_blocking=True)
            state["plain"] = sp

        since = nuts_cuda.LEAF.launches
        r = {"D": D, "host_ms": _host_ms(kernel_leaves, LEAF_TIMED),
             "plain_host_ms": _host_ms(plain_leaves, LEAF_TIMED)}
        r["ms"], _, r["leaves_seen"] = _device_ms(kernel_leaves, "nuts_leaf_kernel", LEAF_TIMED)
        r["plain_ms"], r["plain_ops_per_leaf"], r["plain_leaves_seen"] = _device_ms(plain_leaves, "Memcpy",
                                                                                   LEAF_TIMED)
        if nuts_cuda.LEAF.launches - since != 3 * LEAF_TIMED:  # two host runs and the profiled one
            raise AssertionError(f"leaf C={C} D={D}: {nuts_cuda.LEAF.launches - since} launches for "
                                 f"{3 * LEAF_TIMED} leaves")
        if not (bool(s["live"].all()) and bool(state["plain"]["live"].all())):
            raise AssertionError(f"leaf C={C} D={D}: a chain stopped during the timed leaves")
        differ = [k for k, v in s.items() if not torch.equal(v, state["plain"][k])]
        if differ:
            raise AssertionError(f"leaf C={C} D={D}: after the timed leaves the kernel's {differ} differ in their "
                                 f"bits from the plain leaf's")
        r["bound_ms"], r["bound_by"] = leaf_bound(C, D, timed)
        out[C, D] = r
        _log(f"[leaf] C={C} D={D} over {LEAF_TIMED} live leaves: kernel device_ms={r['ms']:.6f} "
             f"({r['leaves_seen']} launches seen) host_ms={r['host_ms']:.6f}; plain leaf device_ms={r['plain_ms']:.6f} "
             f"({r['plain_ops_per_leaf']:.2f} device operations, {r['plain_leaves_seen']} leaves seen) "
             f"host_ms={r['plain_host_ms']:.6f}; bound_ms={r['bound_ms']:.3g} ({r['bound_by']})")
    return out


def density_bound(C: int, D: int) -> tuple[float, str]:
    """The u-space density's bound a call for C chains of D dimensions.
    Bytes, float32, what the function itself reads and writes: u, ll, beta
    and g_ll in, theta, the value and the gradient out, 16 D + 12 bytes a
    chain. The pair's own round trip through its scratch between the two
    launches (dtheta, dlog_det, g_lp and lp + log_det, 24 D + 8 bytes a
    chain) is a cost of splitting the work around the potential, and is not
    counted. Operations, a special function one: about 40 a dimension
    (sigmoid, exp, two logsigmoids, the prior's column and its gradient,
    the sums, the chain rule)."""
    return _bound(C * 40.0 * D, C * (16.0 * D + 12.0))


def time_density(device) -> dict:
    """The u-space density's pair and the plain composition on the
    flagship's prior at DENSITY_CHAINS, D = 5, around a likelihood that
    hands back the same (ll, g_ll) and launches nothing, over DENSITY_TIMED
    calls a side: device time and device operations a call
    (``torch.profiler``; a call seen by the pair's ``density_post``, by the
    plain composition's one sigmoid), and host time a call; one pair a
    call, whose value and gradient equal the plain composition's bit for
    bit. Returns {C: times}."""
    import torch

    from sbi_for_diffusion_models_tpu_torch import potentials as tp
    from sbi_for_diffusion_models_tpu_torch.distributions import mcmc_transform
    from sbi_for_diffusion_models_tpu_torch.inference.nuts import geometric_ladder
    from sbi_for_diffusion_models_tpu_torch.ops import density_cuda
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta

    prior = build_prior_theta()
    bij = mcmc_transform(prior)
    D = bij.dim

    class Likelihood:
        def __init__(self, C):
            gen = torch.Generator().manual_seed(C)
            self.local_theta = torch.zeros((1, 1), device=device)
            self.out = (torch.randn((C,), generator=gen).mul(50.0).to(device),
                        torch.randn((C, D), generator=gen).mul(5.0).to(device))

        def log_lik_and_grad(self, x, theta, need_grad=True, sessions=None):
            return self.out[0], (self.out[1] if need_grad else None)

    out = {}
    for C in DENSITY_CHAINS:
        lik = Likelihood(C)
        vg = tp.tempered_value_and_grad(prior, bij, lik)
        beta = torch.as_tensor(geometric_ladder(6, 0.04)).repeat(C // 6).to(device)
        u = torch.randn((C, D), generator=torch.Generator().manual_seed(17 + C)).mul(0.3).to(device)

        def pair():
            for _ in range(DENSITY_TIMED):
                vg(u, None, beta, True)

        def plain():
            for _ in range(DENSITY_TIMED):
                tp._tempered_vg_plain(prior, bij, lik, 1.0, u, None, beta, True)

        since = [k.launches for k in (density_cuda.DENSITY_PRE, density_cuda.DENSITY_POST)]
        r = {"D": D, "host_ms": _host_ms(pair, DENSITY_TIMED), "plain_host_ms": _host_ms(plain, DENSITY_TIMED)}
        r["ms"], r["ops_per_call"], r["calls_seen"] = _device_ms(pair, "density_post_kernel", DENSITY_TIMED)
        # The plain composition's calls by its one sigmoid (the bijector's; logsigmoid's kernel has another name).
        r["plain_ms"], r["plain_ops_per_call"], r["plain_calls_seen"] = _device_ms(plain, "sigmoid_kernel_cuda",
                                                                                  DENSITY_TIMED)
        launched = [k.launches - b for k, b in zip((density_cuda.DENSITY_PRE, density_cuda.DENSITY_POST), since)]
        if launched != [3 * DENSITY_TIMED] * 2:  # two host runs and the profiled one
            raise AssertionError(f"density C={C}: {launched} launches of the pair for {3 * DENSITY_TIMED} calls")
        differ = [i for i, (a, b) in enumerate(zip(vg(u, None, beta, True),
                                                   tp._tempered_vg_plain(prior, bij, lik, 1.0, u, None, beta, True)))
                  if not torch.equal(a, b)]
        if differ:
            raise AssertionError(f"density C={C}: the pair's {['value', 'gradient'][differ[0]]} differs in its bits "
                                 f"from the plain composition's")
        r["bound_ms"], r["bound_by"] = density_bound(C, D)
        out[C] = r
        _log(f"[density] C={C} D={D} over {DENSITY_TIMED} calls: pair device_ms={r['ms']:.6f} "
             f"({r['ops_per_call']:.2f} device operations, {r['calls_seen']} calls seen) host_ms={r['host_ms']:.6f}; "
             f"plain composition device_ms={r['plain_ms']:.6f} ({r['plain_ops_per_call']:.2f} device operations, "
             f"{r['plain_calls_seen']} calls seen) host_ms={r['plain_host_ms']:.6f}; "
             f"bound_ms={r['bound_ms']:.3g} ({r['bound_by']})")
    return out


def measured_bounds(kernels: list, report: dict) -> None:
    """Add ``measured_bound_ms`` to every timed entry of the line: its
    operations over the issue rates K4 measured in this run (``roofline.main``'s
    report) instead of the datasheet's. The fused kernels' FLOP are FMAs,
    two each, at the fma ceiling; K1's executed steps take their FMA-class
    operations at the fma ceiling and their special functions at the
    transcendental-mix ceiling, as ``roofline.py`` states its demand."""
    from sbi_for_diffusion_models_tpu_torch.roofline import K1_FMA_CLASS_OPS, K1_TRANSCENDENTAL_CLASS_OPS

    fma, tra = report["issue_fma"]["ops_per_s"], report["issue_transcendental"]["ops_per_s"]
    for k in kernels:
        for at in (k, *(v for v in k.values() if isinstance(v, dict) and "bound_ms" in v), *k.get("at", ())):
            if k["name"] == "ddm_rt_choice":
                per_step = K1_FMA_CLASS_OPS / fma + K1_TRANSCENDENTAL_CLASS_OPS / tra
                at["measured_bound_ms"] = at["steps"] * per_step * 1e3
            elif at["bound_by"] == "operations":
                at["measured_bound_ms"] = at["bound_ms"] * (FP32_OPS_PER_S / 2.0) / fma
            else:  # bytes: no issue rate enters
                at["measured_bound_ms"] = at["bound_ms"]


def main_path_launches(device) -> dict:
    """The flagship serving path once: the observed session's posterior
    (``card_common.observed_session``) through ``run_inference_mcmc`` under
    the calibrated sampler at SERVE_WARMUP and SERVE_DRAWS, every kernel's
    launch count zeroed just before it. Fails unless the draws are finite
    and of their shape, and K3, the leaf kernel and the density pair
    launched; returns {kernel name: launches}."""
    import torch

    from card_common import observed_session
    from sbi_for_diffusion_models_tpu_torch.mnle import load_model, run_inference_mcmc
    from sbi_for_diffusion_models_tpu_torch.ops._cuda import KERNELS
    from sbi_for_diffusion_models_tpu_torch.run_config import CALIBRATED_CONFIG

    os.environ["MODEL_DIR"] = str(MODEL_DIR)
    prior, x_o, pulses_o = observed_session(device)
    est = load_model(MODEL_FILE, device=device)
    cfg = CALIBRATED_CONFIG.replace(WARMUP_STEPS=SERVE_WARMUP, POSTERIOR_SAMPLES=SERVE_DRAWS)
    for k in KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    samples = run_inference_mcmc(cfg, prior, est, x_o, pulses_o, device=device, seed=0, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    if tuple(samples.shape) != (SERVE_DRAWS, 5) or not bool(torch.isfinite(samples).all()):
        raise AssertionError(f"the flagship serving path's draws: {tuple(samples.shape)}, finite "
                             f"{bool(torch.isfinite(samples).all())}")
    idle = [n for n in ("mnle_logprob_bwd", "nuts_leaf", "density_pre", "density_post") if launches[n] <= 0]
    if idle:
        raise AssertionError(f"the flagship serving path launched no {idle}: {launches}")
    _log(f"[main] run_inference_mcmc, warmup {SERVE_WARMUP}, {SERVE_DRAWS} draws: wall_s={wall:.3f} "
         f"launches {json.dumps(launches)}")
    return launches


def _ptxas_of(ptxas: dict, entry: str) -> dict:
    """ptxas's report of the entry functions whose mangled names hold
    ``entry``; K1's instances by group size, collapsing bound and per-trial
    noise scale."""
    found = {e: v for e, v in ptxas.items() if entry in e}
    if entry != "ddm_rt_choice_kernel":
        return next(iter(found.values())) if len(found) == 1 else found
    named = {}
    for e, v in found.items():
        m = re.search(r"ddm_rt_choice_kernelILi(\d+)ELb([01])ELb([01])E", e)
        named[f"G{m[1]}" + ("_collapse" if m[2] == "1" else "") + ("_sig_rows" if m[3] == "1" else "") if m else e] = v
    return named


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]  # the package, port_bench and tests/card_common.py
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _log(f"[device] torch={torch.__version__} cuda={torch.version.cuda} device={name} ({smi})")

    t_start = time.perf_counter()
    ptxas = build()
    k1, fused, k4 = time_k1(device), time_fused(device), time_k4(device)
    leaf, density = time_leaf(device), time_density(device)
    main_path = main_path_launches(device)
    _log(f"[time] whole script after start-up: {time.perf_counter() - t_start:.1f} s")

    src, jax_ops = f"{PKG}/csrc", "sbi_for_diffusion_models_tpu/ops"
    tile_rows = int(re.search(r"#define TILE_ROWS (\d+)", (ROOT / src / "mnle_tile.cuh").read_text())[1])
    kernels = [{"name": "ddm_rt_choice", "source": f"{src}/ddm_rt_choice.cu", "replaces": f"{jax_ops}/ddm_pallas.py:60",
                **k1[4096], "large": k1[N_SIM], "per_trial_sigma": k1["per_trial_sigma"]}]
    for kname, label, f, rep, model in (
        ("mnle_logprob_fwd", "K2", "mnle_logprob.cu", "mnle_pallas.py:269", MODEL_FILE),
        ("mnle_logprob_bwd", "K3", "mnle_logprob.cu", "mnle_pallas.py:275", MODEL_FILE),
        ("mnle_pulse_fwd", "K2p", "mnle_pulse.cu", "mnle_pallas.py:333", PULSE_MODEL_FILE),
        ("mnle_pulse_bwd", "K3p", "mnle_pulse.cu", "mnle_pallas.py:361", PULSE_MODEL_FILE),
    ):
        main_rows, *more = fused[model, label]
        others = [{"model": m, **e} for (m, lb), es in fused.items() if lb == label and m != model for e in es]
        kernels.append({"name": kname, "source": f"{src}/{f}", "replaces": f"{jax_ops}/{rep}",
                        "rows_per_block": tile_rows, **main_rows, "at": more + others})
    fma = k4["report"]["issue_fma"]
    kernels.append({"name": "issue_ceiling", "source": f"{src}/issue_ceiling.cu",
                    "replaces": "benchmarks/roofline.py:105", "K": fma["K_hi"], "n": fma["elements"],
                    **{k: v for k, v in k4.items() if k != "report"},
                    "kinds": {kind: k4["report"][f"issue_{kind}"] for kind in ("fma", "transcendental")}})
    (C, D), *more = LEAF_SHAPES
    kernels.append({"name": "nuts_leaf", "source": f"{src}/nuts_leaf.cu", "replaces": None, "n": C, **leaf[C, D],
                    "at": [{"n": c, **leaf[c, d]} for c, d in more]})
    C, *more = DENSITY_CHAINS
    kernels.append({"name": "density_pre", "pair": ["density_pre", "density_post"], "source": f"{src}/udensity.cu",
                    "replaces": None, "n": C, **density[C], "at": [{"n": c, **density[c]} for c in more]})
    for k in kernels:
        k.update(route="cuda", library_ms=None, main_path_launches=main_path[k["name"]])
        if "pair" in k:
            k["main_path_launches"] = {e: main_path[e] for e in k["pair"]}
        k["ptxas"] = ({e: _ptxas_of(ptxas, f"{e}_kernel") for e in k["pair"]} if "pair" in k
                      else _ptxas_of(ptxas, f"{k['name']}_kernel"))
    measured_bounds(kernels, k4["report"])
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
