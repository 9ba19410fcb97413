"""What the card tests, ``chip_smoke.py`` and ``compare_k3.py`` share: the
session rows the posterior potential builds and the observed session the
serving paths sample (their inputs), the float64 row rule that holds a fused
pair on such rows (``hold_rows``), the distribution test that holds draws of
(rt, choice) against a plain version's, and ptxas's report of every kernel
build.

Nothing here touches the card at import time.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from scipy import stats

from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda as mc
from sbi_for_diffusion_models_tpu_torch.ops.rowcheck import reference, row_check


def session_pairs(prior, device, n_sessions: int, seed: int = 11) -> list:
    """Per session, the (x, condition) rows the posterior potential builds:
    a prior draw theta_true, its simulated 50-trial session, and 24 thetas
    (theta_true and 23 prior draws) against every trial: (1,200, 2) and
    (1,200, 85)."""
    from sbi_for_diffusion_models_tpu_torch.data_simulator import simulate_observed_session
    from sbi_for_diffusion_models_tpu_torch.utils.rng import child_seed, make_generator

    out = []
    for i in range(n_sessions):
        gen = make_generator(child_seed(seed, i), device)
        theta = prior.sample(gen, (24,))
        x, s = simulate_observed_session(theta[0], 50, seed=child_seed(seed, 1000 + i), device=device)
        cond = torch.cat([theta[:, None, :].expand(24, 50, 5), s[None].expand(24, 50, s.shape[1])], -1)
        out.append((x[None].expand(24, 50, 2).reshape(-1, 2), cond.reshape(-1, cond.shape[-1])))
    return out


def session_rows(est, prior, device, n_sessions: int, seed: int = 11):
    """Standardized rows as the posterior potential builds them (1,200 a
    session, ``session_pairs``). Returns the kernels' row inputs: (t,
    onehot, ctx), or for the pulse rep (phi, onehot, ctx, kf, kv); ctx is
    the context the heads read (with the pulse embedding, ``make_context``'s)."""
    parts = []
    for xr, cr in session_pairs(prior, device, n_sessions, seed):
        if est.cfg.rt_rep == "pulse":
            phi, oh, c, kf, kv, _, _ = est.standardize_pulse(xr, cr)
            parts.append((phi, oh, est.net.make_context(c, cr), kf, kv))
        else:
            t, oh, c, _, _, _ = est.standardize(xr, cr)
            parts.append((t, oh, est.net.make_context(c, cr)))
    return tuple(torch.cat(col).contiguous() for col in zip(*parts))


def observed_session(device):
    """The observed session the serving paths sample: theta_true from the
    prior (seed 3) and its 50-trial session (seed 123). Returns (prior,
    x_o, pulses_o)."""
    from sbi_for_diffusion_models_tpu_torch.data_simulator import simulate_observed_session
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu_torch.run_config import CALIBRATED_CONFIG
    from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

    prior = build_prior_theta()
    theta_true = prior.sample(make_generator(3, device), (1,))[0]
    x_o, pulses_o = simulate_observed_session(theta_true, CALIBRATED_CONFIG.NUM_TRIALS_OBS, seed=123, device=device)
    return prior, x_o, pulses_o


def hold_rows(w, rows, g) -> tuple:
    """A fused pair (K2/K3, or K2p/K3p for pulse-grid weights) on the kernel
    inputs ``rows`` with the cotangent ``g``: the forward wrapper launches
    the forward kernel once and the backward wrapper the backward kernel
    alone, once; the backward kernel's value has the forward kernel's bits
    on every row; a censored row has no gradient of its RT (of its phase
    and slot features for the pulse rep: the kernels skip its flow); and
    each output, both values and every gradient, passes
    ``ops/rowcheck.row_check`` against the plain version in float64 (the
    value to 1e-4 and the gradients to 1e-3 of the row's own scale, twice
    the row's float32 spread added on steep rows, on all but 0.1 % of the
    rows; the value also on its worst row). Returns the kernels' outputs and
    their checks, each in the order (value, the backward kernel's value,
    gradients...)."""
    if w.pulse:
        fwd, both, plain_fwd, plain_bwd = (mc.rows_logp_pulse, mc.rows_logp_pulse_and_vjp, mc.rows_logp_pulse_plain,
                                           mc.rows_logp_pulse_vjp_plain)
        kernels = (mc.K2P, mc.K3P)
    else:
        fwd, both, plain_fwd, plain_bwd = mc.rows_logp, mc.rows_logp_and_vjp, mc.rows_logp_plain, mc.rows_logp_vjp_plain
        kernels = (mc.K2, mc.K3)
    before = [k.launches for k in kernels]
    kern = (fwd(*rows, w), *both(*rows, w, g))
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1], [k.name for k in kernels]
    n = rows[0].shape[0]
    differ = int((kern[1] != kern[0]).sum())
    assert differ == 0, f"the backward kernel's value differs from the forward kernel's on {differ} of {n} rows"
    if w.censored_col is not None:
        cens = rows[1][:, w.censored_col] > 0
        assert not any(bool(kern[i][cens].any()) for i in ((2, 4) if w.pulse else (2,))), "a censored row's RT gradient"
    value = plain_fwd(*rows, w)
    plain = (value, value, *plain_bwd(*rows, w, g))
    w64 = w.astype(torch.float64)

    def run64(*a):
        v = plain_fwd(*a[:-1], w64)
        return (v, v, *plain_bwd(*a[:-1], w64, a[-1]))

    ref, spread = reference(run64, rows, g, (2, 3) if w.pulse else (2,))
    checks = [row_check(k, p, r, sp, value=i < 2) for i, (k, p, r, sp) in enumerate(zip(kern, plain, ref, spread))]
    failed = [f"output {i}: {c.share:.3e} of {n} rows over their allowance, worst {c.worst:.3f} (limit {c.limit})"
              for i, c in enumerate(checks) if not c.ok]
    assert not failed, failed
    return kern, checks


def same_distribution(a, b, censored: int = 2, at_least: int = 1) -> dict:
    """Two samples of (rt, choice) rows, tensors or arrays: the chi-square
    test's p on the choice counts, and a two-sample KS test's on the RTs of
    each choice but ``censored`` (whose RT is a constant; None for none)
    that both samples have at least ``at_least`` rows of."""
    a, b = (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in (a, b))
    counts = np.array([[np.sum(x[:, 1] == c) for c in range(3)] for x in (a, b)])
    seen = counts.sum(0) > 0  # a choice neither side produced has no column in the table
    p = {"choice": float(stats.chi2_contingency(counts[:, seen])[1]) if seen.sum() > 1 else 1.0}
    for c in range(3):
        if c != censored and counts[:, c].min() >= at_least:
            p[f"rt|{c}"] = float(stats.ks_2samp(a[a[:, 1] == c, 0], b[b[:, 1] == c, 0]).pvalue)
    return p


def ptxas_report() -> dict:
    """What ptxas -v said of every entry function of every built library, as
    the build keeps it beside the library: mangled name -> registers, stack,
    spill stores and loads in bytes."""
    from sbi_for_diffusion_models_tpu_torch.ops import _cuda

    out: dict = {}
    for lib in _cuda._LIBRARIES.values():
        entry = ""
        for line in lib.build_log.splitlines():
            if "Compiling entry function" in line or "Function properties for" in line:
                entry = line.split("'")[1] if "'" in line else line.split()[-1]
            elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line):
                out.setdefault(entry, {}).update(zip(("stack", "spill_stores", "spill_loads"), map(int, m.groups())))
            elif m := re.search(r"Used (\d+) registers", line):
                out.setdefault(entry, {})["registers"] = int(m.group(1))
    return out
