"""``hier``: one cohort fit per request through
``models.hierarchical.run_hierarchical_inference``: population and subject
parameters sampled jointly (HDDM's partial pooling), every (chain row,
subject) pair folded into one likelihood launch a potential call.

The cohorts come from the run's seed: hyperparameters drawn from the
port's moment-matched hyperprior (the configuration's ``mu_frac``,
``tau_frac`` and ``hyper_shrink``), then each subject's theta, then the
stimuli, then the benchmark's plain Euler scan (``generator.simulate``).

Besides the probe's kept likelihood calls (the sampler cells' row
comparison), a seeded sample of the window's joint-density calls is kept
(q, the chain rows' cohort and inverse temperature, value and gradient, or
the untempered likelihood the replica exchange reads) and worked out again
by ``reference.hierarchical`` in float64. In a traced run the port's
recorder (``utils.metrics``) is on over the profiled tail, as in
``spans.SpanProbe``, and drained when the tail ends: the host time inside
the ``hier.density`` spans and outside their ``potential`` spans, with the
count of those potential calls, goes onto the tail's counters
(``hier_density_s``, ``hier_calls``) for ``metrics/hier_density_ms.py``.
A port without those spans leaves them at 0.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import generator
from ..compare import _or_inf, _quantile
from ..reference import hierarchical as ref_hier
from ..reference import mnle as ref
from .common import SAMPLER_FAULTS as FAULTS
from .common import load, loop, run_config, sampler_control, sampler_numbers

__all__ = ["run", "numbers", "control", "FAULTS", "cohorts", "density_numbers", "density_self"]

REF_ROWS = 1 << 17  # trial rows a block of the reference: a whole 76,800-row call at once on the card


def cohorts(seed: int, count: int, subjects: int, trials: int, hyper: ref_hier.Hyperprior, shrink: float, device):
    """``count`` cohorts of ``subjects`` subjects with ``trials`` trials each:
    (theta (count, S, 5), x (count, S, T, 2), stimuli (count, S, T, 80)).
    Each cohort's mu and log tau are drawn from the hyperprior (its scales
    times ``shrink``), its subjects' offsets from N(0, 1); theta = b(mu +
    tau * eps), b the prior's bijection."""
    gen = generator.generator(seed, device)
    hyper = hyper.to(torch.float32, device)
    D = hyper.mu_loc.shape[0]
    mu = hyper.mu_loc + shrink * hyper.mu_scale * torch.randn((count, 1, D), generator=gen, device=device)
    log_tau = hyper.log_tau_loc + shrink * hyper.log_tau_scale * torch.randn((count, 1, D), generator=gen,
                                                                              device=device)
    eps = torch.randn((count, subjects, D), generator=gen, device=device)
    theta, _ = ref_hier.bijection(mu + torch.exp(log_tau) * eps)
    n = count * subjects * trials
    s = generator.stimuli(gen, n)
    x = generator.simulate(gen, theta.reshape(-1, D).repeat_interleave(trials, 0), s)
    return theta, x.reshape(count, subjects, trials, 2), s.reshape(count, subjects, trials, generator.N_PULSES)


def _hyperprior(model) -> ref_hier.Hyperprior:
    return ref_hier.Hyperprior(model.mu_loc, model.mu_scale, model.log_tau_loc, model.log_tau_scale)


def run(ctx) -> tuple[int, int]:
    from sbi_for_diffusion_models_tpu_torch.models import hierarchical as hm
    from sbi_for_diffusion_models_tpu_torch.utils import metrics

    mix = ctx.mix
    h = {**ctx.config["hierarchical"], **mix.get("hierarchical", {})}
    prior, est = load(ctx)
    model = hm.HierarchicalModel.from_prior(prior, mu_frac=h["mu_frac"], tau_frac=h["tau_frac"], device=ctx.device)
    _, x, s = cohorts(generator.child(ctx.seed, 1), mix["cohorts"], h["subjects"], h["trials"], _hyperprior(model),
                      h["hyper_shrink"], ctx.device)
    ctx.data = {"model": model, "density": []}
    _keep_density_calls(ctx, hm)
    _record_tail(ctx.probe, metrics)

    def request(i, cfg=run_config(ctx.config, mix)):
        k = i % x.shape[0]
        hm.run_hierarchical_inference(
            est, prior, x[k], s[k], model=model, num_chains=cfg.NUM_CHAINS, num_warmup=cfg.WARMUP_STEPS,
            num_samples=cfg.POSTERIOR_SAMPLES // cfg.NUM_CHAINS, max_tree_depth=cfg.MCMC_MAX_TREE_DEPTH,
            target_accept=cfg.MCMC_TARGET_ACCEPT, pt_replicas=cfg.MCMC_PT_REPLICAS,
            pt_beta_min=cfg.MCMC_PT_BETA_MIN, logprob_kernel=cfg.MNLE_LOGPROB_KERNEL,
            seed=generator.child(ctx.seed, 2, i), verbose=False)

    request(-1, run_config(ctx.config, mix, **mix["warmup_request"]))
    ctx.probe.start_window()
    return loop(ctx.probe, request)


def _keep_density_calls(ctx, hm) -> None:
    """Wrap ``hm._hierarchical_density`` so that a seeded share of the
    window's value-and-gradient and likelihood calls is kept in
    ``ctx.data["density"]``."""
    probe, kept = ctx.probe, ctx.data["density"]
    rate, most = ctx.mix["density_capture_rate"], ctx.mix["density_max_captures"]
    rng = np.random.default_rng(generator.child(ctx.seed, 7))
    real = hm._hierarchical_density

    def chosen() -> bool:
        return probe.phase == "window" and len(kept) < most and rng.random() < rate

    def density(model, bij, est, xs, ps, logprob_kernel: str = "auto"):
        logp, ll, vg = real(model, bij, est, xs, ps, logprob_kernel)

        def keep(kind, q, data, value, grad):
            kept.append({"kind": kind, "q": q.detach().clone(), "rep": data[0].clone(), "beta": data[1].clone(),
                         "xs": xs, "ps": ps, "value": value.detach().clone(),
                         "grad": None if grad is None else grad.detach().clone()})

        def ll_kept(q, data):
            out = ll(q, data)
            if chosen():
                keep("ll", q, data, out, None)
            return out

        def vg_kept(q, data, need_grad: bool = True):
            value, grad = vg(q, data, need_grad)
            if chosen():
                keep("vg", q, data, value, grad)
            return value, grad

        return logp, ll_kept, None if vg is None else vg_kept

    probe.wrap(hm, "_hierarchical_density", density)


def _record_tail(probe, metrics) -> None:
    """The port's recorder on from the start of the profiled tail to its end
    (unless the probe records the tail itself, as ``spans.SpanProbe`` does)."""
    real = probe.boundary
    own = False

    def boundary():
        nonlocal own
        if own and probe.phase == "tail" and time.perf_counter() >= probe._deadline:
            own = False
            _put_on_tail(probe, *metrics.drain())
        before = probe.phase
        real()
        if before == "window" and probe.phase == "tail" and not metrics.RECORDING:
            metrics.enable()
            own = True

    probe.boundary = boundary


def _put_on_tail(probe, spans, counters) -> None:
    probe.tail.hier_density_s, probe.tail.hier_calls = density_self(spans)


def density_self(spans) -> tuple[float, int]:
    """(seconds inside ``hier.density`` spans and outside the ``potential``
    spans within them, the number of those potential spans)."""
    inside = [False] * len(spans)  # a hier.density span or one within one
    total, calls = 0, 0
    for i, sp in enumerate(spans):
        parent = sp.parent
        within = parent >= 0 and inside[parent]
        inside[i] = within or sp.name == "hier.density"
        if sp.name == "hier.density" and not within:
            total += sp.end_ns - sp.start_ns
        elif sp.name == "potential" and within:
            total -= sp.end_ns - sp.start_ns
            calls += 1
    return total * 1e-9, calls


def density_numbers(model64: ref.Model, hyper: ref_hier.Hyperprior, kept, against: ref.Model | None = None,
                    detail: bool = False) -> dict:
    """The kept joint-density calls against ``reference.hierarchical`` in
    float64 (``against``, a reference model in another type with TF32
    products, in the port's place: the control). A chain row is judged
    where its subjects' theta, computed from q in float32, lies inside the
    prior's open support (a Beta dimension's logistic not rounded to 0 or
    1, no exp overflowing) and the reference is finite. Value gap: |v -
    v_ref| / max(|v_ref|, S*T) (on likelihood calls, of the untempered
    likelihood); gradient gap: max_j |g_j - g_ref_j| / max(max_j |g_ref_j|,
    the median over the rows of max_j |g_ref_j|)."""
    v_rows, g_err, g_scale = [], [], []
    judged = 0
    for cap in kept:
        xs, ps, rep, q = cap["xs"], cap["ps"], cap["rep"], cap["q"]
        S, T = xs.shape[1:3]
        need_grad = cap["grad"] is not None
        x, stim = xs[rep], ps[rep]
        v_r, g_r, ll_r = ref_hier.log_density(model64, hyper, q, x, stim, cap["beta"], need_grad,
                                              rows_per_block=REF_ROWS)
        want = ll_r if cap["kind"] == "ll" else v_r
        if against is None:
            have, g = cap["value"].to(want.dtype), None if g_r is None else cap["grad"].to(want.dtype)
        else:
            v_c, g_c, ll_c = ref_hier.log_density(against, hyper, q, x, stim, cap["beta"], need_grad, tf32=True,
                                                  rows_per_block=REF_ROWS)
            have = (ll_c if cap["kind"] == "ll" else v_c).to(want.dtype)
            g = None if g_c is None else g_c.to(want.dtype)
        D = hyper.mu_loc.shape[0]
        u = q[:, None, :D] + torch.exp(q[:, None, D:2 * D]) * q[:, 2 * D:].reshape(q.shape[0], S, D)
        theta32, _ = ref_hier.bijection(u)
        unit = theta32[..., list(ref_hier.UNIT_DIMS)]
        inside = ((unit > 0) & (unit < 1)).all(-1).all(-1) & torch.isfinite(theta32).all(-1).all(-1) \
            & (theta32 > 0).all(-1).all(-1)
        keep = inside & torch.isfinite(want) & (torch.isfinite(g_r).all(-1) if g_r is not None else True)
        judged += int(keep.sum())
        v_rows.append(_or_inf((have - want).abs() / want.abs().clamp(min=S * T), have)[keep])
        if g is not None:
            g_err.append(_or_inf((g - g_r).abs().amax(-1), g)[keep])
            g_scale.append(g_r.abs().amax(-1)[keep])
    v_all = torch.cat(v_rows) if v_rows else torch.zeros(0)
    gap = None
    if g_err:
        err, scale = torch.cat(g_err), torch.cat(g_scale)
        gap = err / torch.maximum(scale, scale.median()) if scale.numel() else err
    out = {"density_value_gap_median": _quantile(v_all, 0.5), "density_value_gap_max": _quantile(v_all, 1.0),
           "density_grad_gap_median": _quantile(gap, 0.5), "density_grad_gap_max": _quantile(gap, 1.0),
           "density_rows_judged": judged, "density_calls_compared": len(kept)}
    if detail:
        out.update(density_value_gap_p90=_quantile(v_all, 0.9), density_grad_gap_p90=_quantile(gap, 0.9))
    return out


def numbers(ctx, detail: bool = False) -> dict:
    """The kept likelihood calls' rows against ``reference.mnle`` (as the
    sampler cells), then the kept joint-density calls against
    ``reference.hierarchical``, both in float64."""
    out = sampler_numbers(ctx, detail)
    model64 = ref.load_npz(ctx.model_path, torch.float64, ctx.device)
    out.update(density_numbers(model64, _hyperprior(ctx.data["model"]), ctx.data["density"], detail=detail))
    return out


def control(ctx) -> dict:
    """The same numbers with both references in float32 and TF32 products
    in the port's place, on the same kept calls."""
    out = sampler_control(ctx)
    model64 = ref.load_npz(ctx.model_path, torch.float64, ctx.device)
    out.update(density_numbers(model64, _hyperprior(ctx.data["model"]), ctx.data["density"],
                               against=model64.to(torch.float32), detail=True))
    return out
