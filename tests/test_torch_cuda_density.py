"""PyTorch port: the u-space density's kernel pair (``csrc/udensity.cu``,
``ops/density_cuda.py``) on the card. The pair against the plain composition
(``potentials._tempered_vg_plain``) bit for bit, over chain counts, priors,
scales of u, its edges (infinities, NaN, where the clamps and branches
engage), rung betas and temperatures; the kernel's one-input functions
against PyTorch's over every float32; the sampler's draws through the pair
against the plain composition (``run_inference_mcmc`` and one SBC fold
launch); no launch on the hierarchical path; and the launches a serving leaf
makes. Without a CUDA device (or without nvcc to build the kernels) every
test here is skipped. This module imports no JAX.
"""

import math
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from sbi_for_diffusion_models_tpu_torch import distributions as td
from sbi_for_diffusion_models_tpu_torch import potentials as tp
from sbi_for_diffusion_models_tpu_torch.inference import nuts as tn
from sbi_for_diffusion_models_tpu_torch.ops import density_cuda
from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
from sbi_for_diffusion_models_tpu_torch.utils import metrics
from sbi_for_diffusion_models_tpu_torch.utils.metrics import device_intervals, warm_window
from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

pytestmark = pytest.mark.requires_cuda

DEV = torch.device("cuda", 0)
ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP = ROOT / "artifacts" / "models" / "mnle_10m_shifted_logt_affine.npz"


@pytest.fixture(autouse=True)
def _needs_card():
    """Skip unless there is a CUDA device and nvcc (decided per test, never
    while the module is imported)."""
    _card_or_skip()


def _card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the density kernels are CUDA C++ with no CPU mode")
    if not (Path("/usr/local/cuda/bin/nvcc").exists() or shutil.which("nvcc")):
        pytest.skip("needs nvcc: the kernels are built from source at first use")


def _differing(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements whose float32 bits differ (NaN against NaN counts as the
    same, whatever the payload)."""
    same = (a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))
    return int((~same).sum())


PRIORS = {
    "flagship": build_prior_theta,
    "box": lambda: td.BoxUniform([0.1, 0.05, 0.2, 2.0, 0.0], [0.9, 1.0, 3.0, 20.0, 0.5]),
    "normal": lambda: td.Normal([0.0, 1.5, -2.0, 0.3, 4.0], [1.0, 0.25, 3.0, 0.7, 2.5]),
    "interleaved": lambda: td.MultipleIndependent([td.Uniform(-1.0, 3.0), td.Beta(2.0, 5.0), td.Normal(0.5, 2.0),
                                                   td.LogNormal(0.3, 0.7), td.Beta(1.5, 1.2)]),
    # The 7-parameter variant's width.
    "seven": lambda: td.MultipleIndependent([td.Beta(2.0, 2.0), td.LogNormal(-1.0, 1.0), td.LogNormal(0.0, 1.0),
                                             td.LogNormal(2.75, 0.5), td.Beta(2.0, 2.0), td.Normal(0.0, 1.0),
                                             td.Uniform(0.0, 0.3)]),
}
CHAINS = (1, 7, 24, 33, 2304)
# u where the clamps and the where branches engage: sigmoid(u) near 1 - 1e-7 (u near 16.1), near and below
# 1e-37 (u near -85.2, and subnormal or 0 below about -87.3 and -103.3), exp's overflow above 88.72, and beyond.
EDGES = [0.0, -0.0, 1e-30, -1e-30, 1.0, -1.0, 15.9, 16.0, 16.1, 16.118, 16.12, 16.2, 16.5, 17.0, 17.4, 80.0, -80.0,
         -85.0, -85.2, -85.3, -86.0, -87.3, -88.0, -89.0, -95.0, -103.0, -103.3, -104.0, -110.0, -150.0, 88.7, 88.72,
         88.73, 89.0, 100.0, -100.0, 3.4e38, -3.4e38, math.inf, -math.inf, math.nan]


class _Stand_in:
    """A likelihood on the card for the pair's checks: ll = -0.5 sum(w
    (theta - m)^2) and its gradient, plain PyTorch operations, so both
    routes get the same ll for the same theta; keeps the theta it saw."""

    def __init__(self, D: int):
        self.local_theta = torch.zeros((1, 1), device=DEV)
        self.m = torch.linspace(0.1, 2.0, D, device=DEV)
        self.w = torch.linspace(0.5, 3.0, D, device=DEV)
        self.seen = None

    def log_lik_and_grad(self, x, theta, need_grad: bool = True, sessions=None):
        self.seen = theta
        d = theta - self.m
        return -0.5 * (self.w * d * d).sum(-1), (-(self.w * d) if need_grad else None)


def _inputs(C: int, D: int, seed: int):
    """Batches of u (C, D): normal draws at scales 0.3, 3 and 30, then the
    EDGES, each value in every column over the batches."""
    gen = torch.Generator().manual_seed(seed)
    for scale in (0.3, 3.0, 30.0):
        yield torch.randn((C, D), generator=gen).mul(scale).to(DEV)
    edges = torch.tensor(EDGES, dtype=torch.float32)
    n = len(EDGES)
    for b in range(-(-n // C) if C < n else 1):
        idx = (b * C + torch.arange(C)[:, None] + 3 * torch.arange(D)[None, :]) % n
        yield edges[idx].to(DEV)


@pytest.mark.parametrize("C", CHAINS)
@pytest.mark.parametrize("prior_name", sorted(PRIORS))
def test_the_pair_equals_the_plain_composition(prior_name, C):
    """Value, gradient, theta (what the potential receives) and the
    value-only call, bit for bit, at temperatures 1, 2 and 3 and the
    serving ladder's rung betas."""
    prior = PRIORS[prior_name]()
    bij = td.mcmc_transform(prior)
    D = bij.dim
    beta = torch.as_tensor(tn.geometric_ladder(6, 0.04)).repeat(-(-C // 6))[:C].to(DEV)
    checked = 0
    for T in (1.0, 2.0, 3.0):
        lik = _Stand_in(D)
        vg = tp.tempered_value_and_grad(prior, bij, lik, T)
        for i, u in enumerate(_inputs(C, D, seed=C + 7 * D)):
            for need_grad in (True, False):
                before = density_cuda.DENSITY_PRE.launches, density_cuda.DENSITY_POST.launches
                value, grad = vg(u, None, beta, need_grad)
                theta_k = lik.seen
                assert (density_cuda.DENSITY_PRE.launches - before[0], density_cuda.DENSITY_POST.launches - before[1]) \
                    == (1, 1)
                p_value, p_grad = tp._tempered_vg_plain(prior, bij, lik, T, u, None, beta, need_grad)
                where = f"{prior_name} C={C} T={T} batch {i} need_grad={need_grad}"
                assert _differing(theta_k, lik.seen) == 0, f"{where}: theta"
                assert _differing(value, p_value) == 0, f"{where}: value"
                if need_grad:
                    assert _differing(grad, p_grad) == 0, f"{where}: grad"
                else:
                    assert grad is None
                checked += 1
    assert checked > 0


REFERENCES = {
    "sigmoid": torch.sigmoid, "exp": torch.exp, "log": torch.log, "log1p": torch.log1p,
    "logsigmoid": torch.nn.functional.logsigmoid,
    "clamp": lambda x: torch.clamp(x, 1e-37, 1.0 - 1e-7), "clamp_min": lambda x: torch.clamp(x, min=1e-37),
}


@pytest.mark.parametrize("fn", density_cuda.UNARY_FUNCTIONS)
def test_the_unary_functions_equal_pytorch_over_every_float32(fn):
    """The kernel's ``fn`` against PyTorch's operation on every float32 bit
    pattern, 2^28 at a time: every output bit for bit (NaN against NaN
    counts as the same)."""
    n = 1 << 28
    differing, nan_payloads = 0, 0
    for first in range(0, 1 << 32, n):
        x, y = density_cuda.unary(fn, first, n, DEV)
        ref = REFERENCES[fn](x)
        differing += _differing(y, ref)
        nan_payloads += int(((y.view(torch.int32) != ref.view(torch.int32)) & torch.isnan(y) & torch.isnan(ref)).sum())
        del x, y, ref
    print(f"{fn}: {differing} of 2^32 differ; {nan_payloads} NaNs with another payload")
    assert differing == 0


def _session(seed: int, theta_seed: int):
    from sbi_for_diffusion_models_tpu_torch.data_simulator import simulate_observed_session

    prior = build_prior_theta()
    theta = prior.sample(make_generator(theta_seed, DEV), (1,))[0]
    return simulate_observed_session(theta, 50, seed=seed, device=DEV)


@pytest.fixture(scope="module")
def flagship():
    from sbi_for_diffusion_models_tpu_torch.mnle import load_model

    _card_or_skip()  # a module's fixture is set up before the autouse one
    return load_model(str(FLAGSHIP), device=DEV)


def test_run_inference_mcmc_draws_are_unchanged(flagship, monkeypatch):
    """The calibrated sampler at the flagship's shapes (4 chains x 6 rungs
    x 50 trials, grid hop and t_nd slice), warmup and draws cut: the same
    draws with every density call in the pair as with every one in the
    plain composition; two launches a potential call, and
    ``launch.density`` counts them."""
    from sbi_for_diffusion_models_tpu_torch.mnle import run_inference_mcmc
    from sbi_for_diffusion_models_tpu_torch.run_config import CALIBRATED_CONFIG

    x_o, pulses_o = _session(123, 3)
    cfg = CALIBRATED_CONFIG.replace(WARMUP_STEPS=8, POSTERIOR_SAMPLES=32)
    prior = build_prior_theta()

    def run():
        before = density_cuda.DENSITY_PRE.launches, density_cuda.DENSITY_POST.launches
        metrics.enable()
        try:
            s, info = run_inference_mcmc(cfg, prior, flagship, x_o, pulses_o, device=DEV, seed=5, verbose=False,
                                         return_info=True)
        finally:
            _, counters = metrics.drain()
        launched = (density_cuda.DENSITY_PRE.launches - before[0], density_cuda.DENSITY_POST.launches - before[1])
        return s, info, launched, counters.get("launch.density", 0)

    fused, info_f, launched, counted = run()
    # Every potential call but the exchange sweeps' value-only likelihood calls (one a transition here).
    transitions = cfg.WARMUP_STEPS + cfg.POSTERIOR_SAMPLES // cfg.NUM_CHAINS
    calls = info_f["potential_calls"] - len(range(0, transitions, cfg.MCMC_PT_SWAP_EVERY))
    assert launched == (calls, calls) and counted == 2 * calls > 0
    monkeypatch.setattr(tp, "_takes_density_kernel", lambda u: False)
    plain, info_p, launched_p, counted_p = run()
    assert launched_p == (0, 0) and counted_p == 0
    assert torch.equal(fused, plain)
    assert torch.equal(info_f["accept_prob"], info_p["accept_prob"])
    assert info_p["potential_calls"] == info_f["potential_calls"]


def test_an_sbc_fold_launch_draws_are_unchanged(flagship, monkeypatch):
    """``mnle._sbc_launch`` over three datasets folded into the chain axis
    (the calibrated sampler, warmup and draws cut): the same cold draws and
    accept rate through the pair as through the plain composition."""
    from sbi_for_diffusion_models_tpu_torch import mnle
    from sbi_for_diffusion_models_tpu_torch.run_config import CALIBRATED_CONFIG

    sessions = [_session(200 + g, 30 + g) for g in range(3)]
    x_g = torch.stack([x for x, _ in sessions])
    s_g = torch.stack([s for _, s in sessions])
    cfg = CALIBRATED_CONFIG
    prior = build_prior_theta()
    ladder = tn.geometric_ladder(int(cfg.MCMC_PT_REPLICAS), cfg.MCMC_PT_BETA_MIN)
    mode_hop = mnle._mode_hop(cfg, td.mcmc_transform(prior))
    warmup, per_chain = 5, 5

    def run():
        before = density_cuda.DENSITY_PRE.launches
        out = mnle._sbc_launch(cfg, prior, flagship, x_g, s_g, 11, 12, warmup, ladder, per_chain, mode_hop,
                               tau_init=True)
        return out, density_cuda.DENSITY_PRE.launches - before

    fused, launched = run()
    # One pair a potential call, but for the exchange sweeps' likelihood calls (one a transition).
    assert launched == fused[-1] - len(range(0, warmup + per_chain, cfg.MCMC_PT_SWAP_EVERY)) > 0
    monkeypatch.setattr(tp, "_takes_density_kernel", lambda u: False)
    plain, launched_p = run()
    assert launched_p == 0
    np.testing.assert_array_equal(fused[0], plain[0])
    assert fused[2] == plain[2] and fused[-1] == plain[-1]


def test_the_hierarchical_path_makes_no_density_launch(flagship):
    """``run_hierarchical_inference`` has a density of its own: no
    ``launch.density``, the leaf kernel at every leaf."""
    from sbi_for_diffusion_models_tpu_torch.models import hierarchical as th

    prior = build_prior_theta()
    _, x, pulses = th.simulate_hierarchical_sessions(prior, 4, 20, seed=1, device=DEV)
    before = density_cuda.DENSITY_PRE.launches, density_cuda.DENSITY_POST.launches
    metrics.enable()
    try:
        out = th.run_hierarchical_inference(flagship, prior, x, pulses, num_chains=2, num_warmup=3, num_samples=2,
                                            max_tree_depth=4, pt_replicas=2, seed=2, verbose=False)
    finally:
        _, counters = metrics.drain()
    assert np.isfinite(out["raw"]).all()
    assert (density_cuda.DENSITY_PRE.launches, density_cuda.DENSITY_POST.launches) == before
    assert counters.get("launch.density", 0) == 0 and counters.get("launch.leaf", 0) > 0


def test_a_serving_leaf_launches_the_pair_around_the_potential_alone(flagship):
    """A leaf of the serving sampler on the flagship (24 chains, 50
    trials): ``torch.rand``, the leaf kernel, ``density_pre``, the
    potential's own operations with K3, and ``density_post``; nothing else
    of the density. 32 leaves against 1 add 31 of each."""
    from sbi_for_diffusion_models_tpu_torch.potentials import ConditionedMNLELogLikelihood

    C, D = 24, 5
    x_o, pulses_o = _session(123, 3)
    prior = build_prior_theta()
    bij = td.mcmc_transform(prior)
    lik = ConditionedMNLELogLikelihood(flagship, pulses_o, logprob_kernel="pallas")
    beta = torch.as_tensor(tn.geometric_ladder(6, 0.04)).repeat(4).to(DEV)
    vg = tp.tempered_value_and_grad(prior, bij, lik)
    vg_fn = lambda u, need_grad=True: vg(u, x_o, beta, need_grad)  # noqa: E731
    u0 = bij.inverse(prior.sample(make_generator(9, DEV), (C,)))
    u0[:, 4] = bij.inverse(torch.full((C, D), 0.05, device=DEV))[:, 4]  # t_nd under the session's RTs

    def profiled(fn) -> dict:
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            warm_window()  # the profiler can miss the events at the ends of its window; spins, not counted
            out = fn()
            warm_window()
        names: dict = {}
        for _, _, name in device_intervals(prof):
            if "spin" not in name:
                names[name] = names.get(name, 0) + 1
        return out, names

    vg_fn(u0)  # the session's terms, made once
    theta0 = bij.forward(u0)
    _, potential = profiled(lambda: lik.log_lik_and_grad(x_o, theta0, True))
    pot_ops = sum(potential.values())
    assert sum(v for k, v in potential.items() if "mnle_logprob_bwd_kernel" in k) == 1, potential

    def device_ops(depth: int) -> dict:
        logp, g = vg_fn(u0)
        p = torch.ones((C, D), device=DEV)
        edge = torch.cat([u0, p, g, logp[:, None]], dim=1)
        inv_mass = torch.ones((C, D), device=DEV)
        H0 = -logp + tn._kinetic(p, inv_mass)
        eps = torch.full((C,), 1e-4, device=DEV)  # steps too short for a U-turn or a divergence
        active = torch.ones((C,), dtype=torch.bool, device=DEV)
        gen = make_generator(0, DEV)
        out, names = profiled(lambda: tn._build_subtree(gen, edge, depth, torch.ones((C,), device=DEV), eps,
                                                        inv_mass, H0, 10, vg_fn, active))
        assert int(out["n_leaves"].min()) == 1 << depth
        return names

    one, many = device_ops(0), device_ops(5)
    extra = {k: many.get(k, 0) - one.get(k, 0) for k in set(one) | set(many)}
    extra = {k: v for k, v in extra.items() if v}

    def launched(name):
        return sum(v for k, v in extra.items() if name in k)

    for name in ("nuts_leaf_kernel", "density_pre_kernel", "density_post_kernel", "mnle_logprob_bwd_kernel"):
        assert launched(name) == 31, (name, extra)
    assert sum(extra.values()) == 31 * (2 + 2 + pot_ops), (pot_ops, potential, extra)
