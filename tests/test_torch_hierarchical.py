"""PyTorch port: the hierarchical multi-subject model against the JAX package.

The packing, the hyperprior and its moment matching, and the joint
potential the sampler runs on: the port's closed-form value and gradient
(one K3 launch over every (chain row, subject, trial) row, the gradient
carried through the bijector and u = mu + tau * eps by hand) against
``jax.value_and_grad`` of the JAX package's ``base_fn + beta * ll_rep`` on
the committed ``mnle_1m_censor.npz`` loaded in both packages, untempered,
on a PT ladder, with two datasets and with an ensemble of two models. Then
a tiny ``run_hierarchical_inference`` on the CPU: shapes, keys, the cold
rung and the leading dataset axis.

Tolerances: values within 1e-3 x max(1, |ref|); each gradient entry within
1e-3 x max(1, the largest |ref| entry of its row) (the rows sum 3 x 10
trial rows, a quarter of them censored, whose float32 terms differ in their
last bits between XLA and PyTorch).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_for_diffusion_models_tpu import distributions as jd
from sbi_for_diffusion_models_tpu import mnle as jmnle
from sbi_for_diffusion_models_tpu.models import hierarchical as jh
from sbi_for_diffusion_models_tpu.pipeline import build_prior_theta as j_prior
from sbi_for_diffusion_models_tpu_torch import distributions as td
from sbi_for_diffusion_models_tpu_torch import mnle as tmnle
from sbi_for_diffusion_models_tpu_torch.models import hierarchical as th
from sbi_for_diffusion_models_tpu_torch.nets.mnle_net import MNLEConfig, build_mnle
from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta as t_prior

MODEL = "mnle_1m_censor.npz"
ENSEMBLE = ("mnle_10m.npz", "mnle_calibration.npz")
S, T, P = 3, 10, 80


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model_dir():
    mp = pytest.MonkeyPatch()
    mp.setenv("MODEL_DIR", str(Path(__file__).resolve().parents[1] / "artifacts" / "models"))
    try:
        yield
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def jmodel():
    return jh.HierarchicalModel.from_prior(j_prior())


@pytest.fixture(scope="module")
def committed(model_dir, jmodel):
    """``MODEL`` loaded in both packages, and JAX's target on it (one jit
    for every case of one data shape)."""
    jest = jmnle.load_model(MODEL)
    return jest, tmnle.load_model(MODEL, device="cpu"), _jax_target(jest, jmodel)


def _port_model(jm) -> th.HierarchicalModel:
    return th.HierarchicalModel(
        theta_dim=jm.theta_dim, **{k: torch.from_numpy(np.array(getattr(jm, k))) for k in
                                   ("mu_loc", "mu_scale", "log_tau_loc", "log_tau_scale")})


def _q(jm, n, seed, spread=0.5):
    """n joint vectors near the hyperprior's center, made with numpy."""
    rng = np.random.default_rng(seed)
    center = np.concatenate([np.asarray(jm.mu_loc), np.asarray(jm.log_tau_loc), np.zeros(S * 5)])
    scale = np.concatenate([np.asarray(jm.mu_scale), np.asarray(jm.log_tau_scale), np.ones(S * 5)])
    return (center + spread * scale * rng.standard_normal((n, center.size))).astype(np.float32)


def _sessions(B, seed=7):
    """B datasets of S subjects x T trials, (rt, choice) as the simulator
    gives them (RTs after a 0.15 s onset, about a quarter censored at the
    8 s window end), and +-1 stimuli; made with numpy."""
    rng = np.random.default_rng(seed)
    choice = rng.choice([0.0, 1.0, 2.0], (B, S, T), p=[0.4, 0.35, 0.25])
    rt = np.where(choice == 2.0, 8.0, 0.15 + rng.gamma(2.0, 0.4, (B, S, T)))
    pulses = np.where(rng.random((B, S, T, P)) < 0.5, 1.0, -1.0)
    return np.stack([rt, choice], -1).astype(np.float32), pulses.astype(np.float32)


def test_torch_pack_unpack_and_log_prior_match_jax(jmodel):
    """``unpack``, ``subject_u`` and ``log_prior`` on the same q (one, and a
    batch) equal JAX's to 1e-6 relative; ``log_prior_and_grad``'s gradient
    equals autograd's."""
    tm = _port_model(jmodel)
    assert tm.dim(S) == jmodel.dim(S) == 25
    qs = _q(jmodel, 4, 0, spread=2.0)
    for q in qs:
        for got, want in zip(tm.unpack(torch.from_numpy(q), S), jmodel.unpack(jnp.asarray(q), S)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_allclose(tm.subject_u(torch.from_numpy(q), S).numpy(),
                                   np.asarray(jmodel.subject_u(jnp.asarray(q), S)), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(tm.log_prior(torch.from_numpy(q), S)),
                                   float(jmodel.log_prior(jnp.asarray(q), S)), rtol=1e-6)
    batch = torch.from_numpy(qs)
    assert tm.subject_u(batch, S).shape == (4, S, 5) and tm.log_prior(batch, S).shape == (4,)
    want = np.asarray(jax.vmap(lambda q: jmodel.log_prior(q, S))(jnp.asarray(qs)))
    np.testing.assert_allclose(tm.log_prior(batch, S).numpy(), want, rtol=1e-6)
    lp, grad = tm.log_prior_and_grad(batch, S)
    q_ = batch.clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(tm.log_prior(q_, S).sum(), q_)
    assert torch.equal(lp, tm.log_prior(batch, S))
    np.testing.assert_allclose(grad.numpy(), auto.numpy(), rtol=1e-6, atol=1e-6)


def test_torch_from_prior_moments_match_jax(jmodel):
    """The moment-matched hyperprior from the port's own prior draws: each
    location within five Monte Carlo standard errors (8,192 draws a side)
    of JAX's, each scale's log within 0.1, log_tau_scale 0.4 exactly."""
    tm = th.HierarchicalModel.from_prior(t_prior(), device="cpu")
    std_u = np.asarray(jmodel.mu_scale) / 0.75
    se = std_u * np.sqrt(2.0 / 8192)
    assert tm.theta_dim == jmodel.theta_dim == 5
    assert np.all(np.abs(tm.mu_loc.numpy() - np.asarray(jmodel.mu_loc)) < 5 * se)
    np.testing.assert_allclose(np.log(tm.mu_scale.numpy()), np.log(np.asarray(jmodel.mu_scale)), atol=0.1)
    np.testing.assert_allclose(tm.log_tau_loc.numpy(), np.asarray(jmodel.log_tau_loc), atol=0.1)
    np.testing.assert_array_equal(tm.log_tau_scale.numpy(), np.asarray(jmodel.log_tau_scale))
    assert all(getattr(tm, k).dtype == torch.float32 for k in ("mu_loc", "mu_scale", "log_tau_loc"))


def _jax_target(jest, jm):
    """JAX's hierarchical target (models/hierarchical.py's base_fn + beta *
    ll_rep) with its gradient in q, vmapped over rows (q, rep, beta):
    ``fn(q, rep, beta, xs, ps)``."""
    bij = jd.mcmc_transform(j_prior())
    lp_fn = jest.dispatch_log_prob("xla")

    def ll_rep(q, rep, xs, ps):
        x_r = jnp.take(xs, rep, axis=0).reshape(S * T, 2)
        s_r = jnp.take(ps, rep, axis=0).reshape(S * T, P)
        theta_rows = jnp.repeat(bij.forward(jm.subject_u(q, S)), T, axis=0)
        return jnp.sum(lp_fn(x_r, jnp.concatenate([theta_rows, s_r], axis=-1)))

    def base_fn(q):
        return jm.log_prior(q, S) + jax.vmap(bij.forward_log_det)(jm.subject_u(q, S)).sum()

    def target(q, rep, beta, xs, ps):
        return base_fn(q) + beta * ll_rep(q, rep, xs, ps)

    return jax.jit(jax.vmap(jax.value_and_grad(target), in_axes=(0, 0, 0, None, None)))


def _assert_matches(value, grad, ref_value, ref_grad, share: float = 1.0):
    """Values within 1e-3 x max(1, |ref|); gradient entries within 1e-3 x
    the row's scale, all of them (``share`` 1) or at least ``share`` of
    them with every entry within 5e-3 x the row's scale."""
    value, grad = value.numpy(), grad.numpy()
    ref_value, ref_grad = np.asarray(ref_value), np.asarray(ref_grad)
    assert np.all(np.isfinite(ref_value)) and np.all(np.abs(ref_value) > 10)
    np.testing.assert_array_less(np.abs(value - ref_value), 1e-3 * np.maximum(1.0, np.abs(ref_value)))
    row_scale = np.broadcast_to(np.maximum(1.0, np.abs(ref_grad).max(1, keepdims=True)), ref_grad.shape)
    err = np.abs(grad - ref_grad)
    if share == 1.0:
        np.testing.assert_array_less(err, 1e-3 * row_scale)
    else:
        np.testing.assert_array_less(err, 5e-3 * row_scale)
        assert np.mean(err < 1e-3 * row_scale) >= share, np.mean(err < 1e-3 * row_scale)


@pytest.mark.parametrize("case", ["plain", "tempered", "batched"])
def test_torch_potential_value_and_gradient_match_jax(committed, jmodel, case):
    """The fold's closed-form value and gradient (the sampler's
    ``value_and_grad_fn``) against JAX's target: untempered on one dataset,
    on the PT ladder of four rungs, and with B = 2 datasets whose rows
    interleave; the value-only call gives the same value, and the autograd
    density ``logp`` the same value too."""
    B = 2 if case == "batched" else 1
    xs, ps = _sessions(B)
    n = 8
    q = _q(jmodel, n, 1)
    rep = np.arange(n) % B if case == "batched" else np.zeros(n, np.int64)
    beta = np.tile([1.0, 0.5, 0.2, 0.04], 2).astype(np.float32) if case == "tempered" else np.ones(n, np.float32)
    _, est, target = committed
    ref_v, ref_g = target(jnp.asarray(q), jnp.asarray(rep), jnp.asarray(beta), jnp.asarray(xs), jnp.asarray(ps))
    bij = td.mcmc_transform(t_prior())
    logp, ll, vg = th._hierarchical_density(_port_model(jmodel), bij, est, torch.from_numpy(xs), torch.from_numpy(ps))
    assert vg is not None
    data = (torch.from_numpy(rep), torch.from_numpy(beta))
    value, grad = vg(torch.from_numpy(q), data)
    _assert_matches(value, grad, ref_v, ref_g)
    value_only, none = vg(torch.from_numpy(q), data, need_grad=False)
    assert none is None
    np.testing.assert_allclose(value_only.numpy(), value.numpy(), rtol=1e-6)
    with torch.no_grad():
        np.testing.assert_allclose(logp(torch.from_numpy(q), data).numpy(), value.numpy(), rtol=1e-5)
        assert ll(torch.from_numpy(q), data).shape == (n,)


def test_torch_potential_with_an_ensemble_matches_jax(model_dir, jmodel):
    """An ensemble of two models goes through the same fold (one K3 a
    member); its value and gradient against JAX's ensemble target. These
    two models have no censored category, so the censored trials at 8 s
    fall in their RT flow's far tail, where XLA's and PyTorch's float32
    terms differ most: the closed-form gradient equals autograd's through
    the same rows to 1e-5, and against JAX 95 % of the entries are held to
    1e-3 x the row's scale and every entry to 5e-3."""
    xs, ps = _sessions(1, seed=9)
    q = _q(jmodel, 4, 2)
    rep, beta = np.zeros(4, np.int64), np.ones(4, np.float32)
    jens = jmnle.MNLEEnsemble([jmnle.load_model(f) for f in ENSEMBLE])
    ref_v, ref_g = _jax_target(jens, jmodel)(jnp.asarray(q), jnp.asarray(rep), jnp.asarray(beta), jnp.asarray(xs),
                                             jnp.asarray(ps))
    ens = tmnle.load_ensemble(",".join(ENSEMBLE), device="cpu")
    bij = td.mcmc_transform(t_prior())
    _, _, vg = th._hierarchical_density(_port_model(jmodel), bij, ens, torch.from_numpy(xs), torch.from_numpy(ps))
    value, grad = vg(torch.from_numpy(q), (torch.from_numpy(rep), torch.from_numpy(beta)))
    _assert_matches(value, grad, ref_v, ref_g, share=0.95)


def test_torch_simulate_hierarchical_sessions_shapes():
    prior = t_prior()
    theta, x, pulses, (mu, log_tau) = th.simulate_hierarchical_sessions(
        prior, 2, 4, seed=1, return_hyperparams=True, device="cpu")
    assert theta.shape == (2, 5) and x.shape == (2, 4, 2) and pulses.shape == (2, 4, P)
    assert mu.shape == (5,) and log_tau.shape == (5,)
    assert bool(torch.isfinite(prior.log_prob(theta)).all())
    assert set(np.unique(x[..., 1].numpy())) <= {0.0, 1.0, 2.0}
    again = th.simulate_hierarchical_sessions(prior, 2, 4, seed=1, device="cpu")
    assert torch.equal(again[1], x) and torch.equal(again[0], theta)


@pytest.mark.parametrize("batched", [False, True])
def test_torch_tiny_run_hierarchical_inference(batched):
    """A tiny joint run on the CPU (warmup 5, 5 draws, depth 3, two rungs
    of parallel tempering): the JAX package's keys and shapes, with the
    leading dataset axis exactly when the input has one; the cold rung's
    draws; every subject inside the prior's support."""
    prior = t_prior()
    est = build_mnle(0, MNLEConfig(condition_dim=85, hidden_features=16, num_transforms=2, num_bins=5),
                     device="cpu")
    sims = [th.simulate_hierarchical_sessions(prior, 2, 4, seed=s, device="cpu") for s in (1, 2)]
    x = torch.stack([s[1] for s in sims]) if batched else sims[0][1]
    pulses = torch.stack([s[2] for s in sims]) if batched else sims[0][2]
    out = th.run_hierarchical_inference(est, prior, x, pulses, num_chains=2, num_warmup=5, num_samples=5,
                                        max_tree_depth=3, pt_replicas=2, seed=3, verbose=False)
    assert set(out) == {"raw", "theta_subjects", "population_theta", "swap_accept", "info"}
    lead = (2,) if batched else ()
    assert out["raw"].shape == lead + (2, 5, 20)
    assert out["theta_subjects"].shape == lead + (10, 2, 5)
    assert out["population_theta"].shape == lead + (10, 5)
    assert np.isfinite(out["raw"]).all() and 0.0 <= out["swap_accept"] <= 1.0
    # Four (or eight) rows of the sampler: two chains of two rungs per dataset; the cold rung is kept.
    assert out["info"]["accept_prob"].shape == ((8 if batched else 4), 5)
    s = out["theta_subjects"].reshape(-1, 5)
    assert bool(torch.isfinite(prior.log_prob(torch.from_numpy(s))).all())
